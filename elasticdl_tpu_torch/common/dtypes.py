"""Dtype tables: canonical names ↔ numpy and torch dtypes.

Torch edition of elasticdl_tpu/common/dtypes.py, keyed on the same
canonical names. numpy has no bfloat16, so ``np_dtype("bfloat16")``
raises; bfloat16 lives on the torch side (``torch_dtype``). A bf16
tensor crosses to numpy as its 16 bits in ``BFLOAT16_BITS``, a
structured dtype whose canonical name is "bfloat16": the codec writes
such an array under that name with the tensor's raw bytes, as the JAX
package writes a bfloat16 array (``bf16_to_numpy``/``bf16_from_numpy``).
"""

import numpy as np
import torch

# Canonical name -> (numpy dtype or None, torch dtype)
_DTYPES = {
    "bool": (np.dtype(np.bool_), torch.bool),
    "int8": (np.dtype(np.int8), torch.int8),
    "uint8": (np.dtype(np.uint8), torch.uint8),
    "int16": (np.dtype(np.int16), torch.int16),
    "uint16": (np.dtype(np.uint16), torch.uint16),
    "int32": (np.dtype(np.int32), torch.int32),
    "uint32": (np.dtype(np.uint32), torch.uint32),
    "int64": (np.dtype(np.int64), torch.int64),
    "uint64": (np.dtype(np.uint64), torch.uint64),
    "float16": (np.dtype(np.float16), torch.float16),
    "bfloat16": (None, torch.bfloat16),
    "float32": (np.dtype(np.float32), torch.float32),
    "float64": (np.dtype(np.float64), torch.float64),
}

BFLOAT16_BITS = np.dtype([("bfloat16", "<u2")])

_NP_TO_NAME = {v[0]: k for k, v in _DTYPES.items() if v[0] is not None}
_NP_TO_NAME[BFLOAT16_BITS] = "bfloat16"
_TORCH_TO_NAME = {v[1]: k for k, v in _DTYPES.items()}


def np_dtype(name: str) -> np.dtype:
    """Numpy dtype for a canonical name."""
    dtype = _DTYPES[name][0]
    if dtype is None:
        raise ValueError(f"numpy has no {name}; use torch_dtype({name!r})")
    return dtype


def torch_dtype(name: str) -> torch.dtype:
    """Torch dtype for a canonical name."""
    return _DTYPES[name][1]


def dtype_name(dtype) -> str:
    """Canonical name for a numpy or torch dtype (KeyError if unsupported)."""
    if isinstance(dtype, torch.dtype):
        return _TORCH_TO_NAME[dtype]
    return _NP_TO_NAME[np.dtype(dtype)]


def bf16_to_numpy(tensor: torch.Tensor) -> np.ndarray:
    """The bits of a CPU bfloat16 tensor as a ``BFLOAT16_BITS`` array
    (shares the tensor's memory)."""
    return tensor.view(torch.int16).numpy().view(BFLOAT16_BITS)


def bf16_from_numpy(bits: np.ndarray) -> torch.Tensor:
    """The bfloat16 tensor of a ``BFLOAT16_BITS`` array, bit for bit
    (shares the array's memory)."""
    return torch.from_numpy(np.asarray(bits, order="C").view(np.int16)).view(
        torch.bfloat16)
