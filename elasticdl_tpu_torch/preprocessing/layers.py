"""Device-plane preprocessing: tensor ops on the model's device (port of
elasticdl_tpu/preprocessing/layers.py).

Stateless callables that compose inside any module's ``forward``; all
outputs are int32 ids ready for the ``Embedding`` layer. They follow
XLA's arithmetic, so the card, the CPU and the JAX package give the
same ids:

- XLA's float-to-int conversions saturate (NaN to 0, out-of-range to
  the type's bounds) where PyTorch's do not (the CPU gives INT_MIN):
  ``to_int32`` and the float branch of ``Hashing`` write the saturation
  out before the cast.
- ``Hashing`` is a uint32 finalizer; PyTorch has no uint32 arithmetic,
  so it runs in int64 on the low 32 bits (``_mul32`` multiplies in
  16-bit halves, so no product leaves the int64 range).
- ``Discretization`` keeps one copy of its boundaries per device, made
  at the first call there (a module-level instance serves the CPU and
  the card); nothing is read back from the device.
"""

from typing import Dict

import numpy as np
import torch

_INT32_MIN, _INT32_MAX = -(2 ** 31), 2 ** 31 - 1
_UINT32_MASK = 0xFFFFFFFF


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as int32 with XLA's conversion: a float truncates toward
    zero, NaN gives 0, and values beyond the int32 range its bounds
    (±inf too); an integer keeps its low 32 bits."""
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        return x.to(torch.int32)
    big = x >= 2.0 ** 31
    small = x < -(2.0 ** 31)
    unsafe = big | small | torch.isnan(x)
    out = torch.where(unsafe, torch.zeros_like(x), x).to(torch.int32)
    out = torch.where(big, _INT32_MAX, out)
    return torch.where(small, _INT32_MIN, out)


def _to_uint32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as int64 holding XLA's ``astype(uint32)``: an integer keeps
    its low 32 bits (negative ids wrap), a float truncates and saturates
    to [0, 2^32 - 1] with NaN at 0."""
    if not x.is_floating_point():
        return x.to(torch.int64) & _UINT32_MASK
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x).clamp(min=0.0)
    big = x >= 2.0 ** 32
    out = torch.where(big, torch.zeros_like(x), x).to(torch.int64)
    return torch.where(big, _UINT32_MASK, out)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _UINT32_MASK


def one_hot(ids: torch.Tensor, num_classes: int,
            dtype=torch.float32) -> torch.Tensor:
    """``jax.nn.one_hot``: an id outside [0, num_classes) gives a row of
    zeros (``F.one_hot`` raises there, after reading the ids back)."""
    classes = torch.arange(num_classes, device=ids.device)
    return (ids[..., None] == classes).to(dtype)


class Discretization:
    """Bucket numeric data by bin boundaries: id = #boundaries <= x
    (reference ``Discretization.call``). NaN sorts above every boundary,
    as in ``jnp.searchsorted``."""

    def __init__(self, bin_boundaries):
        self._boundaries = np.sort(np.asarray(bin_boundaries, np.float32))
        self._on: Dict[torch.device, torch.Tensor] = {}

    @property
    def num_buckets(self) -> int:
        return int(self._boundaries.shape[0]) + 1

    def boundaries(self, device) -> torch.Tensor:
        """The f32 boundaries on ``device`` (copied there once)."""
        device = torch.device(device)
        out = self._on.get(device)
        if out is None:
            out = torch.from_numpy(self._boundaries).to(device)
            self._on[device] = out
        return out

    def __call__(self, inputs):
        x = torch.as_tensor(inputs).to(torch.float32)
        return torch.searchsorted(self.boundaries(x.device), x,
                                  right=True).to(torch.int32)


class RoundIdentity:
    """Round a numeric feature to an integer id clipped to
    [0, num_buckets) (reference ``RoundIdentity.call``); rounds half to
    even, NaN gives 0."""

    def __init__(self, num_buckets: int):
        if num_buckets <= 0:
            raise ValueError("num_buckets must be positive")
        self.num_buckets = int(num_buckets)

    def __call__(self, inputs):
        x = torch.round(torch.as_tensor(inputs).to(torch.float32))
        x = torch.clamp(x, 0.0, float(self.num_buckets - 1))
        return to_int32(x)


class Hashing:
    """Integer id -> bucket in [0, num_bins) by a 32-bit murmur3
    finalizer (the device twin of the host ``CategoryHash`` for
    features that are already integers)."""

    def __init__(self, num_bins: int):
        if num_bins <= 0:
            raise ValueError("num_bins must be positive")
        self.num_bins = int(num_bins)

    def __call__(self, inputs):
        x = _to_uint32(torch.as_tensor(inputs))
        x = x ^ (x >> 16)
        x = _mul32(x, 0x85EBCA6B)
        x = x ^ (x >> 13)
        x = _mul32(x, 0xC2B2AE35)
        x = x ^ (x >> 16)
        return (x % self.num_bins).to(torch.int32)


class AddIdOffset:
    """Concatenate categorical id columns into one id space by adding
    per-column offsets (census ``AddIdOffset``; the device half of
    ``concatenated_categorical_column``)."""

    def __init__(self, group_sizes):
        sizes = [int(s) for s in group_sizes]
        self.offsets = [int(o) for o in
                        np.concatenate([[0], np.cumsum(sizes)[:-1]])]
        self.total_size = int(sum(sizes))

    def __call__(self, id_columns):
        """id_columns: list of (B,) or (B, 1) int tensors, one per
        column. Returns (B, num_columns) offset ids."""
        cols = []
        for i, col in enumerate(id_columns):
            col = to_int32(col)
            cols.append(col.reshape(col.shape[0], -1) + self.offsets[i])
        return torch.cat(cols, dim=1)
