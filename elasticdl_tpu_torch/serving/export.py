"""Serving bundles: the port's export, and loading bundles of either
package.

A bundle is a directory holding ``metadata.json`` (written last, so its
presence marks a complete bundle) with the JAX package's keys, and the
weights: ``params.pt`` (a ``torch.save`` of the state_dict) from this
port, or ``params.msgpack`` (flax's msgpack) from
elasticdl_tpu/serving/export.py. A JAX bundle's ``predict.stablehlo``
is ignored: the port rebuilds the module and carries the weights
across with ``bridge``.

The model comes from, in order: the caller's ``model_fn``; the
``model_config`` that the port's export records beside the JAX keys;
the shapes of a JAX bundle's param tree (``bridge.config_from_params``).
"""

import json
import os
from typing import Any, Callable, Optional

import numpy as np
import torch

from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.data.batcher import tree_map
from elasticdl_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    check_token_ids,
)

PARAMS_FILE = "params.pt"
FLAX_PARAMS_FILE = "params.msgpack"
META_FILE = "metadata.json"


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for key in tree for x in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _feature_signature(features, batch_dim: int):
    """JSON-able {shape, dtype} tree of the predict input, with ``None``
    for the leading dim where it carries the batch."""
    if isinstance(features, dict):
        return {k: _feature_signature(v, batch_dim)
                for k, v in features.items()}
    arr = np.asarray(features)
    shape = list(arr.shape)
    if shape and shape[0] == batch_dim:
        shape[0] = None
    return {"shape": shape, "dtype": arr.dtype.name}


def export_serving_bundle(output_dir: str, model: torch.nn.Module,
                          batch_example: Optional[Any] = None,
                          model_def: str = "", version: int = 0) -> str:
    """Write the bundle; returns ``output_dir``."""
    os.makedirs(output_dir, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(output_dir, PARAMS_FILE))
    meta = {
        "model_version": int(version),
        "model_def": model_def,
        "format": 1,
    }
    if batch_example is not None:
        if isinstance(batch_example, dict) and "features" in batch_example:
            batch_example = batch_example["features"]
        leaves = _leaves(batch_example)
        batch_dim = (np.shape(leaves[0])[0]
                     if leaves and np.ndim(leaves[0]) else 0)
        meta["feature_signature"] = _feature_signature(
            batch_example, batch_dim
        )
        # The module serves any batch size.
        meta["batch_polymorphic"] = True
        meta["batch_size"] = int(batch_dim)
    meta["self_contained"] = False
    cfg = getattr(model, "cfg", None)
    if isinstance(cfg, TransformerConfig):
        meta["model_config"] = cfg.to_dict()
    with open(os.path.join(output_dir, META_FILE), "w") as f:
        json.dump(meta, f, indent=1)
    return output_dir


def _flax_ndarray(data: bytes) -> np.ndarray:
    """flax's ndarray ext payload: msgpack (shape, dtype name, bytes).
    bfloat16 widens to f32 (numpy has no bfloat16)."""
    shape, name, buffer = tensor_utils.unpackb(data)
    if name == "bfloat16":
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        arr = np.frombuffer(buffer, dtype=np.dtype(name))
    return arr.reshape(shape).copy()


def _flax_ext_hook(code: int, data: bytes):
    if code == 1:      # ndarray
        return _flax_ndarray(data)
    if code == 3:      # numpy scalar
        return _flax_ndarray(data)[()]
    raise ValueError(f"unsupported flax msgpack ext type {code}")


def _unchunk(tree):
    """flax splits arrays over 1 GiB into '__msgpack_chunked_array__'
    dicts of flat chunks."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)]
                      for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)]
                  for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_flax_params(path: str) -> dict:
    """Decode a flax ``serialization.to_bytes`` file into nested dicts of
    numpy arrays, with the port's own msgpack codec and numpy."""
    with open(path, "rb") as f:
        raw = f.read()
    return _unchunk(tensor_utils.unpackb(raw, ext_hook=_flax_ext_hook))


def load_model(bundle_dir: str, device=None,
               model_fn: Optional[Callable[[], torch.nn.Module]] = None
               ) -> torch.nn.Module:
    """The bundle's module with its weights, on ``device``, in eval
    mode."""
    dev = resolve_device(device)
    with open(os.path.join(bundle_dir, META_FILE)) as f:
        meta = json.load(f)
    flax_params = None
    pt_path = os.path.join(bundle_dir, PARAMS_FILE)
    if os.path.exists(pt_path):
        state = torch.load(pt_path, map_location="cpu", weights_only=True)
    else:
        flax_params = load_flax_params(
            os.path.join(bundle_dir, FLAX_PARAMS_FILE)
        )
        state = bridge.state_dict_from_flax(flax_params)
    if model_fn is not None:
        model = model_fn()
    elif "model_config" in meta:
        model = TransformerLM(TransformerConfig.from_dict(
            meta["model_config"]
        ))
    elif flax_params is not None:
        model = TransformerLM(bridge.config_from_params(flax_params))
    else:
        raise ValueError(
            f"bundle {bundle_dir} records no model_config; pass model_fn"
        )
    model.load_state_dict(state)
    return model.to(dev).eval()


def load_predictor(bundle_dir: str, device=None,
                   model_fn: Optional[Callable[[], torch.nn.Module]] = None
                   ) -> Callable[[Any], np.ndarray]:
    """Load a bundle as ``predict(features) -> numpy predictions``."""
    model = load_model(bundle_dir, device, model_fn)
    dev = next(model.parameters()).device
    cfg = getattr(model, "cfg", None)

    def place(x):
        return torch.as_tensor(np.asarray(x), device=dev)

    def predict(features):
        if isinstance(cfg, TransformerConfig):
            # Checked here, on the host array: on the card the model
            # does not read its ids back.
            check_token_ids(np.asarray(features), cfg.vocab_size)
        # A dict of features (the tabular twins' {"ids", "dense"})
        # moves leaf by leaf.
        inputs = (tree_map(place, features) if isinstance(features, dict)
                  else place(features))
        with torch.inference_mode():
            return model(inputs).cpu().numpy()

    return predict
