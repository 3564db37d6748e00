"""Serving bundles: the port's export, and loading bundles of either
package.

A bundle is a directory holding ``metadata.json`` (written last, so its
presence marks a complete bundle) with the JAX package's keys, and the
weights: ``params.pt`` (a ``torch.save`` of the state_dict) from this
port, or ``params.msgpack`` (flax's msgpack) from
elasticdl_tpu/serving/export.py. A JAX bundle's ``predict.stablehlo``
is ignored: the port rebuilds the module and carries the weights
across with ``bridge.state_dict_for``, by the map of the twin it built.

Host-tier models (``HostEmbedding`` tables) export in one of the JAX
package's two modes:

- ``host_tables`` + ``host_vocab``: each table materialised dense up to
  its vocab (``materialize_host_rows``: trained rows over the live
  table's lazy initial rows, the live store untouched) into
  ``host_rows.pt`` ({table: (vocab, D) f32}); a JAX bundle carries them
  as its ``host_rows`` collection. The served batch's raw ids index
  these dense tables.
- ``host_id_keys`` ({table: feature key}), the row-service mode: no rows
  in the bundle; ``metadata.host_serving`` names the id keys, the
  tables' widths and ``HOST_ROWS_FEATURE_PREFIX``. The server resolves
  each batch's ids against a live row service
  (``serving/model_store.HostRowResolver``) and hands the predictor the
  inverse maps plus one row block a table under
  ``HOST_ROWS_FEATURE_PREFIX + table``.

The model comes from, in order: the caller's ``model_fn``; the
``model_config`` that the port's export records beside the JAX keys;
the shapes of a JAX bundle's param tree (``bridge.config_from_params``,
transformer bundles only).
"""

import contextlib
import json
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.data.batcher import tree_map
from elasticdl_tpu_torch.embedding.device_sparse import _iter_leaves
from elasticdl_tpu_torch.embedding.host_engine import host_rows_template
from elasticdl_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    check_token_ids,
)

logger = get_logger("serving_export")

PARAMS_FILE = "params.pt"
FLAX_PARAMS_FILE = "params.msgpack"
HOST_ROWS_FILE = "host_rows.pt"
META_FILE = "metadata.json"
# The flax variable collection of a JAX host bundle's dense tables.
HOST_ROWS_COLLECTION = "host_rows"
# Row-service mode: each table's row block rides the predict input as
# an extra feature under this key prefix (the JAX package's).
HOST_ROWS_FEATURE_PREFIX = "__host_rows__:"


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


def _example_features(batch_example):
    if isinstance(batch_example, dict) and "features" in batch_example:
        return batch_example["features"]
    return batch_example


def _batch_dim(features) -> int:
    leaves = _leaves(features)
    return int(np.shape(leaves[0])[0]) if leaves and np.ndim(leaves[0]) \
        else 0


# ---- host tables materialised dense ------------------------------------

def _clone_empty(table):
    """A fresh table of the same type and configuration (initializer,
    slot settings, dtype): the lazy rows of untouched ids must match the
    live table's exactly."""
    table = getattr(table, "hot_inner", table)
    return type(table)(
        table.name,
        table.dim,
        initializer=getattr(table, "initializer", "uniform"),
        is_slot=getattr(table, "is_slot", False),
        slot_init_value=getattr(table, "slot_init_value", 0.0),
        dtype=getattr(table, "dtype", np.float32),
    )


def _dense_overlay(table, vocab: int, chunk: int) -> np.ndarray:
    """Dense (vocab, dim) without touching the live table: trained rows
    from a ``to_arrays`` snapshot over the lazy rows of a throwaway
    table per chunk (a reused one would grow to the whole vocab)."""
    ids, rows = table.to_arrays()
    parts = []
    for lo in range(0, int(vocab), chunk):
        hi = min(lo + chunk, vocab)
        parts.append(
            np.asarray(_clone_empty(table).get(np.arange(lo, hi)))
        )
    dense = np.concatenate(parts, axis=0)
    ids = np.asarray(ids)
    keep = (ids >= 0) & (ids < vocab)
    dense[ids[keep]] = np.asarray(rows)[keep]
    return dense


def materialize_host_rows(tables, vocab_sizes, chunk: int = 65536,
                          lock=None) -> Dict[str, np.ndarray]:
    """{table: dense (vocab, dim)} from host or remote tables. Untouched
    ids take the lazy initializer's rows without being inserted into the
    live store; pass the engine's ``lock`` so training threads do not
    race the snapshot. A remote table exports on the service
    (``export_dense``)."""
    missing = set(vocab_sizes) - set(tables)
    if missing:
        raise ValueError(
            f"host_serving_vocab names unknown tables {sorted(missing)}; "
            f"model tables: {sorted(tables)}"
        )
    out = {}
    for name, vocab in vocab_sizes.items():
        table = tables[name]
        if hasattr(table, "export_dense"):
            out[name] = table.export_dense(int(vocab), chunk)
            continue
        with (lock if lock is not None else contextlib.nullcontext()):
            out[name] = _dense_overlay(table, int(vocab), chunk)
    return out


# ---- export -------------------------------------------------------------

def _write_params(output_dir: str, model: torch.nn.Module):
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(output_dir, PARAMS_FILE))


def _write_meta(output_dir: str, meta: dict):
    with open(os.path.join(output_dir, META_FILE), "w") as f:
        json.dump(meta, f, indent=1)


def export_serving_bundle(output_dir: str, model: torch.nn.Module,
                          batch_example: Optional[Any] = None,
                          model_def: str = "", version: int = 0,
                          host_tables: Optional[dict] = None,
                          host_vocab: Optional[dict] = None,
                          host_lock=None,
                          host_id_keys: Optional[dict] = None) -> str:
    """Write the bundle; returns ``output_dir``.

    ``host_tables`` + ``host_vocab`` (host-tier models, with a
    ``batch_example`` as the JAX export needs): each table materialised
    dense into ``host_rows.pt``. ``host_id_keys`` exports the
    row-service mode instead; the two are mutually exclusive."""
    os.makedirs(output_dir, exist_ok=True)
    if host_id_keys and host_tables:
        raise ValueError(
            "host_id_keys (row-service serving) and host_tables "
            "(materialized dense rows) are mutually exclusive"
        )
    if host_id_keys:
        if batch_example is None:
            raise ValueError("host_id_keys export requires batch_example")
        return _export_row_service_bundle(
            output_dir, model, batch_example, model_def, version,
            host_id_keys,
        )
    dense_rows = None
    if host_tables and host_vocab and batch_example is not None:
        model_tables = set(host_rows_template(model))
        if model_tables - set(host_vocab):
            raise ValueError(
                "host_serving_vocab is missing entries for model "
                f"tables {sorted(model_tables - set(host_vocab))}"
            )
        dense_rows = materialize_host_rows(host_tables, host_vocab,
                                           lock=host_lock)
    _write_params(output_dir, model)
    if dense_rows is not None:
        torch.save({name: torch.from_numpy(np.ascontiguousarray(rows))
                    for name, rows in dense_rows.items()},
                   os.path.join(output_dir, HOST_ROWS_FILE))
    meta = {
        "model_version": int(version),
        "model_def": model_def,
        "format": 1,
    }
    if batch_example is not None:
        features = _example_features(batch_example)
        batch_dim = _batch_dim(features)
        meta["feature_signature"] = _feature_signature(features, batch_dim)
        # The module serves any batch size.
        meta["batch_polymorphic"] = True
        meta["batch_size"] = int(batch_dim)
    meta["self_contained"] = False
    cfg = getattr(model, "cfg", None)
    if isinstance(cfg, TransformerConfig):
        meta["model_config"] = cfg.to_dict()
    _write_meta(output_dir, meta)
    return output_dir


def _export_row_service_bundle(output_dir: str, model: torch.nn.Module,
                               batch_example: Any, model_def: str,
                               version: int, host_id_keys: dict) -> str:
    """The ``host_id_keys`` arm of ``export_serving_bundle``: the
    module's weights and ``metadata.host_serving``, no rows. The port
    has no StableHLO, so the model comes back from ``--model_zoo`` and
    the recorded ``model_def``."""
    table_dims = {name: int(dim)
                  for name, dim in host_rows_template(model).items()}
    mismatch = set(table_dims) ^ set(host_id_keys)
    if mismatch:
        raise ValueError(
            f"host_id_keys must name exactly the model's host tables "
            f"{sorted(table_dims)}; mismatched: {sorted(mismatch)}"
        )
    _write_params(output_dir, model)
    features = dict(_example_features(batch_example))
    batch_dim = _batch_dim(features)
    _write_meta(output_dir, {
        "model_version": int(version),
        "model_def": model_def,
        "format": 1,
        "self_contained": False,
        "batch_polymorphic": True,
        "batch_size": int(batch_dim),
        "feature_signature": _feature_signature(features, batch_dim),
        "host_serving": {
            "id_keys": dict(host_id_keys),
            "tables": table_dims,
            "rows_feature_prefix": HOST_ROWS_FEATURE_PREFIX,
        },
    })
    return output_dir


# ---- flax msgpack -------------------------------------------------------

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


# ---- load ---------------------------------------------------------------

def _load(bundle_dir: str, device, model_fn
          ) -> Tuple[torch.nn.Module, Optional[Dict[str, np.ndarray]], dict]:
    """(module on ``device`` in eval mode, the dense host tables or
    None, metadata)."""
    dev = resolve_device(device)
    with open(os.path.join(bundle_dir, META_FILE)) as f:
        meta = json.load(f)
    variables = None
    host_rows = None
    pt_path = os.path.join(bundle_dir, PARAMS_FILE)
    if os.path.exists(pt_path):
        state = torch.load(pt_path, map_location="cpu", weights_only=True)
        rows_path = os.path.join(bundle_dir, HOST_ROWS_FILE)
        if os.path.exists(rows_path):
            host_rows = {
                name: t.numpy() for name, t in torch.load(
                    rows_path, map_location="cpu", weights_only=True
                ).items()
            }
    else:
        variables = load_flax_params(
            os.path.join(bundle_dir, FLAX_PARAMS_FILE)
        )
        if variables.get(HOST_ROWS_COLLECTION):
            host_rows = dict(_iter_leaves(variables[HOST_ROWS_COLLECTION]))
    if model_fn is not None:
        model = model_fn()
    elif "model_config" in meta:
        model = TransformerLM(TransformerConfig.from_dict(
            meta["model_config"]
        ))
    elif variables is not None:
        model = TransformerLM(bridge.config_from_params(variables))
    else:
        raise ValueError(
            f"bundle {bundle_dir} records no model_config; pass model_fn"
        )
    if variables is not None:
        state = bridge.state_dict_for(model, variables)
    model.load_state_dict(state)
    return model.to(dev).eval(), host_rows, meta


def load_model(bundle_dir: str, device=None,
               model_fn: Optional[Callable[[], torch.nn.Module]] = None
               ) -> torch.nn.Module:
    """The bundle's module with its weights, on ``device``, in eval
    mode."""
    return _load(bundle_dir, device, model_fn)[0]


def _check_host_ids(features, vocab: int):
    """A dense host bundle's raw ids index its tables: every integer
    leaf of the features must lie in [0, vocab) (checked on the host, so
    an id outside a table answers 400 instead of faulting the card)."""
    for leaf in _leaves(features):
        arr = np.asarray(leaf)
        if arr.dtype.kind in "iu" and arr.size and (
                arr.min() < 0 or arr.max() >= vocab):
            raise ValueError(f"host-table ids must lie in [0, {vocab})")


def load_predictor(bundle_dir: str, device=None,
                   model_fn: Optional[Callable[[], torch.nn.Module]] = None
                   ) -> Callable[[Any], np.ndarray]:
    """Load a bundle as ``predict(features) -> numpy predictions``.

    A dense host bundle's tables go to the model's device once, here; a
    row-service bundle's predictor takes the row blocks from the
    features (``HOST_ROWS_FEATURE_PREFIX``) and places them once a
    batch."""
    model, dense_rows, meta = _load(bundle_dir, device, model_fn)
    dev = next(model.parameters()).device
    cfg = getattr(model, "cfg", None)
    host_serving = meta.get("host_serving")

    def place(x):
        return torch.as_tensor(np.asarray(x), device=dev)

    dense = None
    if dense_rows is not None:
        dense = {name: place(rows) for name, rows in dense_rows.items()}
        vocab = min(int(rows.shape[0]) for rows in dense_rows.values())

    def predict(features):
        kwargs = {}
        if isinstance(cfg, TransformerConfig):
            # Checked here, on the host array: on the card the model
            # does not read its ids back.
            check_token_ids(np.asarray(features), cfg.vocab_size)
        if host_serving:
            prefix = host_serving.get("rows_feature_prefix",
                                      HOST_ROWS_FEATURE_PREFIX)
            features = dict(features)
            kwargs["host_rows"] = {
                name: place(features.pop(prefix + name))
                for name in host_serving["tables"]
            }
        elif dense is not None:
            _check_host_ids(features, vocab)
            kwargs["host_rows"] = dense
        # A dict of features (the tabular twins' {"ids", "dense"})
        # moves leaf by leaf.
        inputs = (tree_map(place, features) if isinstance(features, dict)
                  else place(features))
        with torch.inference_mode():
            return model(inputs, **kwargs).cpu().numpy()

    return predict
