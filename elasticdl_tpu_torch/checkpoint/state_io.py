"""TrainState ⇄ named-leaf dict conversion for checkpointing (port of
elasticdl_tpu/checkpoint/state_io.py).

The reference checkpoints a Model protobuf keyed by variable name. The
port's state is a module, an optimizer and a few host values
(``core/train_state.TrainState``; ``embedding/device_sparse
.SparseTrainState`` adds the device-tier tables), so each leaf is named
by the JAX state's field, then the torch name:

- ``step``: the model version (0-d int64);
- ``params.<name>``: each tensor of ``model.named_parameters()``;
- ``batch_stats.<name>``: each statistic buffer (``state.batch_stats``);
- ``opt_state.<param name>.<slot>``: each entry of the optimizer's state
  for a parameter (``exp_avg``, ``exp_avg_sq``, ``step``,
  ``momentum_buffer``, ``sum``, ...), keyed by the parameter's NAME,
  never its index (slot names hold no dot, so the last dot splits);
- ``rng``: the CPU generator's ``get_state()`` (uint8), from which the
  step draws dropout seeds;
- ``tables.<t>``, ``slot_tables.<t>.<slot>``, ``table_steps.<t>``: the
  device-tier sparse plane (its tables, their row-optimizer slots and
  the per-table apply counts).

The fields are discovered from the state's dataclass, as in the JAX
module: a field this module has no rule for raises instead of being
silently left out of every checkpoint. bf16 tensors travel as their
bits (``dtypes.BFLOAT16_BITS``), written under the dtype name
"bfloat16": bit-exact both ways, never through ``np_dtype``.

Capture (``named_leaves_from_state``) copies every leaf to the host
synchronously: it returns after the last step's kernels and before the
next step's in-place updates, so the snapshot is consistent.

Restore fills the state IN PLACE: it ``copy_()``s into the existing
parameters, buffers, tables and slots and never rebinds one (torch
optimizers key their state by the Parameter object, and the sparse step
and the row kernels write the tables in place). A fresh torch optimizer
has no slots until its first step, where optax's ``opt_state`` exists
at init: a restore creates them from the checkpoint, each shape checked
against its parameter; a per-parameter ``step`` stays on the CPU unless
the optimizer is fused or capturable, where torch keeps it. The
learning-rate schedule (``callbacks.LearningRateScheduler``) is set to
the restored version, as the optax schedule's count comes back with the
JAX ``opt_state``.
"""

import dataclasses
import zlib
from typing import Dict

import numpy as np
import torch

from elasticdl_tpu_torch.common import dtypes


class CorruptCheckpointError(RuntimeError):
    """A checkpoint file exists but cannot be decoded into a valid
    shard payload (truncated write, bit rot, chaos injection). Restore
    treats the whole version as unusable and falls back to the
    previous retained version (saver.CheckpointSaver.restore)."""


# ---- shard-file framing --------------------------------------------------
#
# New shard files carry a magic + CRC32 header so torn writes and bit
# rot are caught by checksum before msgpack ever sees the bytes (the
# same discipline as the master journal's frames). Legacy files (raw
# msgpack, no magic) still load: msgpack map headers can never start
# with this magic, so sniffing is unambiguous.

SHARD_MAGIC = b"EDLC1"


def frame_shard_blob(blob: bytes) -> bytes:
    """``magic + u32le crc32(blob) + blob`` — the on-disk shard frame."""
    crc = zlib.crc32(blob) & 0xFFFFFFFF
    return SHARD_MAGIC + crc.to_bytes(4, "little") + blob


def unframe_shard_blob(data: bytes, path: str = "") -> bytes:
    """Strip and verify the frame; raw legacy blobs pass through.
    Raises CorruptCheckpointError on checksum mismatch or a frame too
    short to carry its header."""
    if not data.startswith(SHARD_MAGIC):
        return data  # legacy (pre-framing) shard file
    where = f" ({path})" if path else ""
    header = len(SHARD_MAGIC) + 4
    if len(data) < header:
        raise CorruptCheckpointError(
            f"framed shard shorter than its header{where}"
        )
    want = int.from_bytes(data[len(SHARD_MAGIC):header], "little")
    blob = data[header:]
    got = zlib.crc32(blob) & 0xFFFFFFFF
    if got != want:
        raise CorruptCheckpointError(
            f"shard crc32 mismatch (want {want:#010x}, got "
            f"{got:#010x}){where}"
        )
    return blob


def validate_shard_payload(payload, path: str = ""):
    """Structural check on one decoded shard file. msgpack happily
    decodes *some* corrupted byte streams into non-payload values
    (e.g. a leading ``\\x00`` becomes the int 0), so decode success
    alone is not integrity — the shape of the payload is."""
    where = f" ({path})" if path else ""
    if not isinstance(payload, dict):
        raise CorruptCheckpointError(
            f"shard payload is {type(payload).__name__}, not dict{where}"
        )
    meta = payload.get("meta")
    if not isinstance(meta, dict):
        raise CorruptCheckpointError(f"shard payload lacks meta{where}")
    for key in ("version", "shard", "num_shards"):
        if not isinstance(meta.get(key), int):
            raise CorruptCheckpointError(
                f"shard meta lacks int {key!r}{where}"
            )
    dense = payload.get("dense", {})
    if not isinstance(dense, dict):
        raise CorruptCheckpointError(f"shard dense is not a dict{where}")
    for name, arr in dense.items():
        if not isinstance(arr, np.ndarray):
            raise CorruptCheckpointError(
                f"dense leaf {name!r} decoded as "
                f"{type(arr).__name__}, not ndarray{where}"
            )
    if not isinstance(payload.get("embeddings", {}), dict):
        raise CorruptCheckpointError(
            f"shard embeddings is not a dict{where}"
        )
    return payload


# ---- tensors <-> host arrays ---------------------------------------------


def _host(tensor: torch.Tensor) -> np.ndarray:
    """A host copy of ``tensor`` (always a copy, also of a CPU tensor:
    the live one moves on with the next step)."""
    tensor = tensor.detach().to("cpu", copy=True)
    if tensor.dtype == torch.bfloat16:
        return dtypes.bf16_to_numpy(tensor)
    return tensor.numpy()


def _tensor(value) -> torch.Tensor:
    value = np.asarray(value)
    if value.dtype == dtypes.BFLOAT16_BITS:
        return dtypes.bf16_from_numpy(value)
    return torch.from_numpy(np.asarray(value, order="C"))


def _copy_into(target: torch.Tensor, value, name: str):
    source = _tensor(value)
    if tuple(source.shape) != tuple(target.shape):
        raise ValueError(
            f"Checkpoint leaf {name} shape {tuple(source.shape)} != "
            f"state shape {tuple(target.shape)}"
        )
    with torch.no_grad():
        target.copy_(source)


# ---- field rules ---------------------------------------------------------


def _opt_leaves(state):
    optimizer = state.optimizer
    names = {p: name for name, p in state.model.named_parameters()}
    for p in optimizer.state:
        if p not in names:
            raise ValueError(
                "the optimizer holds state for a tensor that is not a "
                "parameter of the model; its slots have no name"
            )
    for name, p in state.model.named_parameters():
        for slot, value in optimizer.state.get(p, {}).items():
            if not isinstance(value, torch.Tensor):
                raise TypeError(
                    f"optimizer state {name}.{slot} is "
                    f"{type(value).__name__}, not a tensor"
                )
            yield f"opt_state.{name}.{slot}", value


def _group_of(optimizer, p):
    for group in optimizer.param_groups:
        if any(q is p for q in group["params"]):
            return group
    raise ValueError("a parameter outside every optimizer group")


def _restore_opt(state, named, strict: bool):
    """Copy each slot into the live optimizer state, creating the slots a
    fresh optimizer does not have yet."""
    optimizer = state.optimizer
    saved: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in named.items():
        if key.startswith("opt_state."):
            pname, slot = key[len("opt_state."):].rsplit(".", 1)
            saved.setdefault(pname, {})[slot] = value
    for pname, p in state.model.named_parameters():
        live = optimizer.state[p] if p in optimizer.state else {}
        slots = saved.get(pname, {})
        missing = [s for s in live if s not in slots]
        if missing and strict:
            raise KeyError(
                f"Checkpoint missing leaf opt_state.{pname}.{missing[0]}"
            )
        for slot, value in slots.items():
            key = f"opt_state.{pname}.{slot}"
            if slot in live:
                _copy_into(live[slot], value, key)
                continue
            tensor = _tensor(value).clone()
            group = _group_of(optimizer, p)
            if slot == "step" and tensor.dim() == 0:
                # torch's own placement of a per-parameter step count
                if group.get("capturable") or group.get("fused"):
                    tensor = tensor.to(p.device)
            else:
                if tuple(tensor.shape) != tuple(p.shape):
                    raise ValueError(
                        f"Checkpoint leaf {key} shape "
                        f"{tuple(tensor.shape)} != parameter shape "
                        f"{tuple(p.shape)}"
                    )
                tensor = tensor.to(p.device)
            optimizer.state[p][slot] = tensor


def _table_leaves(state):
    for t, table in state.tables.items():
        yield f"tables.{t}", table


def _slot_leaves(state):
    for t, slots in state.slot_tables.items():
        for slot, table in slots.items():
            yield f"slot_tables.{t}.{slot}", table


# field -> (named tensors or host values of the field); fields that are
# code, not state, map to None.
_FIELDS = {
    "model": lambda s: (
        (f"params.{n}", p) for n, p in s.model.named_parameters()),
    "optimizer": _opt_leaves,
    "generator": lambda s: (("rng", s.generator.get_state()),),
    "model_takes_generator": None,
    "step": lambda s: (("step", np.asarray(s.step, np.int64)),),
    "batch_stats": lambda s: (
        (f"batch_stats.{n}", b) for n, b in s.batch_stats.items()),
    "tables": _table_leaves,
    "slot_tables": _slot_leaves,
    "table_steps": lambda s: (
        (f"table_steps.{t}", np.asarray(n, np.int64))
        for t, n in s.table_steps.items()),
}


def _state_fields(state):
    if not dataclasses.is_dataclass(state):
        raise TypeError(f"{type(state).__name__} is not a train state")
    for field in dataclasses.fields(state):
        if field.name not in _FIELDS:
            raise NotImplementedError(
                f"{type(state).__name__}.{field.name}: no checkpoint rule "
                "for this field (checkpoint/state_io.py)"
            )
        if _FIELDS[field.name] is not None:
            yield field.name


def named_leaves_from_state(state) -> Dict[str, np.ndarray]:
    """Flatten state into {leaf name: host ndarray} (synchronous host
    copies)."""
    out = {}
    for field in _state_fields(state):
        for name, leaf in _FIELDS[field](state):
            out[name] = (_host(leaf) if isinstance(leaf, torch.Tensor)
                         else leaf)
    return out


def restore_state_from_named_leaves(state, named: Dict[str, np.ndarray],
                                    strict: bool = True):
    """Fill ``state``'s leaves from the named dict, in place, and return
    it. Missing names raise when ``strict`` (reference restore asserts
    variable presence, save_utils.py:230-247); names the state does not
    have are ignored, as in the JAX module."""

    def take(name):
        if name in named:
            return named[name]
        if strict:
            raise KeyError(f"Checkpoint missing leaf {name}")
        return None

    fields = list(_state_fields(state))
    for field in fields:
        if field == "optimizer":
            _restore_opt(state, named, strict)
        elif field == "generator":
            value = take("rng")
            if value is not None:
                state.generator.set_state(
                    torch.from_numpy(np.array(value, np.uint8)))
        elif field == "step":
            value = take("step")
            if value is not None:
                state.step = int(value)
        elif field == "table_steps":
            for t in state.table_steps:
                value = take(f"table_steps.{t}")
                if value is not None:
                    state.table_steps[t] = int(value)
        else:
            for name, leaf in _FIELDS[field](state):
                value = take(name)
                if value is not None:
                    _copy_into(leaf, value, name)
    if "optimizer" in fields:
        from elasticdl_tpu_torch.callbacks import seek_lr_schedule

        seek_lr_schedule(state.optimizer, state.step)
    return state
