"""Live resharding: move a train state between meshes without a disk
round trip (port of elasticdl_tpu/parallel/reshard.py).

The checkpoint-restart path saves the state, tears the worker down and
restores onto the new mesh. The live path re-places the state where it
is: every placed leaf (a ZeRO optimizer's slots, a row-sharded table and
its slot tables) is gathered from the old mesh's entries and split for
the new mesh's, by the same rules the runner uses at init
(``place_state``). On the one device that is a ``cat`` and a
``narrow``; nothing goes through the host unless the card cannot
make an allocation, when every placed leaf is first gathered to host
memory, freeing its device shards, and placed from there. The new
placement is checked before anything moves, and a failure after that
puts the state back on the old mesh.

Semantics, as in JAX: the resharded state is the state a checkpoint at
the same step would capture (callers resize at a step boundary; the
Worker does it at a task boundary). Resharding does not change
``state.step``; the master's resize barrier carries its own
``resize_id`` fence, so a directive is applied at most once per worker.
"""

from typing import Callable, Optional

import numpy as np
import torch

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.parallel.mesh import make_mesh, whole
from elasticdl_tpu_torch.parallel.zero import (
    WholeSlots,
    ZeroOptimizer,
    whole_slots,
)

logger = get_logger("reshard")


def gather_to_host(state):
    """Gather every placed leaf of ``state`` to host memory, in place: a
    ``ShardedTensor`` table or slot table becomes its whole value on the
    CPU, a ZeRO optimizer its whole slots on the CPU (``WholeSlots``),
    so the device shards are released. The model's parameters (one
    replicated copy) stay where they are. Returns ``state``."""
    cpu = torch.device("cpu")
    if isinstance(state.optimizer, ZeroOptimizer):
        slots = whole_slots(state.optimizer, state.model)
        state.optimizer = WholeSlots({
            name: {slot: v.to(cpu) for slot, v in named.items()}
            for name, named in slots.items()})
    for field in ("tables", "slot_tables"):
        leaves = getattr(state, field, None) or {}
        for name, leaf in list(leaves.items()):
            if isinstance(leaf, dict):
                for slot, sub in list(leaf.items()):
                    leaf[slot] = whole(sub).to(cpu)
            else:
                leaves[name] = whole(leaf).to(cpu)
    return state


def live_reshard(state, check_fn: Callable, place_fn: Callable,
                 undo_fn: Callable):
    """Re-place ``state`` on a runner's new mesh, as JAX's
    ``live_reshard`` does: the placement is derived and checked first
    (``check_fn(state)``, the runner's ``state_shardings`` bound to the
    new mesh), so a placement the port does not have raises before
    anything changes. Then ``place_fn(state)`` (its ``place_state``):
    the on-device gather and split. Only an allocation the card cannot
    make (``torch.OutOfMemoryError``) takes the host bounce: logged,
    ``gather_to_host``, ``place_fn`` again. If anything after the check
    fails, ``undo_fn(state)`` places the state back on the old mesh
    (values kept; a leaf already moved moves back) and the error is
    raised. Returns the resharded state."""
    check_fn(state)
    try:
        try:
            return place_fn(state)
        except torch.OutOfMemoryError as exc:
            logger.warning("on-device reshard failed (%s); falling back "
                           "to the host bounce", exc)
        return place_fn(gather_to_host(state))
    except Exception:
        undo_fn(state)
        raise


def reshard_state(state, leaves, place_fn: Callable):
    """Fill ``state`` from host ``leaves`` (``{checkpoint leaf name:
    array}``, as ``checkpoint.state_io.named_leaves_from_state`` gives
    them) and place it with ``place_fn``: a checkpoint restore and
    ``place_state`` in one call, without the disk."""
    from elasticdl_tpu_torch.checkpoint.state_io import (
        restore_state_from_named_leaves,
    )

    return place_fn(restore_state_from_named_leaves(state, leaves))


def abstract_like(state) -> dict:
    """``{checkpoint leaf name: (shape, dtype)}`` of ``state``, a placed
    leaf by its whole shape: what the runners' placement rules read."""
    from elasticdl_tpu_torch.checkpoint.state_io import named_leaves

    return {name: (tuple(np.shape(leaf)) if not hasattr(leaf, "shape")
                   else tuple(leaf.shape), getattr(leaf, "dtype", None))
            for name, leaf in named_leaves(state)}


def mesh_spec(mesh) -> dict:
    """The resize directive's description of a mesh (shape and axis
    names). The receiving worker rebuilds it over its own device: device
    identities are process-local and never cross the wire."""
    return {"shape": [int(s) for s in mesh.devices.shape],
            "axes": [str(a) for a in mesh.axis_names]}


def mesh_from_spec(spec: dict, devices: Optional[list] = None,
                   device=None):
    """The directive's mesh on this process: ``devices[:prod(shape)]``
    when a list is given (too short a list raises, as in JAX), else the
    worker's ``device`` (default: CUDA device 0) repeated ``prod(shape)``
    times, the port's single-device mesh."""
    shape = tuple(int(s) for s in spec["shape"])
    axes = tuple(str(a) for a in spec["axes"])
    need = int(np.prod(shape))
    if devices is None:
        devices = [torch.device(device if device is not None
                                else "cuda:0")] * need
    if len(devices) < need:
        raise ValueError(
            f"resize directive needs {need} device(s) ({shape} over "
            f"{axes}); only {len(devices)} available")
    return make_mesh(shape, axes, devices=list(devices)[:need])
