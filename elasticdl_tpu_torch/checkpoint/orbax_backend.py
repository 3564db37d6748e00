"""Multi-host checkpoints (port of
elasticdl_tpu/checkpoint/orbax_backend.py), written with
``torch.distributed.checkpoint`` (DCP).

The native saver (``checkpoint/saver.py``) writes a state's whole
leaves from one process. A state whose mesh spans processes holds only
blocks of some leaves (a ``tp`` split, the stages of a pipeline, a
ZeRO-split slot, a row-split table), so the JAX package saves such
jobs with orbax, every process writing its shards. This module keeps
that backend's names (``OrbaxSaver``, ``save_state``,
``restore_state``) and its ``orbax-<version>`` directories, but the
format is DCP's: each process writes the parts of the leaves it holds,
with their offsets in the whole leaf (a part two processes hold alike
is written once), and the coordinator writes the ``.metadata`` file
that lists every part. A restore reads, for each leaf, the regions the
target state holds, from whichever parts overlap them: any target
layout, the mesh-resize contract.

- A write lands in ``orbax-<version>.dcp-tmp`` and is renamed to
  ``orbax-<version>`` once every process has written its parts, so a
  write in progress never matches ``hooks.py``'s finalized-version
  pattern and is never counted or pruned.
- Saves run on a background writer (one in flight, as orbax's async
  save): the caller's thread copies the state's parts to the host and
  returns; the DCP write runs over ``multihost.side_group`` (made at
  the first save), so the training step's collectives never share a
  group with it. A restore runs in the caller's thread, over the
  default group.
- A version directory without DCP metadata (the JAX package's orbax
  format) raises ``ValueError`` naming that format: the two packages
  cannot read each other's multi-host checkpoints.
- ``collective``: the processes of the job save and restore together
  (default: where the job has several). One process can restore a
  collectively written version alone (``collective=False``), onto any
  layout, e.g. an unsharded model.
"""

import os
import re
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from elasticdl_tpu_torch.common import dtypes
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("orbax_backend")

_VERSION_RE = re.compile(r"^orbax-(\d+)$")
_METADATA = ".metadata"


def _version_dir(base: str, version: int) -> str:
    return os.path.join(base, f"orbax-{version}")


class Parts:
    """A leaf this process holds in parts: ``(offsets, tensor)`` pairs
    on the host, within a whole leaf of ``shape``. DCP writes the parts
    (``__create_write_items__``) and reads into them
    (``__create_chunk_list__``), by the protocol its own distributed
    tensors follow."""

    def __init__(self, shape, parts):
        self.shape = torch.Size(shape)
        self.parts = [(torch.Size(offsets), tensor)
                      for offsets, tensor in parts]

    @classmethod
    def whole(cls, tensor: torch.Tensor) -> "Parts":
        return cls(tensor.shape, [((0,) * tensor.dim(), tensor)])

    def size(self) -> torch.Size:
        return self.shape

    def __create_write_items__(self, fqn, obj):
        from torch.distributed.checkpoint.metadata import (
            ChunkStorageMetadata,
            MetadataIndex,
            TensorProperties,
        )
        from torch.distributed.checkpoint.planner import (
            TensorWriteData,
            WriteItem,
            WriteItemType,
        )

        return [WriteItem(
            index=MetadataIndex(fqn, offsets, i),
            type=WriteItemType.SHARD,
            tensor_data=TensorWriteData(
                chunk=ChunkStorageMetadata(offsets=offsets,
                                           sizes=tensor.size()),
                properties=TensorProperties.create_from_tensor(tensor),
                size=self.shape))
            for i, (offsets, tensor) in enumerate(self.parts)]

    def __create_chunk_list__(self):
        from torch.distributed.checkpoint.metadata import (
            ChunkStorageMetadata,
        )

        return [ChunkStorageMetadata(offsets=offsets, sizes=tensor.size())
                for offsets, tensor in self.parts]

    def __get_tensor_shard__(self, index):
        for offsets, tensor in self.parts:
            if offsets == torch.Size(index.offset):
                return tensor
        raise ValueError(f"{index.fqn}: no part at {index.offset}")


def _planners():
    """DCP's default planners, told how to find a ``Parts`` entry's
    tensors (they look plain entries up as tensors)."""
    from torch.distributed.checkpoint import (
        DefaultLoadPlanner,
        DefaultSavePlanner,
    )
    from torch.distributed.checkpoint.planner import SavePlan

    class SavePlanner(DefaultSavePlanner):
        def create_local_plan(self):
            # Every process lists every part it holds; the coordinator's
            # global plan drops the duplicates (a part several processes
            # hold alike is written once).
            self.plan = SavePlan([
                item for fqn, obj in self.state_dict.items()
                for item in obj.__create_write_items__(fqn, obj)])
            return self.plan

        def lookup_object(self, index):
            return self.state_dict[index.fqn].__get_tensor_shard__(index)

    class LoadPlanner(DefaultLoadPlanner):
        def set_up_planner(self, state_dict, metadata=None,
                           is_coordinator=False):
            self.original_state_dict = self.state_dict = state_dict
            self.metadata = metadata
            self.is_coordinator = is_coordinator

        def create_local_plan(self):
            # Each part reads from every saved part that overlaps it.
            from torch.distributed.checkpoint.planner import LoadPlan
            from torch.distributed.checkpoint.planner_helpers import (
                create_read_items_for_chunk_list,
            )

            items = []
            for fqn, obj in self.state_dict.items():
                md = self.metadata.state_dict_metadata[fqn]
                if torch.Size(md.size) != obj.shape:
                    raise ValueError(f"{fqn}: saved shape {tuple(md.size)}, "
                                     f"the target's {tuple(obj.shape)}")
                items += create_read_items_for_chunk_list(
                    fqn, md, obj.__create_chunk_list__())
            return LoadPlan(items)

        def lookup_tensor(self, index):
            return self.state_dict[index.fqn].__get_tensor_shard__(index)

    return (SavePlanner(flatten_state_dict=False,
                        flatten_sharded_tensors=False),
            LoadPlanner(flatten_state_dict=False,
                        flatten_sharded_tensors=False))


class OrbaxSaver:
    """Version directories of DCP checkpoints, written in the
    background and restored onto any layout: ``save``, ``wait``,
    ``versions``, ``get_valid_latest_version``, ``restore_tree`` and
    keep-max GC, as the JAX package's saver."""

    def __init__(self, checkpoint_dir: str, keep_max: int = 3,
                 collective: Optional[bool] = None, async_save: bool = True):
        from elasticdl_tpu_torch.checkpoint.writer import CheckpointWriter
        from elasticdl_tpu_torch.parallel import multihost

        self.checkpoint_dir = os.path.abspath(checkpoint_dir)
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        self.keep_max = keep_max
        self.collective = (multihost.process_count() > 1
                           if collective is None else bool(collective))
        # The background writes' group (``save`` takes it).
        self._group = None
        self._coordinator = (not self.collective
                             or multihost.process_index() == 0)
        self._writer = CheckpointWriter(max_pending=1, sync=not async_save)

    def _barrier(self):
        if self._group is not None:
            import torch.distributed as dist

            dist.barrier(group=self._group)

    def _dcp(self, group=None):
        if self.collective:
            return {"process_group": group}
        return {"no_dist": True}

    def save(self, version: int, tree: Dict[str, Parts]) -> str:
        """Write ``tree`` (``{name: Parts}``, host tensors the caller no
        longer changes) as ``version``: joins the previous write, then
        starts this one in the background (``wait`` joins it)."""
        path = _version_dir(self.checkpoint_dir, version)
        if self.collective and self._group is None:
            from elasticdl_tpu_torch.parallel import multihost

            self._group = multihost.side_group()

        def write():
            import torch.distributed.checkpoint as dcp

            tmp = path + ".dcp-tmp"
            if self._coordinator:
                shutil.rmtree(tmp, ignore_errors=True)
            self._barrier()
            save_planner, _ = _planners()
            dcp.save(tree, storage_writer=dcp.FileSystemWriter(tmp),
                     planner=save_planner, **self._dcp(self._group))
            if self._coordinator:
                shutil.rmtree(path, ignore_errors=True)
                os.replace(tmp, path)
            self._barrier()
            # GC over finalized versions only (a write in progress is not
            # listed, so it is neither pruned nor counted).
            if self._coordinator:
                self._gc(self._list_versions())

        self._writer.submit(write, label=f"orbax-{version}")
        logger.info("Saving checkpoint version %d (DCP, async)", version)
        return path

    def wait(self):
        """Join the write in flight; raise its failure."""
        self._writer.flush()

    def _list_versions(self):
        out = []
        for name in os.listdir(self.checkpoint_dir):
            m = _VERSION_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def versions(self):
        # Join the write in flight so callers see a consistent listing.
        self.wait()
        return self._list_versions()

    def get_valid_latest_version(self) -> Optional[int]:
        versions = self.versions()
        return versions[-1] if versions else None

    def _path(self, version: Optional[int]) -> str:
        self.wait()
        if version is None:
            version = self.get_valid_latest_version()
            if version is None:
                raise FileNotFoundError(
                    f"No orbax checkpoint under {self.checkpoint_dir}")
        path = _version_dir(self.checkpoint_dir, version)
        if not os.path.isdir(path):
            raise FileNotFoundError(f"No checkpoint version at {path}")
        if not os.path.exists(os.path.join(path, _METADATA)):
            raise ValueError(
                f"{path} holds no torch.distributed.checkpoint metadata: "
                "it was written in the orbax format (the JAX package's "
                "multi-host checkpoints), which this package cannot read")
        return path

    def metadata(self, version: Optional[int] = None) -> Dict[str, tuple]:
        """``{name: (whole shape, torch dtype)}`` of every leaf a version
        holds."""
        import torch.distributed.checkpoint as dcp

        md = dcp.FileSystemReader(self._path(version)).read_metadata()
        return {name: (tuple(m.size), m.properties.dtype)
                for name, m in md.state_dict_metadata.items()
                if hasattr(m, "size")}

    def restore_tree(self, tree: Dict[str, Parts],
                     version: Optional[int] = None) -> Dict[str, Parts]:
        """Fill ``tree``'s parts (``{name: Parts}``: the regions of the
        whole leaves the target holds) from ``version`` (default: the
        newest), in place; returns it."""
        import torch.distributed.checkpoint as dcp

        path = self._path(version)
        _, load_planner = _planners()
        dcp.load(tree, storage_reader=dcp.FileSystemReader(path),
                 planner=load_planner, **self._dcp())
        return tree

    def _gc(self, versions):
        if self.keep_max and len(versions) > self.keep_max:
            for version in versions[: -self.keep_max]:
                shutil.rmtree(_version_dir(self.checkpoint_dir, version),
                              ignore_errors=True)


# ---- the train state's leaves as parts ------------------------------------


def _host(tensor: torch.Tensor) -> torch.Tensor:
    return tensor.detach().to("cpu", copy=True)


def _placed_params(model) -> Dict[str, object]:
    """``{parameter name: NamedSharding}`` of every parameter held as
    its process's block (``module._placed`` where it spans
    processes)."""
    out = {}
    for prefix, module in model.named_modules():
        for leaf, sharding in module.__dict__.get("_placed", {}).items():
            if getattr(sharding, "spans_processes", False):
                out[f"{prefix}.{leaf}" if prefix else leaf] = (
                    sharding, module.__dict__["_whole_shapes"][leaf])
    return out


def _param_of(name: str) -> Optional[str]:
    """The parameter a ``params.`` or ``opt_state.`` leaf belongs to."""
    if name.startswith("params."):
        return name[len("params."):]
    if name.startswith("opt_state."):
        return name[len("opt_state."):].rsplit(".", 1)[0]
    return None


def _parts_of(name, leaf, placed) -> Parts:
    from elasticdl_tpu_torch.parallel.mesh import ShardedTensor

    if isinstance(leaf, ShardedTensor):
        slices = leaf.sharding.whole_slices(leaf.shape)
        return Parts(leaf.shape, [
            (tuple(s.start or 0 for s in index), _host(shard))
            for index, shard in zip(slices, leaf.shards)])
    if not isinstance(leaf, torch.Tensor):
        value = np.asarray(leaf)
        return Parts.whole(torch.from_numpy(np.array(value, copy=True)))
    param = _param_of(name)
    if param in placed and leaf.dim():
        # The parameter's block, or a plain optimizer's slot of it.
        sharding, whole_shape = placed[param]
        block = sharding.block_slices(whole_shape)
        if tuple(leaf.shape) == tuple(b.stop - b.start for b in block):
            return Parts(whole_shape, [(tuple(b.start for b in block),
                                        _host(leaf))])
    return Parts.whole(_host(leaf))


def state_parts(state) -> Dict[str, Parts]:
    """Every leaf of ``state`` (``state_io.named_leaves``) as the parts
    this process holds, copied to the host."""
    from elasticdl_tpu_torch.checkpoint.state_io import named_leaves

    placed = _placed_params(state.model)
    return {name: _parts_of(name, leaf, placed)
            for name, leaf in named_leaves(state)}


def save_state(saver: OrbaxSaver, state) -> str:
    """Save a train state's leaves (the same names as the native
    backend's, ``state_io.named_leaves``) as version ``state.step``:
    each process its parts."""
    return saver.save(int(state.step), state_parts(state))


def _zero_split(state, name: str) -> bool:
    """``name`` is a slot that a ZeRO optimizer splits: restored whole,
    each entry taking its slice (``ZeroOptimizer.restore_plan``)."""
    from elasticdl_tpu_torch.parallel.zero import ZeroOptimizer

    optimizer = state.optimizer
    return (name.startswith("opt_state.")
            and isinstance(optimizer, ZeroOptimizer)
            and _param_of(name) in getattr(optimizer, "_views", {}))


def _as_block(name, shape, state, placed) -> bool:
    """The state holds the leaf ``name`` as its process's block of a
    placed parameter (the parameter, or a plain optimizer's slot)."""
    param = _param_of(name)
    return (param in placed and len(shape) > 0
            and tuple(shape) == tuple(placed[param][1])
            and not _zero_split(state, name))


def _regions(name, shape, state, placed, live) -> list:
    """The slices of the whole leaf ``name`` the target state holds."""
    from elasticdl_tpu_torch.parallel.mesh import ShardedTensor

    leaf = live.get(name)
    if isinstance(leaf, ShardedTensor):
        return leaf.sharding.whole_slices(shape)
    if _zero_split(state, name) and shape:
        return state.optimizer.shardings[_param_of(name)].whole_slices(shape)
    if _as_block(name, shape, state, placed):
        return [placed[_param_of(name)][0].block_slices(shape)]
    return [tuple(slice(0, n) for n in shape)]


def _numpy(tensor: torch.Tensor) -> np.ndarray:
    if tensor.dtype == torch.bfloat16:
        return dtypes.bf16_to_numpy(tensor)
    return tensor.numpy()


def restore_state(saver: OrbaxSaver, state, version: Optional[int] = None):
    """Restore ``state`` in place from ``version`` (default: the newest)
    onto its own layout: each leaf's regions that this process holds
    are read (from whatever parts a save of any layout wrote) and copied
    into the live tensors, as ``state_io.restore_state_from_named_leaves``
    does for the native backend (a fresh optimizer's slots are created
    from the checkpoint). Returns the state."""
    from elasticdl_tpu_torch.checkpoint.state_io import (
        named_leaves,
        restore_state_from_named_leaves,
    )

    placed = _placed_params(state.model)
    live = dict(named_leaves(state))
    params = {n for n, _ in state.model.named_parameters()}
    metadata = saver.metadata(version)
    wanted = {name: meta for name, meta in metadata.items()
              if name in live or (name.startswith("opt_state.")
                                  and _param_of(name) in params)}
    buffers, tree = {}, {}
    for name, (shape, dtype) in wanted.items():
        # Uninitialised: only the regions read are ever touched.
        buf = buffers[name] = torch.empty(shape, dtype=dtype)
        tree[name] = Parts(shape, [
            (tuple(s.start or 0 for s in index), buf[index])
            for index in _regions(name, shape, state, placed, live)])
    saver.restore_tree(tree, version)
    named = {}
    for name, buf in buffers.items():
        if _as_block(name, buf.shape, state, placed):
            # Only the block was read: the live leaf is the block.
            buf = buf[placed[_param_of(name)][0].block_slices(buf.shape)]
        named[name] = _numpy(buf)
    return restore_state_from_named_leaves(state, named)
