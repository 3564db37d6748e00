"""Device mesh (port of elasticdl_tpu/parallel/mesh.py).

A ``Mesh`` is a grid of ``torch.device`` entries with named axes, as
JAX's ``jax.sharding.Mesh`` is a grid of devices. Axis conventions:

- ``dp`` — data parallel (batch dimension),
- ``mp``/``tp`` — model/tensor parallel,
- ``sp`` — sequence/context parallel for long-context models.

Within a process every entry of a mesh is one and the same device, the
counterpart of JAX's virtual host devices (``[cuda:0] * 4``, or
``[cpu] * 4`` in the CPU tests): ``ring_attention`` runs the ring's
real schedule on that device, shard by shard, and a leaf that JAX
places per device is held as one tensor per entry (``ShardedTensor``).

Across processes (``parallel/multihost.py``, one process per card) the
mesh spans the job as JAX's ``make_mesh`` lays it out: the entries in
process order, reshaped row-major, so process p owns the p-th block of
``size / processes`` consecutive entries of the grid, and every entry
knows its process (``Mesh.processes``). A block must be a box of the
grid (whole rows of the inner axes, then a run of one axis), so along
every axis a process owns a run of coordinates (``axis_block``): on two
processes ``(1, 2, 2)`` over ``("dp", "sp", "tp")`` puts ``sp`` across
them, over ``("dp", "tp", "sp")`` ``tp``. ``Mesh.group(axes)`` is the
``multihost.Group`` of the processes that share this process's block on
every other axis: those its collectives over ``axes`` run with. The
mesh makes every such group when it is made, in one order in every
process (``new_group`` is collective). A process addresses only its own
entries' shards, as JAX's ``addressable_shards``.

``NamedSharding(mesh, spec)`` is where data crosses between entries,
and the only place: ``views`` gives each local entry its slice of a
whole tensor (or of the process's block of it, ``local_block``),
``split`` copies the slices into tensors of their own, and ``gather``
joins them. Within a process these are ``narrow``, ``narrow`` +
``clone`` and ``cat``; across processes ``gather`` is an all-gather
over the group of the split's axes. One process naming distinct local
cards still raises: the port runs one process per card.
"""

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticdl_tpu_torch.parallel.rules import PartitionSpec


def parse_mesh_args(mesh_shape: str, mesh_axes: str) -> Tuple[
    Optional[Tuple[int, ...]], Tuple[str, ...]
]:
    """``"4,2"``, ``"dp,mp"`` → ((4, 2), ("dp", "mp")); an empty shape
    means every device on the first axis (``None``)."""
    axes = tuple(a.strip() for a in mesh_axes.split(",") if a.strip())
    if not mesh_shape.strip():
        return None, axes or ("dp",)
    shape = tuple(int(s) for s in mesh_shape.split(",") if s.strip())
    if len(shape) != len(axes):
        raise ValueError(
            f"mesh_shape {shape} and mesh_axes {axes} length mismatch"
        )
    return shape, axes


class Mesh:
    """``devices``: an object array of ``torch.device``, one dim per axis
    of ``axis_names``; ``shape``: axis name → size, as JAX's
    ``mesh.shape``. ``processes``: each entry's process index (default:
    every entry this process's, the single-controller mesh)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 processes: Optional[np.ndarray] = None):
        from elasticdl_tpu_torch.parallel import multihost

        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"mesh of {devices.ndim} dims with axes {axis_names}"
            )
        self.devices = devices
        self.axis_names = axis_names
        rank = multihost.process_index()
        self.processes = (np.full(devices.shape, rank, dtype=np.int64)
                          if processes is None
                          else np.asarray(processes, np.int64))
        if self.processes.shape != devices.shape:
            raise ValueError(f"processes of shape {self.processes.shape} "
                             f"for devices of shape {devices.shape}")
        self.process_index = rank
        self.process_count = len(np.unique(self.processes))
        self._groups = {}
        if self.spans_processes:
            self._make_groups()

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def spans_processes(self) -> bool:
        return self.process_count > 1

    @property
    def local_entries(self) -> np.ndarray:
        """Flat indices of this process's entries."""
        return np.flatnonzero(self.processes.ravel() == self.process_index)

    @property
    def device(self) -> torch.device:
        """The one device every local entry names."""
        return self.devices.flat[int(self.local_entries[0])]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _box(self, process: int) -> Tuple[Tuple[int, int], ...]:
        """``(first, last + 1)`` of ``process``'s coordinates along each
        axis."""
        where = np.argwhere(self.processes == process)
        return tuple((int(lo), int(hi) + 1)
                     for lo, hi in zip(where.min(0), where.max(0)))

    def axis_block(self, axis: str) -> Tuple[int, int]:
        """``(first, last + 1)``: this process's run of coordinates along
        ``axis``."""
        return self._box(self.process_index)[self.axis_names.index(axis)]

    def block_of(self, axis: str) -> Tuple[int, int]:
        """``(blocks, this process's block)`` along ``axis``: the axis
        cut into runs as long as this process's; ``(1, 0)`` where the
        mesh has no such axis."""
        if axis not in self.axis_names:
            return 1, 0
        lo, hi = self.axis_block(axis)
        return self.shape[axis] // (hi - lo), lo // (hi - lo)

    def _make_groups(self):
        """Every axis set's groups, in one order in every process: the
        processes that share their block on every axis outside the set
        form a group."""
        from itertools import combinations

        from elasticdl_tpu_torch.parallel import multihost

        boxes = {q: self._box(q) for q in range(self.process_count)}
        dims = range(len(self.axis_names))
        for k in range(1, len(self.axis_names) + 1):
            for subset in combinations(dims, k):
                keep = [d for d in dims if d not in subset]
                parts = {}
                for q, box in boxes.items():
                    parts.setdefault(tuple(box[d] for d in keep),
                                     []).append(q)
                for ranks in sorted(parts.values()):
                    group = multihost.make_group(ranks)
                    if self.process_index in ranks:
                        self._groups[subset] = group

    def group(self, axes: Sequence[str]):
        """The ``multihost.Group`` of the processes whose entries differ
        from this process's only along ``axes`` (a group of this process
        alone on a mesh of one process, or where no axis of ``axes``
        spans processes)."""
        from elasticdl_tpu_torch.parallel import multihost

        subset = tuple(sorted(self.axis_names.index(a) for a in set(axes)
                              if a in self.axis_names))
        if not subset or not self.spans_processes:
            return multihost.Group((self.process_index,))
        return self._groups[subset]

    def __eq__(self, other):
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and list(self.devices.flat) == list(other.devices.flat)
                and np.array_equal(self.processes, other.processes))

    def __hash__(self):
        return hash((self.axis_names, self.devices.shape,
                     tuple(map(str, self.devices.flat)),
                     tuple(self.processes.flat)))

    def __deepcopy__(self, memo):
        # A mesh names devices and process groups: a copy of a model
        # built for it runs on the same mesh.
        return self

    def __repr__(self):
        if self.spans_processes:
            return (f"Mesh({self.shape}, {self.process_count} processes, "
                    f"{self.device} here)")
        return f"Mesh({self.shape}, {self.device})"


def _local_devices():
    from elasticdl_tpu_torch.parallel import multihost

    if multihost.local_device() is not None:
        return [multihost.local_device()]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: no CUDA device; pass devices=[torch.device('cpu')] "
            "* n to build a mesh on the CPU"
        )
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def same_device(a: torch.device, b: torch.device) -> bool:
    """Equal, where a device without an index matches any index."""
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axes: Sequence[str] = ("dp",),
    devices=None,
) -> Mesh:
    """A mesh of ``shape`` over this process's ``devices`` (default: its
    card after ``multihost.initialize_multihost``, else every CUDA
    device, RuntimeError with none). Entries may repeat a device; they
    must all be the same one (NotImplementedError otherwise: one process
    per card). Several processes: ``shape`` is the global mesh, each
    process gives ``size / processes`` entries and owns the block of the
    row-major grid in its place (as JAX's ``make_mesh`` reshapes the
    process-ordered devices), which must be a box; ``shape=None`` puts
    every entry on the first axis."""
    from elasticdl_tpu_torch.parallel import multihost

    devices = [torch.device(d) for d in (
        devices if devices is not None else _local_devices())]
    if not all(same_device(d, devices[0]) for d in devices):
        raise NotImplementedError(
            f"a mesh over distinct devices {sorted(set(map(str, devices)))}"
            " of one process (ROADMAP Queue 1 item 6b runs one process per "
            "card: start a process for each and pass --num_jax_processes);"
            " every entry of a process must be one device, e.g. "
            "[torch.device('cuda:0')] * 4"
        )
    count, rank = multihost.process_count(), multihost.process_index()
    global_size = len(devices) * count
    if shape is None:
        shape = (global_size,)
        axes = tuple(axes[:1]) or ("dp",)
    size = int(np.prod(shape))
    if size != global_size:
        raise ValueError(
            f"Mesh shape {tuple(shape)} needs {size} devices, "
            f"have {len(devices)}"
            + (f" in each of {count} processes" if count > 1 else "")
        )
    per = len(devices)
    if count > 1 and not _blocks_are_boxes(tuple(shape), per):
        raise ValueError(
            f"mesh shape {tuple(shape)} over {count} processes of {per} "
            "entries: a process's block of the row-major grid must be a "
            "box (whole runs of the inner axes, then a run along one "
            "axis)")
    grid = np.empty(size, dtype=object)
    owners = np.repeat(np.arange(count), per)
    remote = multihost.process_devices() or [devices[0]] * count
    for q in range(count):
        grid[q * per:(q + 1) * per] = (devices if q == rank
                                       else [remote[q]] * per)
    return Mesh(grid.reshape(tuple(shape)), tuple(axes),
                owners.reshape(tuple(shape)))


def _blocks_are_boxes(shape: Tuple[int, ...], per: int) -> bool:
    """Whether runs of ``per`` consecutive entries of a row-major grid
    of ``shape`` are boxes: the trailing axes whole, then a run along
    one axis that its size divides."""
    inner = 1
    for size in reversed(shape):
        if per % (inner * size) == 0:
            inner *= size
            continue
        return size % (per // inner) == 0 if per % inner == 0 else False
    return True


# ---- shardings ---------------------------------------------------------


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


class NamedSharding:
    """A leaf's placement on ``mesh`` by ``spec`` (as
    ``jax.sharding.NamedSharding``). Each split dim's shard of an entry
    is its coordinates along that dim's axes, row-major; a process's
    shards along a dim are a run (its block). The parameter rules of
    this port split one dim (rows of a table, ZeRO's first divisible
    dim, a ``tp`` rule) or two (the experts' ``P("ep", None, "tp")``;
    the batch's token ids ``P("dp", "sp")``). A process's shards are
    ordered row-major over the split dims (``block_views``). ``dim``,
    ``num_shards`` and ``local_shards`` describe a split of one dim;
    ``dims`` lists every split dim."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec = PartitionSpec()):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)
        self.splits = [(d, _axes(e)) for d, e in enumerate(self.spec)
                       if e is not None]
        named = [a for _, axes in self.splits for a in axes]
        if len(set(named)) < len(named):
            # As jax.sharding.NamedSharding: an axis splits one dim.
            raise ValueError(f"{self.spec} names a mesh axis twice")
        self.dims = [d for d, _ in self.splits]
        coords = np.indices(mesh.devices.shape)
        local = mesh.local_entries
        self.counts, self.locals = {}, {}
        for d, axes in self.splits:
            shard_of = np.zeros(mesh.devices.shape, dtype=np.int64)
            count = 1
            for a in axes:
                count *= mesh.shape[a]
                shard_of = (shard_of * mesh.shape[a]
                            + coords[mesh.axis_names.index(a)])
            self.counts[d] = count
            self.locals[d] = sorted(set(shard_of.ravel()[local].tolist()))
        self.num_shards = int(np.prod(list(self.counts.values()) or [1]))
        self.dim = self.dims[0] if len(self.dims) == 1 else None
        self.local_shards = (self.locals[self.dim] if self.dim is not None
                             else [0] if not self.dims else None)

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and self.mesh == other.mesh
                and self.spec.normalized() == other.spec.normalized())

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    @property
    def is_replicated(self) -> bool:
        return self.num_shards == 1

    @property
    def spans_processes(self) -> bool:
        """Whether a process holds only some of the shards (its block)."""
        return any(len(self.locals[d]) < self.counts[d] for d in self.dims)

    def axes_of(self, dim: int) -> tuple:
        return dict(self.splits)[dim]

    def group(self):
        """The processes that hold the other blocks of the leaf (those
        whose entries differ only along the split axes)."""
        return self.mesh.group([a for _, axes in self.splits for a in axes])

    def shard_shape(self, shape) -> tuple:
        out = list(shape)
        for d in self.dims:
            if out[d] % self.counts[d]:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"into {self.counts[d]}")
            out[d] //= self.counts[d]
        return tuple(out)

    def block_slices(self, shape) -> tuple:
        """The process's block of a whole leaf of ``shape`` (a ``slice``
        a dim): the run of its shards along every split dim."""
        index = [slice(0, n) for n in shape]
        for d in self.dims:
            rows = shape[d] // self.counts[d]
            first = self.locals[d][0] * rows
            index[d] = slice(first, first + len(self.locals[d]) * rows)
        return tuple(index)

    def local_block(self, tensor: torch.Tensor) -> torch.Tensor:
        """The process's block of a whole ``tensor`` (a view,
        ``block_slices``); the tensor itself where the process holds
        every shard."""
        if not self.spans_processes:
            return tensor
        return tensor[self.block_slices(tensor.shape)]

    def views(self, tensor: torch.Tensor) -> List[torch.Tensor]:
        """Each local shard's slice of a whole ``tensor``, as views (the
        reduce-scatter of a gradient, an entry's slice of a replicated
        parameter), in row-major order over the split dims. Entries
        that differ only along axes the spec does not name share a
        shard."""
        return self.block_views(self.local_block(tensor))

    def block_views(self, block: torch.Tensor) -> List[torch.Tensor]:
        """Each local shard's slice of the process's ``block`` of a leaf
        (``local_block``; a parameter placed across processes is held as
        its block), as views, row-major over the split dims."""
        if self.is_replicated:
            return [block]
        out = [block]
        for d in self.dims:
            rows = block.shape[d] // len(self.locals[d])
            out = [v.narrow(d, i * rows, rows) for v in out
                   for i in range(len(self.locals[d]))]
        return out

    def block_starts(self, dim: int, size: int) -> List[int]:
        """Each local shard's first index along ``dim`` of the whole leaf
        (``size`` long there), in ``block_views`` order: 0 for a dim the
        spec does not split."""
        if dim not in self.dims:
            return [0] * len(self.block_views_index())
        rows = size // self.counts[dim]
        at = self.dims.index(dim)
        return [combo[at] * rows for combo in self.block_views_index()]

    def block_views_index(self) -> List[tuple]:
        """The global shard index along each split dim of each local
        shard, in ``block_views`` order."""
        return list(itertools.product(*(self.locals[d] for d in self.dims)))

    def whole_slices(self, shape) -> List[tuple]:
        """Each local shard's slice of a whole leaf of ``shape`` (a tuple
        of ``slice`` a dim), in ``block_views`` order: what ``views``
        gives, for arrays that are not tensors (a saved slot)."""
        out = []
        for combo in self.block_views_index():
            index = [slice(None)] * len(shape)
            for d, i in zip(self.dims, combo):
                rows = shape[d] // self.counts[d]
                index[d] = slice(i * rows, (i + 1) * rows)
            out.append(tuple(index))
        return out

    def split(self, tensor: torch.Tensor) -> List[torch.Tensor]:
        """The local shards of a whole ``tensor`` as tensors of their
        own on the mesh's device."""
        device = self.mesh.device
        return [torch.empty(v.shape, dtype=v.dtype, device=device).copy_(v)
                for v in self.views(tensor)]

    def gather(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole tensor from the local shards (in ``block_views``
        order; across processes the all-gathers of ``gather_block``)."""
        if self.is_replicated:
            return shards[0]
        parts = list(shards)
        # Join the innermost split dim first: runs of its local count.
        for d in reversed(self.dims):
            n = len(self.locals[d])
            parts = [torch.cat(parts[i:i + n], dim=d)
                     for i in range(0, len(parts), n)]
        return self.gather_block(parts[0])

    def gather_block(self, block: torch.Tensor) -> torch.Tensor:
        """The whole tensor from this process's block (its shards
        joined): along each split dim that spans processes, the blocks
        of that dim's group, in order, one dim after the other."""
        if not self.spans_processes:
            return block
        from elasticdl_tpu_torch.parallel import multihost

        for d in self.dims:
            if len(self.locals[d]) == self.counts[d]:
                continue
            group = self.mesh.group(list(self.axes_of(d)))
            block = multihost.all_gather(block.movedim(d, 0),
                                         group=group).movedim(0, d)
        return block


class ShardedTensor:
    """A leaf held per entry: one tensor a distinct local shard, in
    entry order (``NamedSharding.split``; across processes a process
    holds only its own). ``shape`` is the global shape. What a
    checkpoint or a resize needs of it is its whole value (``gather``)
    and a copy back into the live shards (``copy_``: a restore never
    rebinds a tensor)."""

    def __init__(self, sharding: NamedSharding, shards: List[torch.Tensor]):
        if len(shards) != len(sharding.block_views_index()):
            raise ValueError(f"{len(shards)} shards for {sharding}")
        self.sharding = sharding
        self.shards = list(shards)

    @classmethod
    def from_whole(cls, sharding: NamedSharding, tensor: torch.Tensor):
        return cls(sharding, sharding.split(tensor))

    @property
    def shape(self) -> tuple:
        shape = list(self.shards[0].shape)
        for d in self.sharding.dims:
            shape[d] *= self.sharding.counts[d]
        return tuple(shape)

    @property
    def dtype(self):
        return self.shards[0].dtype

    def gather(self) -> torch.Tensor:
        return self.sharding.gather(self.shards)

    def copy_(self, whole: torch.Tensor):
        for shard, part in zip(self.shards, self.sharding.views(whole)):
            shard.copy_(part)
        return self


def whole(leaf) -> torch.Tensor:
    """A leaf's whole value: a ``ShardedTensor`` gathered, a tensor as
    it is."""
    return leaf.gather() if isinstance(leaf, ShardedTensor) else leaf


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def batch_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """The leading (batch) dim over the data axis."""
    return NamedSharding(mesh, PartitionSpec(axis))


def shard_leaf_over_axis(mesh: Mesh, leaf, axis: str = "dp"
                         ) -> NamedSharding:
    """ZeRO placement of one leaf: its first dim that the axis size
    divides (and is at least as large) is split over ``axis``;
    replicated where none is."""
    axis_size = mesh.shape[axis]
    shape = tuple(getattr(leaf, "shape", ()))
    for dim, size in enumerate(shape):
        if size % axis_size == 0 and size >= axis_size:
            spec = [None] * len(shape)
            spec[dim] = axis
            return NamedSharding(mesh, PartitionSpec(*spec))
    return NamedSharding(mesh, PartitionSpec())
