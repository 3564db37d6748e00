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
mesh spans the job: process p contributes its local entries, which
follow those of processes 0..p-1 in the grid, and every entry knows its
process (``Mesh.processes``). Processes split the first axis, the data
axis. A process addresses only its own entries' shards, as JAX's
``addressable_shards``.

``NamedSharding(mesh, spec)`` is where data crosses between entries,
and the only place: ``views`` gives each local entry its slice of a
whole tensor, ``split`` copies the slices into tensors of their own,
and ``gather`` joins them. Within a process these are ``narrow``,
``narrow`` + ``clone`` and ``cat``; across processes ``gather`` is an
all-gather over the data group. One process naming distinct local
cards still raises: the port runs one process per card.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticdl_tpu_torch.parallel.rules import PartitionSpec

WAITS_FOR_6B = ("waits for ROADMAP Queue 1 item 6b, steps 3-4 (tensor- and "
                "expert-parallel placement, tables split as parameters)")


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
    process gives ``size / processes`` entries, and the processes split
    the first axis; ``shape=None`` puts every entry on the first
    axis."""
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
    if count > 1 and shape[0] % count:
        raise NotImplementedError(
            f"mesh shape {tuple(shape)} over {count} processes: the "
            f"processes split the first axis, which {count} must divide "
            f"(an inner axis across processes {WAITS_FOR_6B})")
    grid = np.empty(size, dtype=object)
    per = len(devices)
    owners = np.repeat(np.arange(count), per)
    remote = multihost.process_devices() or [devices[0]] * count
    for q in range(count):
        grid[q * per:(q + 1) * per] = (devices if q == rank
                                       else [remote[q]] * per)
    return Mesh(grid.reshape(tuple(shape)), tuple(axes),
                owners.reshape(tuple(shape)))


# ---- shardings ---------------------------------------------------------


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


class NamedSharding:
    """A leaf's placement on ``mesh`` by ``spec`` (as
    ``jax.sharding.NamedSharding``). At most one dim may be split: the
    rules of this port (rows of a table, ZeRO's first divisible dim)
    split one."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec = PartitionSpec()):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)
        split = [(d, e) for d, e in enumerate(self.spec) if e is not None]
        if len(split) > 1:
            raise NotImplementedError(
                f"spec {self.spec} splits {len(split)} dims: a leaf split "
                f"over two axes {WAITS_FOR_6B}")
        self.dim = split[0][0] if split else None
        # Each entry's shard: its coordinates along the split axes,
        # row-major; the local shards are those of this process's
        # entries, in order.
        shard_of = np.zeros(mesh.devices.shape, dtype=np.int64)
        coords = np.indices(mesh.devices.shape)
        self.num_shards = 1
        for a in (_axes(split[0][1]) if split else ()):
            self.num_shards *= mesh.shape[a]
            shard_of = (shard_of * mesh.shape[a]
                        + coords[mesh.axis_names.index(a)])
        self.local_shards = sorted(set(
            shard_of.ravel()[mesh.local_entries].tolist()))
        k = len(self.local_shards)
        if k < self.num_shards and self.local_shards != list(
                range(mesh.process_index * k, (mesh.process_index + 1) * k)):
            raise NotImplementedError(
                f"spec {self.spec} gives process {mesh.process_index} the "
                f"shards {self.local_shards}: a split that is not the "
                f"processes' own block of the first axis {WAITS_FOR_6B}")

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and self.mesh == other.mesh
                and self.spec.normalized() == other.spec.normalized())

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    @property
    def is_replicated(self) -> bool:
        return self.num_shards == 1

    def shard_shape(self, shape) -> tuple:
        shape = tuple(shape)
        if self.is_replicated:
            return shape
        if shape[self.dim] % self.num_shards:
            raise ValueError(f"dim {self.dim} of {shape} does not split "
                             f"into {self.num_shards}")
        out = list(shape)
        out[self.dim] //= self.num_shards
        return tuple(out)

    def views(self, tensor: torch.Tensor) -> List[torch.Tensor]:
        """Each local shard's slice of a whole ``tensor``, as views (the
        reduce-scatter of a gradient, an entry's slice of a replicated
        parameter). Entries that differ only along axes the spec does
        not name share a shard."""
        if self.is_replicated:
            return [tensor]
        rows = self.shard_shape(tensor.shape)[self.dim]
        return [tensor.narrow(self.dim, i * rows, rows)
                for i in self.local_shards]

    def split(self, tensor: torch.Tensor) -> List[torch.Tensor]:
        """The local shards of a whole ``tensor`` as tensors of their
        own on the mesh's device."""
        device = self.mesh.device
        return [torch.empty(v.shape, dtype=v.dtype, device=device).copy_(v)
                for v in self.views(tensor)]

    def gather(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole tensor from the local shards (the all-gather: over
        the data group where other processes hold the rest)."""
        if self.is_replicated:
            return shards[0]
        local = torch.cat(list(shards), dim=self.dim)
        if len(self.local_shards) == self.num_shards:
            return local
        from elasticdl_tpu_torch.parallel import multihost

        return multihost.all_gather(local.movedim(self.dim, 0)).movedim(
            0, self.dim)


class ShardedTensor:
    """A leaf held per entry: one tensor a distinct local shard, in
    entry order (``NamedSharding.split``; across processes a process
    holds only its own). ``shape`` is the global shape. What a
    checkpoint or a resize needs of it is its whole value (``gather``)
    and a copy back into the live shards (``copy_``: a restore never
    rebinds a tensor)."""

    def __init__(self, sharding: NamedSharding, shards: List[torch.Tensor]):
        if len(shards) != len(sharding.local_shards):
            raise ValueError(f"{len(shards)} shards for {sharding}")
        self.sharding = sharding
        self.shards = list(shards)

    @classmethod
    def from_whole(cls, sharding: NamedSharding, tensor: torch.Tensor):
        return cls(sharding, sharding.split(tensor))

    @property
    def shape(self) -> tuple:
        shape = list(self.shards[0].shape)
        if self.sharding.dim is not None:
            shape[self.sharding.dim] *= self.sharding.num_shards
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
