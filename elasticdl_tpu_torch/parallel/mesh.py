"""Device mesh (port of elasticdl_tpu/parallel/mesh.py).

A ``Mesh`` is a grid of ``torch.device`` entries with named axes, as
JAX's ``jax.sharding.Mesh`` is a grid of devices. Axis conventions:

- ``dp`` — data parallel (batch dimension),
- ``mp``/``tp`` — model/tensor parallel,
- ``sp`` — sequence/context parallel for long-context models.

The mesh is single-controller, as JAX's is: one process drives every
entry. Every entry of a mesh is one and the same device, the
counterpart of JAX's virtual host devices (``[cuda:0] * 4``, or
``[cpu] * 4`` in the CPU tests): ``ring_attention`` runs the ring's
real schedule on that device, shard by shard, and a leaf that JAX
places per device is held as one tensor per entry (``ShardedTensor``).

``NamedSharding(mesh, spec)`` is where data crosses between entries,
and the only place: ``views`` gives each entry its slice of a whole
tensor, ``split`` copies the slices into tensors of their own, and
``gather`` joins them. On the one device these are ``narrow``,
``narrow`` + ``clone`` and ``cat``; over distinct cards they become
peer copies and collectives (ROADMAP Queue 1, item 6b), which is why a
mesh over distinct devices still raises.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticdl_tpu_torch.parallel.rules import PartitionSpec

WAITS_FOR_6B = "waits for ROADMAP Queue 1 item 6b (the multi-device mesh)"


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
    ``mesh.shape``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"mesh of {devices.ndim} dims with axes {axis_names}"
            )
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device(self) -> torch.device:
        """The one device every entry names."""
        return self.devices.flat[0]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __eq__(self, other):
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and list(self.devices.flat) == list(other.devices.flat))

    def __hash__(self):
        return hash((self.axis_names, self.devices.shape,
                     tuple(map(str, self.devices.flat))))

    def __repr__(self):
        return f"Mesh({self.shape}, {self.device})"


def _local_devices():
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
    """A mesh of ``shape`` over ``devices`` (default: every CUDA device,
    RuntimeError with none). Entries may repeat a device; they must all
    be the same one (NotImplementedError otherwise: item 6b)."""
    devices = [torch.device(d) for d in (
        devices if devices is not None else _local_devices())]
    if shape is None:
        shape = (len(devices),)
        axes = tuple(axes[:1]) or ("dp",)
    size = int(np.prod(shape))
    if size != len(devices):
        raise ValueError(
            f"Mesh shape {tuple(shape)} needs {size} devices, "
            f"have {len(devices)}"
        )
    if not all(same_device(d, devices[0]) for d in devices):
        raise NotImplementedError(
            f"a mesh over distinct devices {sorted(set(map(str, devices)))}"
            f" {WAITS_FOR_6B}: peer copies or NCCL between cards; every "
            "entry must be one device, e.g. [torch.device('cuda:0')] * 4"
        )
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(tuple(shape)), tuple(axes))


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
        self.num_shards = 1
        for a in (_axes(split[0][1]) if split else ()):
            self.num_shards *= mesh.shape[a]

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
        """Each distinct shard's slice of a whole ``tensor``, as views
        (the reduce-scatter of a gradient, an entry's slice of a
        replicated parameter). Entries that differ only along axes the
        spec does not name share a shard."""
        if self.is_replicated:
            return [tensor]
        rows = self.shard_shape(tensor.shape)[self.dim]
        return [tensor.narrow(self.dim, i * rows, rows)
                for i in range(self.num_shards)]

    def split(self, tensor: torch.Tensor) -> List[torch.Tensor]:
        """The shards of a whole ``tensor`` as tensors of their own on
        the mesh's device."""
        device = self.mesh.device
        return [torch.empty(v.shape, dtype=v.dtype, device=device).copy_(v)
                for v in self.views(tensor)]

    def gather(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole tensor from its shards (the all-gather)."""
        if self.is_replicated:
            return shards[0]
        return torch.cat(list(shards), dim=self.dim)


class ShardedTensor:
    """A leaf held per entry: one tensor a distinct shard, in entry
    order (``NamedSharding.split``). What a checkpoint or a resize
    needs of it is its whole value (``gather``) and a copy back into the
    live shards (``copy_``: a restore never rebinds a tensor)."""

    def __init__(self, sharding: NamedSharding, shards: List[torch.Tensor]):
        if len(shards) != sharding.num_shards:
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
