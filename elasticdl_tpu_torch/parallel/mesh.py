"""Device mesh (port of elasticdl_tpu/parallel/mesh.py).

A ``Mesh`` is a grid of ``torch.device`` entries with named axes, as
JAX's ``jax.sharding.Mesh`` is a grid of devices. Axis conventions:

- ``dp`` — data parallel (batch dimension),
- ``mp``/``tp`` — model/tensor parallel,
- ``sp`` — sequence/context parallel for long-context models.

The mesh is single-controller, as JAX's is: one process drives every
entry. In this slice every entry of a mesh is one and the same device,
the counterpart of JAX's virtual host devices (``[cuda:0] * 4``, or
``[cpu] * 4`` in the CPU tests): ``ring_attention`` then runs the ring's
real schedule on that device, shard by shard. Meshes over distinct
devices, and the sharding helpers (``replicated``, ``batch_sharding``,
``shard_leaf_over_axis``), wait for the parallel slice.
"""

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


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
    RuntimeError with none). Entries may repeat a device; in this slice
    they must all be the same one (NotImplementedError otherwise)."""
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
            " waits for the parallel slice (peer copies or NCCL between "
            "cards); every entry must be one device, e.g. "
            "[torch.device('cuda:0')] * 4"
        )
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(tuple(shape)), tuple(axes))
