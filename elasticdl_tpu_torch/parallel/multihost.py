"""Multi-process data parallel over ``torch.distributed`` (port of
elasticdl_tpu/parallel/multihost.py).

The JAX package wires worker processes into one device mesh with
``jax.distributed`` and lets XLA route the collectives. The port does
it the torch way: one process per card, wired by
``torch.distributed.init_process_group``, and explicit collectives in
the steps that need them (``core/step.py``, ``parallel/zero.py``,
``models/batch_norm.py``, ``embedding/device_sparse.py``).

- ``initialize_multihost(coordinator, num_processes, process_id,
  device)`` starts the default group over ``tcp://<coordinator>`` (a
  ``file://`` or ``tcp://`` URL passes through), gloo on the CPU: it
  carries the barrier's integer codes, so no code ever travels through
  a device tensor. Then it gathers every process's (host, device) and
  makes the **data group**: ``nccl`` where every process holds a CUDA
  device of its own, ``gloo`` where they share one (two processes on
  ``cuda:0``: NCCL refuses two ranks on one device) or run on the CPU.
  The choice is made from that topology before the data group exists
  and is never changed afterwards; a failed collective fails its step.
  Under gloo, CUDA tensors are staged through the host by these
  helpers (one copy each way).
- **Data plane:** each worker keeps pulling its own tasks from the
  master. Its task batch is its process-local shard of the global
  batch along ``dp`` (``make_global_batch``): the global row count is
  the local one times the process count, and a step computes the
  global batch's loss and gradients: each process weighs its masked
  loss by its share of the global mask count, and the weighted losses
  and the gradients are all-reduced (``core/step.py``).
- **The global batch is explicit:** a runner whose mesh spans processes
  gives the train state and every layer of its model that reads the
  global batch a ``GlobalBatch`` (``attach``), as ``SyncBatchNorm``
  carries its process group: the step's loss and gradients, BatchNorm's
  statistics, dropout's draw and the sparse lookups ask it for the
  global batch. A state and model of one process hold None.
- **The barrier:** every process runs the same steps the same number
  of times. Per tick each announces a step code; the global max wins
  (``exchange_code``), and a process with nothing of that kind feeds a
  zero-mask dummy (``zero_mask_like``).

One process (every CI and CPU-test environment that does not start
several) is a no-op: the helpers fall through without a collective.
"""

import datetime
import socket
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("multihost")

# The process's wiring once ``initialize_multihost`` ran: world size,
# rank, its device, every process's device, the data group and its
# backend.
_world = {"initialized": False, "count": 1, "index": 0, "device": None,
          "devices": None, "data_group": None, "data_backend": None}
# How long the process group's set-up and a collective wait for a peer
# before they fail (torch's default for the gloo and NCCL groups).
TIMEOUT = datetime.timedelta(minutes=30)


def _init_method(coordinator_address: str) -> str:
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize_multihost(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    device=None,
) -> bool:
    """Wire this process into the job's process group. No-op (returns
    False) for a single process. Idempotent. ``device``: this process's
    device (default ``cuda:<process_id % cards>``; RuntimeError where
    the host has no card: the CPU is only had by asking for it)."""
    if num_processes <= 1:
        return False
    if _world["initialized"]:
        return True
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize_multihost: no CUDA device; pass device='cpu' "
                "to run the processes on the CPU")
        device = torch.device("cuda", process_id % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend="gloo", init_method=_init_method(coordinator_address),
        world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    topology = [None] * num_processes
    dist.all_gather_object(topology, (socket.gethostname(), str(device)))
    distinct = len(set(topology)) == num_processes
    backend = ("nccl" if distinct and all(
        dev.startswith("cuda") for _, dev in topology) else "gloo")
    _world.update(
        initialized=True, count=num_processes, index=process_id,
        device=device, devices=[torch.device(d) for _, d in topology],
        data_backend=backend,
        data_group=dist.new_group(backend=backend, timeout=TIMEOUT))
    logger.info(
        "torch.distributed initialized: process %d/%d on %s via %s; data "
        "group %s (%s)", process_id, num_processes, device,
        coordinator_address, backend,
        "a CUDA device a process" if backend == "nccl"
        else "processes share a device" if all(
            d.startswith("cuda") for _, d in topology) else "CPU")
    return True


def shutdown():
    """Leave the process group (at the end of a job's process)."""
    if _world["initialized"]:
        dist.destroy_process_group()
    _world.update(initialized=False, count=1, index=0, device=None,
                  devices=None, data_group=None, data_backend=None)


def coordinator_from_args(args) -> str:
    """The coordinator address. Several processes need an explicit
    ``--coordinator_addr`` (a resolvable host:port for process 0);
    guessing one would hang ``init_process_group`` on every worker."""
    explicit = getattr(args, "coordinator_addr", "")
    if explicit:
        return explicit
    if getattr(args, "num_jax_processes", 1) > 1:
        raise ValueError(
            "--coordinator_addr is required when --num_jax_processes > 1"
        )
    return ""


def process_count() -> int:
    return _world["count"]


def process_index() -> int:
    return _world["index"]


def local_device() -> Optional[torch.device]:
    """This process's device (None before ``initialize_multihost``)."""
    return _world["device"]


def process_devices() -> Optional[List[torch.device]]:
    """Every process's device, by process index."""
    return _world["devices"]


def data_backend() -> Optional[str]:
    """``"nccl"`` or ``"gloo"``: the data group's backend (None for one
    process)."""
    return _world["data_backend"]


# ---- the data-parallel step ------------------------------------------------


class GlobalBatch:
    """What a process-spanning step reads of the global batch, whose
    rows this process's batch is: its row count and this process's
    first row, and sums over the processes. A runner hands one to the
    train state and to the model's layers that read the global batch
    (``attach``); everything else sees None and stays local."""

    def __init__(self):
        self.count, self.index = process_count(), process_index()

    def rows(self, local_rows: int):
        """``(global rows, this process's first row)`` of a
        batch-leading tensor of ``local_rows`` rows."""
        return local_rows * self.count, local_rows * self.index

    @staticmethod
    def sum(tensor: torch.Tensor) -> torch.Tensor:
        """The sum over the data group, differentiable
        (``AllReduceSum``)."""
        return AllReduceSum.apply(tensor)

    @staticmethod
    def sum_(tensors: Sequence[torch.Tensor]):
        """``all_reduce_``: summed in place, one collective a dtype."""
        return all_reduce_(tensors)

    @staticmethod
    def gather(tensor: torch.Tensor) -> torch.Tensor:
        """``all_gather``: every process's rows, in process order."""
        return all_gather(tensor)

    @staticmethod
    def host_sum(value: float) -> float:
        """The sum of a host number over the CPU group."""
        return host_sum(value)


def attach(state, mesh):
    """Give ``state`` and every module of its model with a
    ``global_batch`` attribute (BatchNorm, the dropout blocks) a
    ``GlobalBatch`` where ``mesh`` spans processes, else None. The
    runners call this wherever they make or place a state: the one
    place the decision is made. Returns ``state``. A ``torch.nn``
    BatchNorm, which has no such attribute and would normalise with its
    process's rows alone, raises where the mesh spans processes."""
    hook = (GlobalBatch() if getattr(mesh, "spans_processes", False)
            else None)
    for module in state.model.modules():
        if hook is not None and isinstance(
                module, torch.nn.modules.batchnorm._BatchNorm):
            raise NotImplementedError(
                f"{type(module).__name__} across processes: its statistics "
                "would be this process's rows; use elasticdl_tpu_torch."
                "models.batch_norm.BatchNorm, which reads the global batch")
    state.global_batch = hook
    for module in state.model.modules():
        if hasattr(module, "global_batch"):
            module.global_batch = hook
    return state


def _staged(tensor: torch.Tensor) -> bool:
    return tensor.is_cuda and _world["data_backend"] == "gloo"


def all_reduce_(tensors: Sequence[torch.Tensor], op=dist.ReduceOp.SUM):
    """All-reduce ``tensors`` in place over the data group: one
    collective per dtype, over a flat copy of them."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        buf = flat.cpu() if _staged(flat) else flat
        dist.all_reduce(buf, op=op, group=_world["data_group"])
        if buf is not flat:
            flat.copy_(buf)
        offset = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n
    return tensors


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """The sum of ``tensor`` over the data group (a new tensor)."""
    out = tensor.clone()
    all_reduce_([out])
    return out


def all_gather(tensor: torch.Tensor) -> torch.Tensor:
    """Every process's ``tensor`` concatenated along dim 0, in process
    order."""
    src = tensor.contiguous()
    buf = src.cpu() if _staged(src) else src
    parts = [torch.empty_like(buf) for _ in range(process_count())]
    dist.all_gather(parts, buf, group=_world["data_group"])
    return torch.cat(parts).to(tensor.device)


class AllReduceSum(torch.autograd.Function):
    """The sum over the data group, differentiable: each process's
    output reads every process's input, so the gradient of an input is
    the sum of the outputs' gradients (the SyncBatchNorm idiom)."""

    @staticmethod
    def forward(ctx, tensor):
        return all_reduce_sum(tensor)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad)


# ---- batches ---------------------------------------------------------------


def make_global_batch(batch, mesh):
    """This process's batch as its rows of the global batch along the
    data axis (the leading dim), placed on the mesh's device, where the
    step reads it. With one process this is the batch on the device;
    with N the global row count is the local one times N
    (``global_batch_size``). JAX's version takes the batch's shardings
    too; the port's steps assume the leading dim over the data axis."""
    from elasticdl_tpu_torch.core.step import _to_device

    return _to_device(batch, mesh.device)


def global_batch_size(local_batch_size: int) -> int:
    return local_batch_size * process_count()


def host_local_slice(array):
    """This process's rows of a **leading-dim sharded** value, e.g.
    per-example predictions: a tensor is this process's rows already (a
    step computes its local rows); a ``ShardedTensor``'s local shards
    are joined in order, one copy of a replicated one. Sharding over a
    non-leading dim raises, as in JAX."""
    from elasticdl_tpu_torch.parallel.mesh import ShardedTensor

    if not isinstance(array, ShardedTensor):
        return array
    if array.sharding.dim not in (None, 0):
        raise ValueError(
            "host_local_slice supports leading-dim sharding only; got "
            f"spec {array.sharding.spec}")
    return torch.cat(array.shards) if array.sharding.dim == 0 \
        else array.shards[0]


# ---- the barrier -----------------------------------------------------------

# Step-type codes for the barrier: per tick every process announces what
# it wants to run; the global max wins, lower-priority processes feed a
# zero-mask dummy through the winning step and retry next tick. DONE vs
# IDLE matters for termination: IDLE means "no batch this tick but the
# job may still hand me one" (WAIT from the master, or a requeued task
# later); DONE means "the master told me the job is over". Ticking stops
# only on an all-DONE tick.
STEP_DONE = 0
STEP_IDLE = 1
STEP_TRAIN = 2
STEP_FORWARD = 3  # eval/predict (the forward-only step)


def exchange_code(mesh, code: int) -> int:
    """Global max() over the processes' step codes, over the CPU group:
    the step-alignment barrier for dynamic sharding. Every process calls
    this exactly once per tick; the returned code is the step ALL
    processes run this tick (0 = everyone done for good). One process:
    the code untouched."""
    if process_count() <= 1:
        return int(code)
    value = torch.tensor([int(code)], dtype=torch.int64)
    dist.all_reduce(value, op=dist.ReduceOp.MAX)
    return int(value[0])


def host_sum(value: float) -> float:
    """The sum of a host number over the processes (the CPU group)."""
    if process_count() <= 1:
        return float(value)
    total = torch.tensor([float(value)], dtype=torch.float64)
    dist.all_reduce(total)
    return float(total[0])


def exchange_continue(mesh, data_axis: str, local_flag: bool) -> bool:
    """Boolean barrier (no-more-batches-ever semantics): any process
    still stepping?"""
    return exchange_code(
        mesh, STEP_TRAIN if local_flag else STEP_DONE
    ) != STEP_DONE


def zero_mask_like(batch):
    """A dummy batch taking part in the collectives with zero loss
    weight: zeros everywhere (nested feature dicts too), mask strictly
    0."""
    if isinstance(batch, dict):
        return {key: zero_mask_like(value) for key, value in batch.items()}
    return np.zeros_like(np.asarray(batch))
