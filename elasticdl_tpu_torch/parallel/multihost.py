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
- **Groups per mesh axis:** a mesh that spans processes
  (``parallel/mesh.py``) makes a ``Group`` for every set of its axes:
  the processes that share this one's block on every other axis, NCCL
  or gloo by their topology as the data group is chosen. The helpers
  below take one (default: the data group): the gradients' sums, the
  ``tp`` layers' all-reduces and logits gather
  (``parallel/tensor_parallel.py``), the ring's ``ring_shift``
  (send/recv), the pipeline's ``send``/``recv``/``broadcast``
  (``parallel/pipeline.py``), ZeRO's all-gather over the data axis, a split table's
  ids and rows.
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
          "devices": None, "topology": None, "data_group": None,
          "data_backend": None}
# Every process group made so far, by (member ranks, backend): a mesh
# asks for each group once, in the same order in every process
# (``Mesh`` builds its axis groups when it is made).
_groups = {}
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
    data_group = dist.new_group(backend=backend, timeout=TIMEOUT)
    _world.update(
        initialized=True, count=num_processes, index=process_id,
        device=device, devices=[torch.device(d) for _, d in topology],
        topology=topology, data_backend=backend, data_group=data_group)
    _groups[(tuple(range(num_processes)), backend)] = data_group
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
                  devices=None, topology=None, data_group=None,
                  data_backend=None)
    _groups.clear()


def side_group():
    """A gloo group over every process that no training step's
    collective uses (a background checkpoint write's), made by the
    first call, which every process makes at the same point
    (``new_group`` is collective), and kept until ``shutdown``."""
    key = (tuple(range(_world["count"])), "gloo", "side")
    if key not in _groups:
        _groups[key] = dist.new_group(backend="gloo", timeout=TIMEOUT)
    return _groups[key]


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


# ---- process groups --------------------------------------------------------


class Group:
    """Processes that run collectives together: ``ranks`` ascending
    (which is their order along the mesh axes the group spans: a process
    owns a block of the row-major grid, so a later block along an axis
    is a later process), the torch process group ``pg`` and its
    ``backend``, and ``cpu``, a gloo group over the same ranks for host
    values. A group of one process runs no collective."""

    def __init__(self, ranks, pg=None, backend="gloo", cpu=None):
        self.ranks = tuple(ranks)
        self.pg, self.backend, self.cpu = pg, backend, cpu

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def position(self) -> int:
        """This process's place in the group."""
        return self.ranks.index(process_index())

    def __repr__(self):
        return f"Group({list(self.ranks)}, {self.backend})"


def _backend_for(ranks) -> str:
    """``nccl`` where every member holds a CUDA device of its own, else
    gloo: the data group's choice, per group."""
    topology = [_world["topology"][r] for r in ranks]
    distinct = len(set(topology)) == len(topology)
    return ("nccl" if distinct and all(d.startswith("cuda")
                                       for _, d in topology) else "gloo")


def _process_group(ranks, backend):
    key = (ranks, backend)
    if key not in _groups:
        _groups[key] = dist.new_group(ranks=list(ranks), backend=backend,
                                      timeout=TIMEOUT)
    return _groups[key]


def make_group(ranks) -> Group:
    """The group of ``ranks``. Collective where it has two or more
    members: every process of the job makes the same groups in the same
    order (a process that skips or reorders one deadlocks the job), so
    ``Mesh`` makes all of its axis groups at once, when it is made; a
    group made before is reused."""
    ranks = tuple(sorted(int(r) for r in ranks))
    if len(ranks) < 2:
        return Group(ranks)
    backend = _backend_for(ranks)
    pg = _process_group(ranks, backend)
    cpu = pg if backend == "gloo" else _process_group(ranks, "gloo")
    return Group(ranks, pg, backend, cpu)


def data_group() -> Group:
    """Every process of the job: the default of the helpers below."""
    ranks = tuple(range(process_count()))
    if len(ranks) < 2:
        return Group(ranks)
    return Group(ranks, _world["data_group"], _world["data_backend"],
                 None)


# ---- the data-parallel step ------------------------------------------------


class GlobalBatch:
    """What a process-spanning step reads of the global batch, whose
    block this process's batch is: along the rows (the data axis) its
    block count and index, along the sequence (``sp``) the same, and
    sums over ``group``, the processes whose data differ (those that
    share every other axis's block: ``tp`` peers read the same data).
    A runner hands one to the train state and to the model's layers that
    read the global batch (``attach``); everything else sees None and
    stays local."""

    # The sequence's blocks: one unless the mesh splits it over
    # processes.
    seq_count, seq_index = 1, 0

    def __init__(self, mesh=None, data_axes=("dp", "sp")):
        self.count, self.index = process_count(), process_index()
        self.group = None
        if not hasattr(mesh, "block_of"):
            return
        rows_axis, seq_axis = data_axes
        self.count, self.index = mesh.block_of(rows_axis)
        self.seq_count, self.seq_index = mesh.block_of(seq_axis)
        self.group = mesh.group([a for a in data_axes if a in mesh.shape])

    def rows(self, local_rows: int):
        """``(global rows, this process's first row)`` of a
        batch-leading tensor of ``local_rows`` rows."""
        return local_rows * self.count, local_rows * self.index

    def seq(self, local_len: int):
        """``(global length, this process's first position)`` of a
        sequence of ``local_len`` positions."""
        return local_len * self.seq_count, local_len * self.seq_index

    def sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """The sum over the data group, differentiable
        (``AllReduceSum``)."""
        return AllReduceSum.apply(tensor, self.group)

    def sum_(self, tensors: Sequence[torch.Tensor]):
        """``all_reduce_``: summed in place, one collective a dtype."""
        return all_reduce_(tensors, group=self.group)

    def gather(self, tensor: torch.Tensor) -> torch.Tensor:
        """``all_gather``: every process's rows, in process order."""
        return all_gather(tensor, group=self.group)

    def host_sum(self, value: float) -> float:
        """The sum of a host number over the data group (its gloo
        twin)."""
        return host_sum(value, group=self.group)


def attach(state, mesh, data_axes=("dp", "sp")):
    """Give ``state`` and every module of its model with a
    ``global_batch`` attribute (BatchNorm, the dropout blocks) a
    ``GlobalBatch`` where ``mesh`` spans processes, else None. The
    runners call this wherever they make or place a state: the one
    place the decision is made. Returns ``state``. A ``torch.nn``
    BatchNorm, which has no such attribute and would normalise with its
    process's rows alone, raises where the mesh spans processes."""
    hook = (GlobalBatch(mesh, data_axes)
            if getattr(mesh, "spans_processes", False) else None)
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


def _staged(tensor: torch.Tensor, group: Group) -> bool:
    return tensor.is_cuda and group.backend == "gloo"


def all_reduce_(tensors: Sequence[torch.Tensor], op=dist.ReduceOp.SUM,
                group: Optional[Group] = None):
    """All-reduce ``tensors`` in place over ``group`` (default: the data
    group, every process): one collective per dtype, over a flat copy of
    them. Nothing happens on a group of one."""
    group = group or data_group()
    if group.size < 2:
        return tensors
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        buf = flat.cpu() if _staged(flat, group) else flat
        dist.all_reduce(buf, op=op, group=group.pg)
        if buf is not flat:
            flat.copy_(buf)
        offset = 0
        for t in same:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n
    return tensors


def all_reduce_sum(tensor: torch.Tensor,
                   group: Optional[Group] = None) -> torch.Tensor:
    """The sum of ``tensor`` over ``group`` (a new tensor)."""
    out = tensor.clone()
    all_reduce_([out], group=group)
    return out


def all_gather(tensor: torch.Tensor,
               group: Optional[Group] = None) -> torch.Tensor:
    """Every member's ``tensor`` concatenated along dim 0, in the
    group's order (default: the data group, process order)."""
    group = group or data_group()
    if group.size < 2:
        return tensor
    src = tensor.contiguous()
    buf = src.cpu() if _staged(src, group) else src
    parts = [torch.empty_like(buf) for _ in range(group.size)]
    dist.all_gather(parts, buf, group=group.pg)
    return torch.cat(parts).to(tensor.device)


def ring_shift(tensors: Sequence[torch.Tensor], group: Group
               ) -> List[torch.Tensor]:
    """Send ``tensors`` to the next member of ``group`` (in its order,
    round) and return those the previous member sent: one step of the
    ``sp`` ring across processes. NCCL groups take
    ``batch_isend_irecv``; gloo groups stage CUDA tensors through the
    host and pair an ``isend`` with an ``irecv`` a tensor, each under
    its own tag."""
    n, pos = group.size, group.position
    nxt, prv = group.ranks[(pos + 1) % n], group.ranks[(pos - 1) % n]
    staged = [t.cpu() if _staged(t, group) else t.contiguous()
              for t in tensors]
    got = [torch.empty_like(t) for t in staged]
    if group.backend == "nccl":
        ops = ([dist.P2POp(dist.isend, t, nxt, group.pg) for t in staged]
               + [dist.P2POp(dist.irecv, t, prv, group.pg) for t in got])
        requests = dist.batch_isend_irecv(ops)
    else:
        requests = []
        for tag, (out, into) in enumerate(zip(staged, got)):
            requests.append(dist.isend(out, nxt, group=group.pg, tag=tag))
            requests.append(dist.irecv(into, prv, group=group.pg, tag=tag))
    for request in requests:
        request.wait()
    return [g.to(t.device) for g, t in zip(got, tensors)]


def send(tensor: torch.Tensor, dst: int, group: Group, tag: int = 0):
    """Start sending ``tensor`` to process ``dst`` of ``group``; returns
    a handle whose ``wait()`` the caller must call (a gloo group stages
    a CUDA tensor through the host; the handle keeps that copy alive).
    The pipeline's activations and their gradients travel so
    (``parallel/pipeline.py``)."""
    out = tensor.cpu() if _staged(tensor, group) else tensor.contiguous()
    return _Pending(dist.isend(out, dst, group=group.pg, tag=tag), out)


def recv(shape, dtype, device, src: int, group: Group,
         tag: int = 0) -> torch.Tensor:
    """The tensor process ``src`` of ``group`` sends (``send``), on
    ``device``: blocks until it has arrived."""
    staged = group.backend == "gloo" and torch.device(device).type == "cuda"
    into = torch.empty(shape, dtype=dtype,
                       device="cpu" if staged else device)
    dist.recv(into, src, group=group.pg, tag=tag)
    return into.to(device)


def broadcast(tensor: torch.Tensor, src: int, group: Group) -> torch.Tensor:
    """``tensor`` of process ``src`` on every member of ``group`` (the
    others pass a tensor of the same shape and dtype to fill): a new
    tensor on ``tensor``'s device."""
    if group.size < 2:
        return tensor
    buf = (tensor.cpu() if _staged(tensor, group)
           else tensor.contiguous().clone())
    dist.broadcast(buf, src, group=group.pg)
    return buf.to(tensor.device)


class _Pending:
    """A started ``send``: ``wait()`` ends it."""

    def __init__(self, work, buffer):
        self._work, self._buffer = work, buffer

    def wait(self):
        self._work.wait()
        self._buffer = None


class AllReduceSum(torch.autograd.Function):
    """The sum over a group (default: the data group), differentiable:
    each process's output reads every member's input, so the gradient
    of an input is the sum of the outputs' gradients (the SyncBatchNorm
    idiom)."""

    @staticmethod
    def forward(ctx, tensor, group=None):
        ctx.group = group
        return all_reduce_sum(tensor, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


# ---- batches ---------------------------------------------------------------


def make_global_batch(batch, mesh):
    """This process's block of the global batch, placed on the mesh's
    device, where the step reads it: as in JAX, each local leaf is the
    process's shard under its sharding (``MeshRunner.batch_shardings``;
    JAX's version takes them to build global arrays, the port's steps
    read the blocks through ``GlobalBatch``). With one process this is
    the batch on the device. With several, a leaf split over axes that
    span processes is the process's block of them: token ids under
    ``P("dp", "sp")`` are its rows and its sequence block, and the
    global shape is the local one times the blocks along each split
    dim (``GlobalBatch.rows`` and ``seq``)."""
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


def host_sum(value: float, group: Optional[Group] = None) -> float:
    """The sum of a host number over ``group``'s gloo twin (default:
    every process, the CPU group)."""
    if group is None:
        if process_count() <= 1:
            return float(value)
        pg = None
    elif group.size < 2:
        return float(value)
    else:
        pg = group.cpu
    total = torch.tensor([float(value)], dtype=torch.float64)
    dist.all_reduce(total, group=pg)
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
