"""Embedding kernels on the H100: hand-written CUDA lookups and row
updates in place of the Pallas ones.

Port of elasticdl_tpu/ops/pallas_embedding.py, whose file name it keeps
so a reader finds the counterpart. The four TPU kernels there become
four CUDA kernels here, built by ``_build`` at first use and called
through ``ctypes``:

- ``lookup_combine_pallas`` (``_lookup_kernel``, #6 of PERF.md's table)
  → ``lookup_kernel`` in ``csrc/embedding_lookup.cu``: fused gather +
  sum/mean/sqrtn combine, one warp per output row;
- ``lookup_combine_aligned`` (``_lookup_aligned_kernel``, #5) →
  ``lookup_aligned_kernel`` in the same file: the same contract, rows
  staged through shared memory with ``cp.async``;
- ``sparse_{sgd,momentum,adagrad,adam,adam_amsgrad}_update``
  (``_inplace_row_update``, #7) → ``row_update_kernel`` in
  ``csrc/embedding_row_update.cu``, one kernel templated on the rule;
- ``fused_{sgd,momentum}_scatter_apply`` (``_fused_row_update``, #8) →
  ``fused_row_update_kernel`` in the same file, 8 rows a block with all
  their loads issued before any row's math.

Beside each is its plain PyTorch version (``lookup_combine_reference``,
``row_update_reference``). A wrapper takes the plain version for tensors
on the CPU and launches its kernel for CUDA tensors, or raises: there is
no fallback from one to the other. Each kernel counts its launches in a
plain integer (``lookup_launches``, ``aligned_launches``,
``row_update_launches`` with ``row_update_rule_launches`` by rule,
``fused_launches``).

The row updates work IN PLACE on the (V, D) f32 table and its slot
tables, as the TPU kernels alias them (``input_output_aliases``), and
return the same tensors. Pad ids (>= V: the ``unique_pad`` fill) get no
read and no write.

What the Hopper kernels take is their own, not the TPU kernels' layout:
any batch and any width D (the (V·C, 128) flat view, the ``dim % 128``
gate, the 8-row batch padding and the DMA-ring depths were TPU tuning).
Auto-dispatch (``use_pallas_lookup``, ``use_pallas_apply``) returns
False, as in the JAX package: the kernels run where a caller pins them
(``force_pallas``, ``use_pallas="always"``/``"fused"``,
``Embedding(pallas=True)``); the port flips a default only on H100
measurements it records itself.
"""

import ctypes
from typing import Sequence

import numpy as np
import torch

from elasticdl_tpu_torch.embedding.combiner import COMBINERS, combine

_COMBINER_ID = {"sum": 0, "mean": 1, "sqrtn": 2}
RULES = ("sgd", "momentum", "adagrad", "adam", "amsgrad")
_RULE_ID = {rule: i for i, rule in enumerate(RULES)}
RULE_SLOTS = {"sgd": 0, "momentum": 1, "adagrad": 1, "adam": 2, "amsgrad": 3}
_LOOKUP_SOURCE = "embedding_lookup.cu"
_UPDATE_SOURCE = "embedding_row_update.cu"
_ALIGNED_SUB = 8   # the aligned lookup's vocab contract (V % 8 == 0)

# Kernel launches since the last reset (``reset_launches``).
lookup_launches = 0
aligned_launches = 0
row_update_launches = 0
row_update_rule_launches = {rule: 0 for rule in RULES}
fused_launches = 0


def reset_launches():
    global lookup_launches, aligned_launches, row_update_launches
    global fused_launches
    lookup_launches = aligned_launches = row_update_launches = 0
    fused_launches = 0
    for rule in RULES:
        row_update_rule_launches[rule] = 0


def dim_supported(dim: int) -> bool:
    """Every width: 16-byte lanes where D % 4 == 0, 4-byte ones else."""
    return int(dim) > 0


def use_pallas_lookup(dim: int, num_ids: int) -> bool:
    """Auto-dispatch of the lookup kernel: False (no H100 sweep of the
    port has shown a tier where it beats the library gather yet)."""
    del dim, num_ids
    return False


def use_pallas_apply(dim: int, num_rows: int) -> bool:
    """Auto-dispatch of the fused row-update kernel: False, as above."""
    del dim, num_rows
    return False


def _raise_on(err: int, lib, what: str):
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {err} "
            f"({lib.edl_cuda_error_string(err).decode()})"
        )


# ---- fused lookup + combine ----------------------------------------------


def _check_lookup(table, ids, weights, combiner):
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be one of {COMBINERS}")
    if table.dim() != 2 or ids.dim() != 2 or weights.shape != ids.shape:
        raise ValueError(
            f"lookup: table {tuple(table.shape)}, ids {tuple(ids.shape)}, "
            f"weights {tuple(weights.shape)}; the kernels take a (V, D) "
            "table and (B, L) ids and weights"
        )
    if not (table.device == ids.device == weights.device):
        raise ValueError("lookup: table, ids and weights on different "
                         "devices")
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"lookup: ids of dtype {ids.dtype}; int32 or int64")


def lookup_combine_reference(table, ids, weights, combiner: str):
    """Plain version of both lookup kernels: the L rows of each output
    row summed in id order in f32 (an id outside [0, V) reads as a zero
    row), the denominators likewise, then the normalisation."""
    table = table.float()
    ids = ids.long()
    weights = weights.float()
    vocab = table.shape[0]
    valid = (ids >= 0) & (ids < vocab)
    rows = torch.where(valid[..., None], table[ids.clamp(0, vocab - 1)], 0.0)
    acc = torch.zeros(ids.shape[0], table.shape[1], device=table.device)
    sum_w = torch.zeros(ids.shape[0], 1, device=table.device)
    sum_w2 = torch.zeros_like(sum_w)
    for slot in range(ids.shape[1]):
        w = weights[:, slot:slot + 1]
        acc = acc + w * rows[:, slot]
        sum_w = sum_w + w
        sum_w2 = sum_w2 + w * w
    if combiner == "sum":
        return acc
    denom = sum_w if combiner == "mean" else torch.sqrt(sum_w2)
    positive = denom > 0
    return torch.where(positive, acc / torch.where(positive, denom, 1.0),
                       0.0)


def _lookup_library():
    from elasticdl_tpu_torch.ops import _build

    lib = _build.load(_LOOKUP_SOURCE)
    if lib.edl_embedding_lookup.argtypes is None:
        for fn in (lib.edl_embedding_lookup,
                   lib.edl_embedding_lookup_aligned):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.edl_cuda_error_string.argtypes = [ctypes.c_int]
        lib.edl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _lookup_cuda(aligned: bool, table, ids, weights, combiner: str):
    """Launch one of the lookup kernels on the table's current stream."""
    global lookup_launches, aligned_launches
    _check_lookup(table, ids, weights, combiner)
    if table.device.type != "cuda":
        raise ValueError(f"lookup kernel: tensors on {table.device}")
    table = table.float().contiguous()
    ids = ids.to(torch.int32).contiguous()
    weights = weights.to(torch.float32).contiguous()
    batch, num_ids = ids.shape
    vocab, dim = table.shape
    out = torch.empty((batch, dim), dtype=torch.float32, device=table.device)
    if batch == 0 or num_ids == 0 or dim == 0:
        return out.zero_()           # nothing to gather: no launch
    lib = _lookup_library()
    fn = (lib.edl_embedding_lookup_aligned if aligned
          else lib.edl_embedding_lookup)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), ids.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), batch, num_ids, vocab, dim,
                 _COMBINER_ID[combiner], stream)
    _raise_on(err, lib, "embedding lookup")
    if aligned:
        aligned_launches += 1
    else:
        lookup_launches += 1
    return out


def lookup_combine_pallas(table, ids, weights, combiner: str):
    """(V, D) table, (B, L) int ids, (B, L) f32 weights -> (B, D) f32
    (kernel #6). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    _check_lookup(table, ids, weights, combiner)
    if table.device.type == "cpu":
        return lookup_combine_reference(table, ids, weights, combiner)
    return _lookup_cuda(False, table, ids, weights, combiner)


def lookup_combine_aligned(table, ids, weights, combiner: str):
    """The contract of ``lookup_combine_pallas`` for V % 8 == 0 (kernel
    #5, rows staged through shared memory); raises on V % 8 != 0."""
    if table.shape[0] % _ALIGNED_SUB:
        raise ValueError(
            f"aligned lookup needs vocab % {_ALIGNED_SUB} == 0, got "
            f"{table.shape[0]}"
        )
    _check_lookup(table, ids, weights, combiner)
    if table.device.type == "cpu":
        return lookup_combine_reference(table, ids, weights, combiner)
    return _lookup_cuda(True, table, ids, weights, combiner)


class _LookupCombine(torch.autograd.Function):
    """Kernel forward, reference-math backward (``_lookup_combine_diff``):
    d_table is the scatter-add of w·g (over the denominator) into a
    (V, D) gradient, d_weights the combine's own; both from autograd
    of the library gather + ``combine``, the same function."""

    @staticmethod
    def forward(ctx, table, ids, weights, combiner):
        out = lookup_combine_pallas(table, ids, weights, combiner)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[2]:
            ctx.save_for_backward(table, ids, weights)
        ctx.combiner = combiner
        return out

    @staticmethod
    def backward(ctx, grad):
        table, ids, weights = ctx.saved_tensors
        need_table, need_weights = ctx.needs_input_grad[0], \
            ctx.needs_input_grad[2]
        with torch.enable_grad():
            t = table.detach().requires_grad_(need_table)
            w = weights.detach().requires_grad_(need_weights)
            out = combine(t[ids.long()], w, ctx.combiner)
            inputs = [x for x in (t, w) if x.requires_grad]
            grads = iter(torch.autograd.grad(out, inputs, grad.float()))
        d_table = next(grads).to(table.dtype) if need_table else None
        d_weights = next(grads) if need_weights else None
        return d_table, None, d_weights, None


def lookup_combine(table, ids, weights, combiner: str,
                   force_pallas: bool = False, force_xla: bool = False):
    """Gather + combine with dispatch: the kernel where
    ``use_pallas_lookup`` says so (never, for now) or ``force_pallas``
    pins it, else the library route (gather, then ``combine``);
    ``force_xla`` pins the library route. Returns f32 either way;
    differentiable in the table and the weights."""
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be one of {COMBINERS}")
    if force_pallas and force_xla:
        raise ValueError("force_pallas and force_xla are exclusive")
    use_kernel = force_pallas or (
        not force_xla and use_pallas_lookup(table.shape[1], ids.shape[1]))
    if use_kernel:
        if not dim_supported(table.shape[1]):
            raise ValueError(f"lookup kernel: dim {table.shape[1]}")
        return _LookupCombine.apply(table, ids, weights, combiner)
    return combine(table[ids.long()], weights, combiner)


def lookup_combine_sharded(table, ids, weights, combiner: str, mesh,
                           axis: str, force_pallas: bool = False,
                           force_xla: bool = False):
    """Per-shard lookup over a row-sharded table: waits for the
    parallel slice of the port."""
    raise NotImplementedError(
        "lookup_combine_sharded (row-sharded tables) waits for the "
        "parallel slice of the port (torch.distributed)"
    )


# ---- in-place row updates --------------------------------------------------


def bias_corrections(beta1: float, beta2: float, step) -> tuple:
    """Adam's [1 - beta1^t, 1 - beta2^t] in f32 from the host step, as
    ``sparse_adam_update`` computes them on the device."""
    t = np.float32(step)
    return (float(np.float32(1) - np.float32(beta1) ** t),
            float(np.float32(1) - np.float32(beta2) ** t))


def _check_rows(rule, unique_ids, row_grads, tables):
    if len(tables) != 1 + RULE_SLOTS[rule]:
        raise ValueError(f"{rule}: {len(tables)} tables, not "
                         f"{1 + RULE_SLOTS[rule]}")
    shape = tables[0].shape
    if len(shape) != 2 or row_grads.dim() != 2 or unique_ids.dim() != 1:
        raise ValueError("row update: tables (V, D), ids (n,), grads "
                         "(n, D)")
    if (row_grads.shape != (unique_ids.shape[0], shape[1])
            or any(t.shape != shape for t in tables)):
        raise ValueError(
            f"row update: ids {tuple(unique_ids.shape)}, grads "
            f"{tuple(row_grads.shape)}, tables "
            f"{[tuple(t.shape) for t in tables]}"
        )
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in tables):
        raise ValueError("row update: tables must be contiguous float32 "
                         "(updated in place)")
    if len({t.device for t in (unique_ids, row_grads, *tables)}) != 1:
        raise ValueError("row update: inputs on different devices")


def row_update_reference(rule: str, unique_ids, row_grads,
                         tables: Sequence[torch.Tensor], lr=0.0,
                         momentum=0.0, nesterov=False, eps=0.0, beta1=0.0,
                         beta2=0.0, bc=(1.0, 1.0)):
    """Plain version of both row-update kernels, in place on ``tables``
    ([table, *slots]): ids outside [0, V) are left out."""
    vocab = tables[0].shape[0]
    ids = unique_ids.long()
    valid = (ids >= 0) & (ids < vocab)
    rows = ids[valid]
    g = row_grads.float()[valid]
    t = tables[0][rows]
    slots = [s[rows] for s in tables[1:]]
    if rule == "sgd":
        t = t - lr * g
    elif rule == "momentum":
        vel = momentum * slots[0] + g
        slots[0] = vel
        t = t - lr * (momentum * vel + g if nesterov else vel)
    elif rule == "adagrad":
        acc = slots[0] + g * g
        slots[0] = acc
        t = t - lr * g / (torch.sqrt(acc) + eps)
    else:
        m = beta1 * slots[0] + (1.0 - beta1) * g
        v = beta2 * slots[1] + (1.0 - beta2) * g * g
        slots[0], slots[1] = m, v
        m_hat = m / bc[0]
        v_hat = v / bc[1]
        if rule == "amsgrad":
            v_hat = torch.maximum(slots[2], v_hat)
            slots[2] = v_hat
        t = t - lr * m_hat / (torch.sqrt(v_hat) + eps)
    tables[0][rows] = t
    for table, new in zip(tables[1:], slots):
        table[rows] = new
    return tuple(tables)


def _update_library():
    from elasticdl_tpu_torch.ops import _build

    lib = _build.load(_UPDATE_SOURCE)
    if lib.edl_row_update.argtypes is None:
        lib.edl_row_update.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_float, ctypes.c_int]
            + [ctypes.c_float] * 7 + [ctypes.c_void_p])
        lib.edl_row_update.restype = ctypes.c_int
        lib.edl_fused_row_update.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.edl_fused_row_update.restype = ctypes.c_int
        lib.edl_cuda_error_string.argtypes = [ctypes.c_int]
        lib.edl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def row_update(rule: str, unique_ids, row_grads, tables, fused=False,
                lr=0.0, momentum=0.0, nesterov=False, eps=0.0, beta1=0.0,
                beta2=0.0, step=1):
    """Dispatch of the row kernels: the plain version for CPU tensors,
    else kernel #7 (or #8 with ``fused``) on the table's stream."""
    global row_update_launches, fused_launches
    tables = list(tables)
    _check_rows(rule, unique_ids, row_grads, tables)
    bc = (bias_corrections(beta1, beta2, step)
          if rule in ("adam", "amsgrad") else (1.0, 1.0))
    hyper = dict(lr=float(lr), momentum=float(momentum),
                 nesterov=bool(nesterov), eps=float(eps), beta1=float(beta1),
                 beta2=float(beta2))
    if tables[0].device.type == "cpu":
        return row_update_reference(rule, unique_ids, row_grads, tables,
                                    bc=bc, **hyper)
    if tables[0].device.type != "cuda":
        raise ValueError(f"row update: tensors on {tables[0].device}")
    ids = unique_ids.to(torch.int32).contiguous()
    grads = row_grads.to(torch.float32).contiguous()
    vocab, dim = tables[0].shape
    lib = _update_library()
    slot_ptrs = [t.data_ptr() for t in tables[1:]]
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        if fused:
            err = lib.edl_fused_row_update(
                _RULE_ID[rule], tables[0].data_ptr(),
                slot_ptrs[0] if slot_ptrs else None, ids.data_ptr(),
                grads.data_ptr(), ids.shape[0], vocab, dim, hyper["lr"],
                hyper["momentum"], int(hyper["nesterov"]), stream)
        else:
            slot_ptrs += [None] * (3 - len(slot_ptrs))
            err = lib.edl_row_update(
                _RULE_ID[rule], tables[0].data_ptr(), *slot_ptrs,
                ids.data_ptr(), grads.data_ptr(), ids.shape[0], vocab, dim,
                hyper["lr"], hyper["momentum"], int(hyper["nesterov"]),
                hyper["eps"], hyper["beta1"], hyper["beta2"],
                float(1.0 - hyper["beta1"]), float(1.0 - hyper["beta2"]),
                bc[0], bc[1], stream)
    _raise_on(err, lib, "fused row update" if fused else "row update")
    if fused:
        fused_launches += 1
    else:
        row_update_launches += 1
        row_update_rule_launches[rule] += 1
    return tuple(tables)


def sparse_sgd_update(table, unique_ids, row_grads, lr: float):
    """In place ``table[ids] -= lr * grads``; pad ids (>= V) are
    skipped: no read, no write."""
    (table,) = row_update("sgd", unique_ids, row_grads, [table], lr=lr)
    return table


def sparse_momentum_update(table, velocity, unique_ids, row_grads,
                           lr: float, momentum: float = 0.9,
                           nesterov: bool = False):
    """In place momentum SGD on (table, velocity); pads skipped."""
    return row_update("momentum", unique_ids, row_grads,
                      [table, velocity], lr=lr, momentum=momentum,
                      nesterov=nesterov)


def sparse_adagrad_update(table, accum, unique_ids, row_grads, lr: float,
                          epsilon: float = 1e-8):
    """In place Adagrad on (table, accum); pads skipped."""
    return row_update("adagrad", unique_ids, row_grads, [table, accum],
                      lr=lr, eps=epsilon)


def sparse_adam_update(table, m, v, unique_ids, row_grads, lr: float,
                       beta1: float = 0.9, beta2: float = 0.999,
                       epsilon: float = 1e-8, step=1):
    """In place Adam on (table, m, v); ``step`` is the 1-based host
    apply count for the bias corrections. Pads skipped (so a pad's m and
    v do not decay)."""
    return row_update("adam", unique_ids, row_grads, [table, m, v], lr=lr,
                      beta1=beta1, beta2=beta2, eps=epsilon, step=step)


def sparse_adam_amsgrad_update(table, m, v, max_v, unique_ids, row_grads,
                               lr: float, beta1: float = 0.9,
                               beta2: float = 0.999, epsilon: float = 1e-8,
                               step=1):
    """In place AMSGrad on (table, m, v, max_v): the max is taken over
    the bias-corrected v̂, which divides the step."""
    return row_update("amsgrad", unique_ids, row_grads,
                      [table, m, v, max_v], lr=lr, beta1=beta1, beta2=beta2,
                      eps=epsilon, step=step)


# ---- fused scatter-apply ---------------------------------------------------


class _FusedApply(torch.autograd.Function):
    """Autodiff-exempt wrapper of kernel #8 (``_fused_apply``): a defined
    forward, a backward that raises with a real message."""

    @staticmethod
    def forward(ctx, kind, hyper, unique_ids, row_grads, *tables):
        row_update(kind, unique_ids, row_grads, tables, fused=True, **hyper)
        ctx.mark_dirty(*tables)
        return tables

    @staticmethod
    def backward(ctx, *grads):
        raise ValueError(
            "fused scatter-apply is autodiff-exempt: it runs in the "
            "update phase on non-differentiated state; table gradients "
            "come from the lookup path (the combiner transpose in "
            "embedding/device_sparse._row_grads)"
        )


def fused_sgd_scatter_apply(table, unique_ids, row_grads, lr: float):
    """Kernel #8, SGD: in place ``table[ids] -= lr * grads`` with 8 rows'
    loads in flight a block; same contract as ``sparse_sgd_update``."""
    if not dim_supported(row_grads.shape[1]):
        raise ValueError(f"fused scatter-apply: dim {row_grads.shape[1]}")
    (table,) = _FusedApply.apply("sgd", {"lr": lr}, unique_ids, row_grads,
                                 table)
    return table


def fused_momentum_scatter_apply(table, velocity, unique_ids, row_grads,
                                 lr: float, momentum: float = 0.9,
                                 nesterov: bool = False):
    """Kernel #8, momentum (+Nesterov) on (table, velocity); contract of
    ``sparse_momentum_update``."""
    if not dim_supported(row_grads.shape[1]):
        raise ValueError(f"fused scatter-apply: dim {row_grads.shape[1]}")
    return _FusedApply.apply(
        "momentum", {"lr": lr, "momentum": momentum, "nesterov": nesterov},
        unique_ids, row_grads, table, velocity)
