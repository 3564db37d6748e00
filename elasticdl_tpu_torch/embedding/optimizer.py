"""Row optimizers: sparse updates of only the looked-up rows (port of
the device path of elasticdl_tpu/embedding/optimizer.py).

The update rules (SGD, Momentum with Nesterov, Adam with bias
correction, AMSGrad, Adagrad) follow the reference's parameter-server
kernels. ``sparse_apply`` updates the unique looked-up rows of an
HBM-resident (V, D) table and its slot tables IN PLACE and returns the
same tensors: through the hand-written row kernels
(``ops/pallas_embedding``) where ``use_pallas`` pins them, else through
the library route (gather, ``apply_rows``, scatter). The host tier's
``HostOptimizerWrapper`` and the checkpoint adapters wait for the
host-tier slice.
"""

from dataclasses import dataclass
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class RowOptimizer:
    """Per-row update rule. Slot tables are named by ``slot_names`` and
    start at ``slot_init_value``."""

    name: str = "sgd"
    lr: float = 0.01
    momentum: float = 0.0
    nesterov: bool = False
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    amsgrad: bool = False
    slot_names: Tuple[str, ...] = ()

    def apply_rows(self, rows, grads, slots: Dict[str, torch.Tensor], step):
        """(rows, slots) -> (new_rows, new_slots); ``step`` is the 1-based
        apply count used for Adam's bias correction."""
        raise NotImplementedError


@dataclass(frozen=True)
class SGD(RowOptimizer):
    name: str = "sgd"

    def apply_rows(self, rows, grads, slots, step):
        return rows - self.lr * grads, slots


@dataclass(frozen=True)
class Momentum(RowOptimizer):
    name: str = "momentum"
    momentum: float = 0.9
    slot_names: Tuple[str, ...] = ("momentum",)

    def apply_rows(self, rows, grads, slots, step):
        vel = self.momentum * slots["momentum"] + grads
        if self.nesterov:
            update = self.momentum * vel + grads
        else:
            update = vel
        return rows - self.lr * update, {"momentum": vel}


@dataclass(frozen=True)
class Adam(RowOptimizer):
    name: str = "adam"
    lr: float = 0.001
    slot_names: Tuple[str, ...] = ("m", "v")

    def __post_init__(self):
        if self.amsgrad and "max_v" not in self.slot_names:
            raise ValueError(
                "amsgrad needs the 'max_v' slot table: use AdamAmsgrad or "
                "make_row_optimizer('Adam', amsgrad=True)"
            )

    def apply_rows(self, rows, grads, slots, step):
        from elasticdl_tpu_torch.ops.pallas_embedding import (
            bias_corrections,
        )

        m = self.beta1 * slots["m"] + (1.0 - self.beta1) * grads
        v = self.beta2 * slots["v"] + (1.0 - self.beta2) * grads * grads
        new_slots = {"m": m, "v": v}
        bc1, bc2 = bias_corrections(self.beta1, self.beta2, step)
        m_hat = m / bc1
        v_hat = v / bc2
        if self.amsgrad:
            vmax = torch.maximum(slots["max_v"], v_hat)
            new_slots["max_v"] = vmax
            v_hat = vmax
        new_rows = rows - self.lr * m_hat / (torch.sqrt(v_hat) + self.epsilon)
        return new_rows, new_slots


@dataclass(frozen=True)
class AdamAmsgrad(Adam):
    amsgrad: bool = True
    slot_names: Tuple[str, ...] = ("m", "v", "max_v")


@dataclass(frozen=True)
class Adagrad(RowOptimizer):
    name: str = "adagrad"
    slot_names: Tuple[str, ...] = ("accumulator",)
    initial_accumulator: float = 0.1

    def apply_rows(self, rows, grads, slots, step):
        acc = slots["accumulator"] + grads * grads
        new_rows = rows - self.lr * grads / (torch.sqrt(acc) + self.epsilon)
        return new_rows, {"accumulator": acc}


_OPTIMIZERS = {
    "SGD": SGD,
    "sgd": SGD,
    "Momentum": Momentum,
    "momentum": Momentum,
    "Adam": Adam,
    "adam": Adam,
    "Adagrad": Adagrad,
    "adagrad": Adagrad,
}


def make_row_optimizer(opt_type: str, **kwargs) -> RowOptimizer:
    """Construction from a flag string (``--opt_type`` and its args)."""
    if opt_type in ("Adam", "adam") and kwargs.pop("amsgrad", False):
        return AdamAmsgrad(**kwargs)
    cls = _OPTIMIZERS.get(opt_type)
    if cls is None:
        raise ValueError(
            f"Unsupported row optimizer {opt_type!r}; "
            f"have {sorted(set(_OPTIMIZERS))}"
        )
    return cls(**kwargs)


def slot_init_value(opt: RowOptimizer, slot_name: str) -> float:
    if isinstance(opt, Adagrad) and slot_name == "accumulator":
        return opt.initial_accumulator
    return 0.0


def init_slot_tables(opt: RowOptimizer, vocab: int, dim: int,
                     dtype=torch.float32, device=None
                     ) -> Dict[str, torch.Tensor]:
    return {
        name: torch.full((vocab, dim), slot_init_value(opt, name),
                         dtype=dtype, device=device)
        for name in opt.slot_names
    }


# ---- device path: in-place row updates of an HBM-resident table -----------


def _kernel_rule(opt: RowOptimizer) -> str:
    """The row kernel's rule for ``opt``, or None where none covers it."""
    if isinstance(opt, Adam):
        return "amsgrad" if opt.amsgrad else "adam"
    for cls, rule in ((Adagrad, "adagrad"), (Momentum, "momentum"),
                      (SGD, "sgd")):
        if isinstance(opt, cls):
            return rule
    return None


def _pallas_sparse_apply(opt: RowOptimizer, table, slot_tables, unique_ids,
                         row_grads, step):
    """Kernel #7 for the rule of ``opt`` (callers guarantee
    ``kernelizable``)."""
    from elasticdl_tpu_torch.ops import pallas_embedding as pe

    rule = _kernel_rule(opt)
    slots = [slot_tables[name] for name in opt.slot_names]
    pe.row_update(rule, unique_ids, row_grads, [table] + slots, lr=opt.lr,
                  momentum=opt.momentum, nesterov=opt.nesterov,
                  eps=opt.epsilon, beta1=opt.beta1, beta2=opt.beta2,
                  step=step)
    return table, slot_tables


def _fused_sparse_apply(opt: RowOptimizer, table, slot_tables, unique_ids,
                        row_grads):
    """Kernel #8 (callers guarantee ``fused_apply_supported``)."""
    from elasticdl_tpu_torch.ops import pallas_embedding as pe

    if isinstance(opt, Momentum):
        pe.fused_momentum_scatter_apply(
            table, slot_tables["momentum"], unique_ids, row_grads,
            lr=opt.lr, momentum=opt.momentum, nesterov=opt.nesterov)
    else:
        pe.fused_sgd_scatter_apply(table, unique_ids, row_grads, lr=opt.lr)
    return table, slot_tables


def fused_apply_supported(opt: RowOptimizer, dim: int) -> bool:
    """Whether the fused kernel covers (opt, dim): SGD and Momentum
    (+Nesterov) at any width the kernels take. Where it does not,
    ``sparse_apply(use_pallas="fused")`` takes the library route without
    an error ("fuse where a kernel exists"), unlike "always"."""
    from elasticdl_tpu_torch.ops import pallas_embedding as pe

    return pe.dim_supported(dim) and _kernel_rule(opt) in ("sgd",
                                                           "momentum")


def kernelizable(opt: RowOptimizer, dim: int) -> bool:
    """Whether the row kernel covers (opt, dim): SGD, Momentum
    (+Nesterov), Adagrad, Adam and AMSGrad at any width the kernels
    take."""
    from elasticdl_tpu_torch.ops import pallas_embedding as pe

    return pe.dim_supported(dim) and _kernel_rule(opt) is not None


def _scatter_rows(dest, unique_ids, values, gathered):
    """``dest[unique_ids] = values`` in place, leaving pad ids (outside
    [0, V)) out, with no read-back of the ids to the host.

    torch has no "drop" scatter, and a boolean mask would need the count
    of real ids on the host. So every pad writes the row of one anchor
    id instead: the first real id, with that id's own new value, or,
    when there is no real id, its (clamped) row's old value. Duplicate
    writes of one row then carry the same bits, so the result is exact
    whichever lands last. ``gathered`` are the rows read at the clamped
    ids (the old values)."""
    vocab = dest.shape[0]
    valid = (unique_ids >= 0) & (unique_ids < vocab)
    anchor = torch.argmax(valid.to(torch.int8))   # first real id, else 0
    clamped = unique_ids.long().clamp(0, vocab - 1)
    pad_value = torch.where(valid[anchor], values[anchor], gathered[anchor])
    rows = torch.where(valid, clamped, clamped[anchor])
    dest.index_put_((rows,), torch.where(valid[:, None], values,
                                         pad_value.to(values.dtype)))


def sparse_apply(opt: RowOptimizer, table, slot_tables: Dict[str, torch.Tensor],
                 unique_ids, row_grads, step, use_pallas: str = "auto"):
    """Update only the ``unique_ids`` rows of a (V, D) table and its slot
    tables, in place; returns ``(table, slot_tables)`` (the same
    tensors).

    ``unique_ids`` must be deduplicated with padding set to an
    out-of-range id (``unique_pad(ids, fill_id=vocab)``): pads are read
    clamped (their gradients are zero, or ignored) and never written, so
    Adam's and Momentum's slots do not decay on a pad.

    ``use_pallas``: "auto" takes the library route unless
    ``use_pallas_apply`` (False for now) picks the fused kernel; "fused"
    takes kernel #8 where it exists (SGD, Momentum) and the library route
    elsewhere, without an error; "always" pins kernel #7 and raises up
    front where no kernel covers the optimizer; "never" pins the library
    route."""
    if use_pallas not in ("auto", "never", "always", "fused"):
        raise ValueError(f"use_pallas={use_pallas!r}")
    from elasticdl_tpu_torch.ops import pallas_embedding as pe

    dim = int(table.shape[1])
    if use_pallas == "fused" and fused_apply_supported(opt, dim):
        return _fused_sparse_apply(opt, table, slot_tables, unique_ids,
                                   row_grads)
    if (use_pallas == "auto" and fused_apply_supported(opt, dim)
            and pe.use_pallas_apply(dim, int(row_grads.shape[0]))):
        return _fused_sparse_apply(opt, table, slot_tables, unique_ids,
                                   row_grads)
    if use_pallas == "always":
        if not pe.dim_supported(dim):
            raise ValueError(f"use_pallas='always': no row kernel for "
                             f"dim={dim}")
        if not kernelizable(opt, dim):
            raise ValueError(
                f"use_pallas='always': no row kernel for "
                f"{type(opt).__name__} (kernelizable() is False)"
            )
        return _pallas_sparse_apply(opt, table, slot_tables, unique_ids,
                                    row_grads, step)
    clamped = unique_ids.long().clamp(0, table.shape[0] - 1)
    rows = table[clamped]
    slots = {name: slot_tables[name][clamped] for name in opt.slot_names}
    new_rows, new_slots = opt.apply_rows(rows, row_grads.to(rows.dtype),
                                         slots, step)
    _scatter_rows(table, unique_ids, new_rows, rows)
    for name in opt.slot_names:
        _scatter_rows(slot_tables[name], unique_ids, new_slots[name],
                      slots[name])
    return table, slot_tables


# ---- packed layout: slots beside their row in one wide table --------------
#
# The slot tables interleaved into the main table's rows, so the apply is
# one gather and one scatter of a wider row instead of (1 + n_slots) of
# each. Same update math, same touched-row contract; a forward lookup
# reads the wider row and narrows it to its first D columns.


def packed_width(opt: RowOptimizer, dim: int) -> int:
    return dim * (1 + len(opt.slot_names))


def pack_table(table, slot_tables: Dict[str, torch.Tensor],
               opt: RowOptimizer):
    """(V, D) main + per-slot (V, D) -> one (V, D*(1+n_slots)):
    [row | slot0 | slot1 | ...] in ``slot_names`` order."""
    return torch.cat([table] + [slot_tables[n] for n in opt.slot_names],
                     dim=1)


def unpack_table(packed, opt: RowOptimizer, dim: int):
    """Inverse of ``pack_table`` (views of ``packed``)."""
    table = packed[:, :dim]
    slots = {
        n: packed[:, dim * (i + 1): dim * (i + 2)]
        for i, n in enumerate(opt.slot_names)
    }
    return table, slots


def sparse_apply_packed(opt: RowOptimizer, packed, unique_ids, row_grads,
                        step, dim: int):
    """``sparse_apply``'s library route over a packed
    (V, D*(1+n_slots)) table, in place: one gather, the row update, one
    scatter. Returns ``packed``."""
    clamped = unique_ids.long().clamp(0, packed.shape[0] - 1)
    rows_packed = packed[clamped]
    rows, slots = unpack_table(rows_packed, opt, dim)
    new_rows, new_slots = opt.apply_rows(rows, row_grads.to(rows.dtype),
                                         slots, step)
    new_packed = pack_table(new_rows, new_slots, opt).to(packed.dtype)
    _scatter_rows(packed, unique_ids, new_packed, rows_packed)
    return packed


def unique_pad(ids, fill_id: int):
    """Static-shape dedup: the sorted distinct ids padded to ``ids``'s
    size with ``fill_id`` (pass the vocab size: an out-of-range pad, see
    ``sparse_apply``), and the inverse mapping each position of ``ids``
    to its slot (reshaped like ``ids``) — ``jnp.unique(size=,
    fill_value=, return_inverse=True)``.

    ``torch.unique`` has a data-dependent output size, so on CUDA it
    waits for the card; this is built from a sort instead and reads
    nothing back: a first-occurrence flag, its cumulative sum as each
    sorted id's slot, and a scatter of the sorted ids into a tensor of
    ``fill_id`` (duplicates write the same value)."""
    flat = ids.reshape(-1)
    sorted_ids, order = torch.sort(flat)
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    slot = torch.cumsum(first.to(torch.int32), 0) - 1
    uniq = torch.full_like(flat, fill_id)
    uniq.index_put_((slot.long(),), sorted_ids)
    inverse = torch.empty_like(slot)
    inverse[order] = slot
    return uniq, inverse.reshape(ids.shape)
