"""Ring attention: exact attention over a sequence-parallel mesh axis
(port of elasticdl_tpu/ops/ring_attention.py).

The sequence dimension is cut into ``n`` blocks over the ``sp`` axis of
a ``parallel.mesh.Mesh``. Rank ``idx`` keeps query block ``idx``; K/V
blocks go round the ring, and at step ``t`` rank ``idx`` folds chunk
``(idx - t) mod n`` into its running online-softmax state at global
positions ``q_off = idx * s_loc`` and ``k_off = chunk * s_loc``. A
process holds a run of the ring's ranks (all of them on one process,
every entry on one device, see ``parallel/mesh.py``), each with the
chunk it holds at that step: where JAX's ``ppermute`` rotates the
chunks, each local rank takes its left neighbour's, and the first takes
the previous process's last over the ``sp`` group
(``multihost.ring_shift``, send/recv; a list shift within a process).
The same schedule, the same calls and the same summation order, on one
card or across processes.

Two flavours, as in the JAX package:

- the kernel flavour: each chunk step is one call of
  ``flash_chunk_update`` (TPU kernel #2, ``csrc/flash_chunk_update.cu``
  on the card) and the backward is one reverse ring of
  ``flash_chunk_grads`` (#3/#4) from the saved logsumexp;
- the einsum flavour: the same math with whole score
  blocks (``_block_update``) and the fused reverse-ring backward
  (``_ring_local_bwd``). It runs on the CPU only.

In the backward, the dK/dV of a chunk sum their contributions in ring
order (rank ``c``, then ``c + 1``, ...): the accumulator travels round
the ring with its chunk, as in JAX's, and one more step takes it home.
Fully masked (rank, chunk) pairs are called like any other: the kernels
skip their tiles.

``dense_attention`` is the single-device reference and the fallback.
"""

from typing import Optional

import torch

from elasticdl_tpu_torch.ops.flash_attention import (
    HEAD_DIMS,
    flash_attention,
    flash_chunk_grads,
    flash_chunk_update,
    supports as flash_supports,
)
from elasticdl_tpu_torch.parallel import multihost
from elasticdl_tpu_torch.parallel.mesh import same_device

_NEG_INF = -1e30


def _to_bh(x):
    """(B, S, H, D) -> (B*H, S, D), contiguous: the kernels' layout."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _from_bh(x, b, h):
    """(B*H, S, D) -> (B, S, H, D)."""
    _, s, d = x.shape
    return x.reshape(b, h, s, d).transpose(1, 2)


def dense_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None, q_offset: int = 0):
    """q = (B, Sq, H, D), k/v = (B, Sk, H, D), Sk >= Sq allowed
    (``q_offset`` is q[:, 0]'s global position). The products take the
    input dtype; the softmax is f32 and p is cast to v's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        q_len, k_len = q.shape[1], k.shape[1]
        qpos = q_offset + torch.arange(q_len, device=q.device)[:, None]
        kpos = torch.arange(k_len, device=q.device)[None, :]
        s = s.masked_fill(qpos < kpos, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


class RingPlan:
    """The ``sp`` ring as a process sees it: ``n`` ranks, its own from
    ``first`` to ``first + local - 1`` (every rank on one process), and
    the ``group`` of processes that hold the others, in ring order."""

    def __init__(self, n: int, first: int = 0, local: Optional[int] = None,
                 group=None):
        self.n, self.first = n, first
        self.local = n if local is None else local
        self.group = group

    @classmethod
    def of(cls, mesh, sp_axis: str) -> "RingPlan":
        n = mesh.shape[sp_axis]
        if not mesh.spans_processes:
            return cls(n)
        lo, hi = mesh.axis_block(sp_axis)
        return cls(n, lo, hi - lo, mesh.group([sp_axis]))

    def steps(self):
        """``(t, slot, rank, chunk)``: at step t every local rank folds
        the chunk its slot holds, chunk (rank - t) mod n."""
        for t in range(self.n):
            for i in range(self.local):
                idx = self.first + i
                yield t, i, idx, (idx - t) % self.n

    def rotate(self, held):
        """One step of the ring over the slots' tuples of tensors: slot
        i takes slot i - 1's; slot 0 takes the previous process's last
        (its own last slot on one process)."""
        last = held[-1]
        if self.group is not None and self.group.size > 1:
            last = tuple(multihost.ring_shift(list(last), self.group))
        return [last] + held[:-1]


def _positions(idx, length, device):
    return idx * length + torch.arange(length, device=device)


# ---- einsum flavour -------------------------------------------------------


def _block_update(carry, q, k, v, qpos, kpos, causal, scale):
    """One online-softmax step against a single K/V block. carry: m, l
    (B, H, Sq) and o (B, Sq, H, D), all f32."""
    m, l, o = carry
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask, s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # exp(-1e30 - -1e30) is 1 for a fully masked row: zero the masked
    # entries instead of trusting the subtraction.
    p = torch.exp(s - m_new[..., None])
    if causal:
        p = torch.where(mask, p, 0.0)
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    o = o * alpha.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p.to(v.dtype), v).float()
    return m_new, l, o


def _fold_ring(plan, held, fold):
    """Run ``fold(slot, rank, chunk, held tuple) -> new held tuple``
    over the ring's steps, rotating the held tuples between steps;
    returns the held tuples after the last step."""
    for t, i, idx, c in plan.steps():
        held[i] = fold(i, idx, c, held[i])
        if i == plan.local - 1 and t < plan.n - 1:
            held = plan.rotate(held)
    return held


def _ring_attention_local(qs, ks, vs, causal, scale, plan=None):
    """Every local rank's forward: lists of (B, s_loc, H, D) blocks →
    lists of outputs (q's dtype) and logsumexps (B, H, s_loc, 1)."""
    plan = plan or RingPlan(len(qs))
    b, s_loc, h, d = qs[0].shape
    dev = qs[0].device
    carries = [(torch.full((b, h, s_loc), _NEG_INF, device=dev),
                torch.zeros((b, h, s_loc), device=dev),
                torch.zeros((b, s_loc, h, d), device=dev))
               for _ in qs]

    def fold(i, idx, c, kv):
        carries[i] = _block_update(
            carries[i], qs[i], kv[0], kv[1], _positions(idx, s_loc, dev),
            _positions(c, s_loc, dev), causal, scale)
        return kv

    _fold_ring(plan, list(zip(ks, vs)), fold)
    outs, lses = [], []
    for m, l, o in carries:
        l = l.clamp_min(1e-30)  # fully masked rows (none in a causal LM)
        outs.append((o / l.transpose(1, 2)[..., None]).to(qs[0].dtype))
        lses.append((m + torch.log(l))[..., None])
    return outs, lses


def _ring_local_bwd(qs, ks, vs, outs, lses, dos, causal, scale,
                    plan=None):
    """The fused reverse ring from the saved logsumexp, f32:

        P = exp(QKᵀ·scale − lse);  Δ = rowsum(dO ∘ O)
        dS = P ∘ (dO·Vᵀ − Δ);  dQ += dS·K·scale
        dK += dSᵀ·Q·scale;     dV += Pᵀ·dO

    dK and dV travel with their chunk and go home after the last step.
    """
    plan = plan or RingPlan(len(qs))
    b, s_loc, h, d = qs[0].shape
    dev = qs[0].device
    qf = [q.float() for q in qs]
    dof = [g.float() for g in dos]
    delta = [(g * o.float()).sum(dim=-1) for g, o in zip(dof, outs)]
    zeros = lambda: torch.zeros((b, s_loc, h, d), device=dev)  # noqa: E731
    dq = [zeros() for _ in qs]

    def fold(i, idx, c, held):
        kf, vf, dk, dv = held
        s = torch.einsum("bqhd,bkhd->bhqk", qf[i], kf) * scale
        p = torch.exp(s - lses[i])
        if causal:
            mask = (_positions(idx, s_loc, dev)[:, None]
                    >= _positions(c, s_loc, dev)[None, :])
            p = torch.where(mask, p, 0.0)
        dp = torch.einsum("bqhd,bkhd->bhqk", dof[i], vf)
        ds = p * (dp - delta[i].transpose(1, 2)[..., None])
        dq[i] = dq[i] + torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
        return (kf, vf,
                dk + torch.einsum("bhqk,bqhd->bkhd", ds, qf[i]) * scale,
                dv + torch.einsum("bhqk,bqhd->bkhd", p, dof[i]))

    held = _fold_ring(plan, [(k.float(), v.float(), zeros(), zeros())
                             for k, v in zip(ks, vs)], fold)
    home = plan.rotate([(dk, dv) for _, _, dk, dv in held])
    return dq, [x[0] for x in home], [x[1] for x in home]


# ---- kernel flavour -------------------------------------------------------


def _ring_local_kernel_fwd(qs, ks, vs, causal, scale, plan=None):
    """Every local rank's forward through ``flash_chunk_update``: lists
    of (B, s_loc, H, D) blocks → outputs (q's dtype) and logsumexps
    (B, H, s_loc, 1)."""
    plan = plan or RingPlan(len(qs))
    b, s_loc, h, d = qs[0].shape
    dev = qs[0].device
    qb = [_to_bh(x) for x in qs]
    carries = [(torch.full((b * h, s_loc, 1), _NEG_INF, device=dev),
                torch.zeros((b * h, s_loc, 1), device=dev),
                torch.zeros((b * h, s_loc, d), device=dev))
               for _ in qs]

    def fold(i, idx, c, kv):
        carries[i] = flash_chunk_update(
            qb[i], kv[0], kv[1], *carries[i], idx * s_loc, c * s_loc,
            causal=causal, scale=scale)
        return kv

    _fold_ring(plan, [(_to_bh(k), _to_bh(v)) for k, v in zip(ks, vs)],
               fold)
    outs, lses = [], []
    for m, l, acc in carries:
        l_safe = l.clamp_min(1e-30)
        outs.append(_from_bh(acc / l_safe, b, h).to(qs[0].dtype))
        lses.append((m + torch.log(l_safe)).reshape(b, h, s_loc, 1))
    return outs, lses


def _ring_local_kernel_bwd(qs, ks, vs, outs, lses, dos, causal, scale,
                           plan=None):
    """The reverse ring over ``flash_chunk_grads`` (kernels #3/#4 on the
    card); returns f32 (B, s_loc, H, D) lists dq, dk, dv."""
    plan = plan or RingPlan(len(qs))
    b, s_loc, h, d = qs[0].shape
    qb = [_to_bh(x) for x in qs]
    dob = [_to_bh(x) for x in dos]
    lse_b = [x.reshape(b * h, s_loc, 1) for x in lses]
    delta = [(g.float() * _to_bh(o).float()).sum(dim=-1, keepdim=True)
             for g, o in zip(dob, outs)]
    dq = [None] * len(qs)

    def fold(i, idx, c, held):
        k, v, dk, dv = held
        dq_p, dk_c, dv_c = flash_chunk_grads(
            qb[i], k, v, dob[i], lse_b[i], delta[i], idx * s_loc,
            c * s_loc, causal=causal, scale=scale)
        # 0 + x is x: starting from the first term is the zero-seeded sum.
        dq[i] = dq_p if dq[i] is None else dq[i] + dq_p
        return (k, v, dk_c if dk is None else dk + dk_c,
                dv_c if dv is None else dv + dv_c)

    held = _fold_ring(plan, [(_to_bh(k), _to_bh(v), None, None)
                             for k, v in zip(ks, vs)], fold)
    home = plan.rotate([(dk, dv) for _, _, dk, dv in held])
    return ([_from_bh(x, b, h) for x in grads] for grads in (
        dq, [x[0] for x in home], [x[1] for x in home]))


# flavour -> (forward, backward): "kernel" is ``_make_ring_local_pallas``
# (chunk-update forward, chunk-grads backward), "einsum" is
# ``_make_ring_local_jnp``.
_FLAVOURS = {
    "kernel": (_ring_local_kernel_fwd, _ring_local_kernel_bwd),
    "einsum": (_ring_attention_local, _ring_local_bwd),
}


class _Ring(torch.autograd.Function):
    """Ring forward and its fused reverse-ring backward over the plan's
    local sequence blocks (``RingPlan``). Saves q, k, v, o and the
    logsumexp (nothing when no input needs a gradient)."""

    @staticmethod
    def forward(ctx, q, k, v, plan, causal, scale, flavour):
        n = plan.local
        blocks = [x.chunk(n, dim=1) for x in (q, k, v)]
        outs, lses = _FLAVOURS[flavour][0](*blocks, causal, scale, plan)
        out = torch.cat(outs, dim=1)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v, out, torch.cat(lses, dim=2))
        ctx.config = (plan, causal, scale, flavour)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        plan, causal, scale, flavour = ctx.config
        n = plan.local
        blocks = [x.chunk(n, dim=1) for x in (q, k, v, out, grad)]
        lses = [x.contiguous() for x in lse.chunk(n, dim=2)]
        dq, dk, dv = _FLAVOURS[flavour][1](*blocks[:4], lses, blocks[4],
                                           causal, scale, plan)
        return (torch.cat(dq, dim=1).to(q.dtype),
                torch.cat(dk, dim=1).to(k.dtype),
                torch.cat(dv, dim=1).to(v.dtype), None, None, None, None)


def _unsupported(q):
    return NotImplementedError(
        f"attention on {q.device}: the kernels take head dims {HEAD_DIMS} "
        f"in bfloat16 or float32, got {q.shape[-1]} in {q.dtype}"
    )


def ring_attention(q, k, v, mesh, sp_axis: str = "sp",
                   dp_axis: Optional[str] = "dp",
                   tp_axis: Optional[str] = "tp", causal: bool = True,
                   scale: Optional[float] = None,
                   use_pallas: Optional[bool] = None):
    """Exact attention with the sequence dim cut over ``sp_axis``.

    q, k, v: (B, S, H, D) on the mesh's device, S this process's block of
    the sequence (the whole of it on one process); returns
    (B, S, H, D).
    ``dp_axis`` and ``tp_axis`` are accepted and change nothing on a
    one-device mesh (JAX replicates an axis that does not divide).

    ``use_pallas``: None takes the kernel flavour whenever the local
    block passes ``flash_attention.supports`` (on either device; on the
    CPU the kernels' plain versions), True forces it, False takes the
    einsum flavour (the CPU only). A mesh with no ``sp`` axis, ``sp`` of
    size 1, or an ``sp`` that does not divide S falls back to
    ``dense_attention`` on the CPU and to ``flash_attention`` on the
    card. On the card attention runs a kernel or raises
    NotImplementedError."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not same_device(q.device, mesh.device):
        raise ValueError(
            f"ring_attention: tensors on {q.device}, mesh on {mesh.device}")
    b, s, h, d = q.shape
    n = mesh.shape.get(sp_axis, 1)
    on_cpu = q.device.type == "cpu"
    plan = RingPlan.of(mesh, sp_axis) if n > 1 else None
    if plan is not None and plan.local < n:
        if s % plan.local:
            raise ValueError(
                f"a sequence block of {s} over {plan.local} local sp ranks")
        n = plan.local
    if plan is None or (plan.local == n and s % n != 0):
        if on_cpu:
            return dense_attention(q, k, v, causal=causal, scale=scale)
        if not flash_supports(q.shape, q.dtype):
            raise _unsupported(q)
        return flash_attention(q, k, v, causal=causal, scale=scale)
    if use_pallas is None:
        use_pallas = flash_supports((b, s // n, h, d), q.dtype)
    if not use_pallas and not on_cpu:
        raise _unsupported(q)
    return _Ring.apply(q, k, v, plan, causal, float(scale),
                       "kernel" if use_pallas else "einsum")
