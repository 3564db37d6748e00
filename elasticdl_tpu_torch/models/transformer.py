"""Decoder-only transformer LM (port of elasticdl_tpu/models/transformer.py).

Parameters are f32, as in the flax module; every product casts its
input and weight to ``compute_dtype`` at use and rounds where flax
rounds:

- ``Dense``: input and weight in the compute dtype, bias added in the
  compute dtype (flax ``Dense``/``DenseGeneral(dtype=...)``).
- ``LayerNorm``: epsilon 1e-6, statistics and normalization in f32
  (mean of x and of x², as flax's fast variance), then the compute
  dtype.
- GELU is the tanh approximation (flax ``nn.gelu``).
- Token and position embeddings are cast before their sum; logits are
  computed in the compute dtype and returned as f32.

Attention takes ``flash_attention`` whenever its static gate accepts
the shape (on either device; any sequence length, head dims 16, 32, 64
and 128). Otherwise a CPU tensor takes ``dense_attention`` and a CUDA
tensor raises: on the card attention runs the kernel or nothing; its
backward is the flash backward kernels. Built with a mesh
(``TransformerLM(cfg, mesh)``, ``parallel.mesh.Mesh``), attention is
``ring_attention`` over the mesh's ``sp`` axis, as in the JAX module;
its sharding constraints are not ported: placement is the runner's.
Where the mesh's ``sp`` spans processes, a process's tokens are its
block of the sequence, so its positions start at the block's offset.

Tensor parallel (``transformer_sharding_rules`` through a
``MeshRunner``, which records each placement on its module,
``parallel/tensor_parallel.placement``): Q/K/V and ``wi`` are
column-parallel, ``out`` and ``wo`` row-parallel (Megatron), the token
embedding and ``lm_head`` split over the vocabulary. A layer computes
each local ``tp`` entry's share in turn (an unplaced layer is one
entry, ``tensor_parallel.WHOLE``): entry e takes the
e-th block of whole heads (``n_heads % tp == 0``) through attention
(the flash kernels, or the ring per entry), the entries' partial
products of a row-parallel layer are summed and then all-reduced over
the ``tp`` group, and its bias is added once, after the sum. Inputs of
column-parallel layers pass ``copy_to``, the vocabulary-split logits are
gathered over ``tp`` (``gather_last``) so the zoo's loss reads them
whole. On one process the collectives are the identity.

Training (``model.train()``): dropout after attention and after the
MLP of each block, as flax ``Dropout`` does (keep where u >= rate,
scale by 1/(1 - rate)), with u drawn on the tokens' device from a
generator seeded per block from the caller's CPU ``torch.Generator``
(``forward(tokens, generator=...)``): the train state's generator, so
a run is reproducible from its seed. ``remat`` recomputes each block
in the backward (``torch.utils.checkpoint``, non-reentrant); the
block's seed is drawn outside the checkpointed function, so the
recompute draws the same masks (and, with a mesh, recomputes the ring
forward and routes each token as the forward did).

Mixture of experts (``moe_experts > 0``): every ``moe_every``-th block
holds ``MoE`` in place of ``Mlp``, routed top-k with a dense or a
capacity-scatter dispatch, the experts placed over ``ep`` (and their
hidden dim over ``tp``) by the rules. ``fused_head`` makes a training
forward return ``(hidden, kernel, bias)`` for
``ops.losses.fused_next_token_cross_entropy`` instead of the logits.
``generate`` decodes with a ``KVCache``: the prompt in one pass, then
one token a step.
"""

import contextlib
import dataclasses
import math
from dataclasses import dataclass

from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from elasticdl_tpu_torch.common import dtypes
from elasticdl_tpu_torch.ops.flash_attention import (
    HEAD_DIMS,
    flash_attention,
    supports as flash_supports,
)
from elasticdl_tpu_torch.ops.ring_attention import (
    dense_attention,
    ring_attention,
)
from elasticdl_tpu_torch.parallel import tensor_parallel as tp


def transformer_sharding_rules():
    """Name regex -> PartitionSpec, in priority order (first match
    wins), as the JAX module's rules: Megatron column/row-parallel
    attention and MLP, vocab over ``tp``. Written for the port's
    layouts (a torch ``Linear`` weight is (out, in), where flax's kernel
    is (in, out) or (d, H, Dh)), so each places the same dim as the JAX
    rule. ``regex_param_rule`` fits them to the mesh: on a dp-only mesh
    every parameter replicates."""
    from elasticdl_tpu_torch.parallel.rules import PartitionSpec as P

    return (
        (r"attn/(query|key|value)/weight", P("tp", None)),
        (r"attn/(query|key|value)/bias", P("tp")),
        (r"attn/out/weight", P(None, "tp")),
        (r"mlp/wi/weight", P("tp", None)),
        (r"mlp/wi/bias", P("tp")),
        (r"mlp/wo/weight", P(None, "tp")),
        # The experts keep flax's layout, (E, d, F) and (E, F, d): the
        # JAX rules apply unchanged.
        (r"moe/wi", P("ep", None, "tp")),
        (r"moe/wo", P("ep", "tp", None)),
        (r"token_embed/weight", P("tp", None)),
        (r"lm_head/weight", P("tp", None)),
        (r"lm_head/bias", P("tp")),
    )


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 256
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 512
    max_len: int = 512
    dropout_rate: float = 0.0
    moe_experts: int = 0        # 0 = dense MLP in every block
    moe_top_k: int = 1          # experts combined per token (renormed)
    moe_every: int = 2          # MoE replaces the MLP in every k-th block
    moe_dispatch: str = "dense"     # or "scatter" (capacity-based)
    moe_capacity_factor: float = 1.25
    remat: bool = False
    compute_dtype: torch.dtype = torch.bfloat16
    # A training forward returns (hidden, kernel, bias) for the chunked
    # fused loss instead of the (B, S, V) logits.
    fused_head: bool = False

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["compute_dtype"] = dtypes.dtype_name(self.compute_dtype)
        return out

    @classmethod
    def from_dict(cls, raw: dict) -> "TransformerConfig":
        raw = dict(raw)
        if "compute_dtype" in raw:
            raw["compute_dtype"] = dtypes.torch_dtype(raw["compute_dtype"])
        return cls(**raw)


def _linear(x, weight, bias, dtype):
    """flax ``Dense``'s rounding: x and W in ``dtype``, then the bias
    (where given) added in ``dtype``; over a whole weight or one entry's
    shard of it."""
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


class Dense(nn.Linear):
    """``nn.Linear`` with flax's rounding (``_linear``)."""

    def __init__(self, in_features, out_features, dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x):
        return _linear(x, self.weight, self.bias, self.compute_dtype)


class _PlacedDense(Dense):
    """A ``Dense`` of a tensor-parallel layer: the layer reads its
    placement (``tensor_parallel.entry_views``), not its forward."""

    reads_placed = True


class LayerNorm(nn.Module):
    def __init__(self, dim, dtype, eps=1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.compute_dtype = dtype
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True)
               - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(self.compute_dtype)


def _column_row(first, last):
    """The ``tp`` placement of a column-parallel ``first`` feeding a
    row-parallel ``last`` (Megatron: ``first``'s weight rows and bias
    split, ``last``'s weight columns split alike, its bias whole), or
    ``WHOLE`` where the runner placed neither. A half-placed pair
    raises."""
    col = tp.split_over(first, "weight", 0)
    row = tp.split_over(last, "weight", 1)
    bias = tp.split_over(first, "bias", 0)
    if (col is None or row is None or bias is None
            or not col.axes_of(0) == bias.axes_of(0) == row.axes_of(1)
            or tp.placement(last, "bias") is not tp.WHOLE):
        raise NotImplementedError(
            "a tensor-parallel pair needs its first weight split by rows "
            "(and its bias), its second by columns over the same axis, "
            f"and the second's bias whole: got {col}, {bias}, {row}")
    return col


class SelfAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        inner = cfg.n_heads * cfg.head_dim
        self.query = _PlacedDense(cfg.d_model, inner, cfg.compute_dtype)
        self.key = _PlacedDense(cfg.d_model, inner, cfg.compute_dtype)
        self.value = _PlacedDense(cfg.d_model, inner, cfg.compute_dtype)
        self.out = _PlacedDense(inner, cfg.d_model, cfg.compute_dtype)

    def _attend(self, q, k, v):
        scale = self.cfg.head_dim ** -0.5
        if self.mesh is not None:
            return ring_attention(q, k, v, self.mesh, causal=True,
                                  scale=scale)
        if flash_supports(q.shape, q.dtype):
            return flash_attention(q, k, v, causal=True, scale=scale)
        if q.device.type == "cpu":
            return dense_attention(q, k, v, causal=True, scale=scale)
        raise NotImplementedError(
            f"attention on {q.device}: the flash kernel takes head "
            f"dims {HEAD_DIMS} in bfloat16 or float32, got "
            f"{self.cfg.head_dim} in {q.dtype}"
        )

    def forward(self, x, cache=None, layer: int = 0):
        """``cache`` (a ``KVCache``): the decode step of layer
        ``layer``."""
        if cache is not None:
            return self._decode_step(x, cache, layer)
        cfg = self.cfg
        b, s, _ = x.shape
        split = _column_row(self.query, self.out)
        if cfg.n_heads % split.num_shards:
            raise ValueError(
                f"{cfg.n_heads} heads over {split.num_shards} tp entries: "
                "heads split whole")
        if any(_column_row(dense, self.out) != split
               for dense in (self.key, self.value)):
            raise NotImplementedError(
                "query, key and value are placed alike or not at all")
        group = split.group()
        x = tp.copy_to(x, group)
        heads = cfg.n_heads // split.num_shards
        shape = (b, s, heads, cfg.head_dim)
        dt = cfg.compute_dtype
        qkv = [(tp.entry_views(d, "weight"), tp.entry_views(d, "bias"))
               for d in (self.query, self.key, self.value)]
        outs = tp.entry_views(self.out, "weight")
        y = None
        for e, w_out in enumerate(outs):
            q, k, v = (_linear(x, w[e], bias[e], dt).view(shape)
                       for w, bias in qkv)
            o = self._attend(q, k, v).reshape(b, s, heads * cfg.head_dim)
            part = _linear(o, w_out, None, dt)
            y = part if y is None else y + part
        return tp.reduce_from(y, group) + self.out.bias.to(dt)

    def _decode_step(self, x, cache, layer):
        """KV-cache decoding (JAX's ``_decode_step``): the new tokens'
        K and V are written into the cache in place at its fill index,
        and the queries attend over the whole cache through
        ``dense_attention`` with ``q_offset`` at the fill index, whose
        causal mask also hides the slots still empty. This is the JAX
        package's own decode path, which reaches no Pallas kernel; it is
        no fallback from the flash kernel. Runs unsharded."""
        cfg = self.cfg
        if self.mesh is not None or any(
                tp.placement(d, "weight") is not tp.WHOLE
                for d in (self.query, self.key, self.value, self.out)):
            raise NotImplementedError(
                "decode runs unsharded (as JAX's generate, mesh=None)")
        b, t, _ = x.shape
        idx = cache.index
        cache.check_room(t)
        shape = (b, t, cfg.n_heads, cfg.head_dim)
        q, k, v = (d(x).view(shape)
                   for d in (self.query, self.key, self.value))
        cache_k, cache_v = cache.k[layer], cache.v[layer]
        cache_k[:, idx:idx + t] = k
        cache_v[:, idx:idx + t] = v
        o = dense_attention(q, cache_k, cache_v, causal=True,
                            scale=cfg.head_dim ** -0.5, q_offset=idx)
        return self.out(o.reshape(b, t, cfg.n_heads * cfg.head_dim))


class Mlp(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.wi = _PlacedDense(cfg.d_model, cfg.d_ff, cfg.compute_dtype)
        self.wo = _PlacedDense(cfg.d_ff, cfg.d_model, cfg.compute_dtype)

    def forward(self, x):
        group = _column_row(self.wi, self.wo).group()
        x = tp.copy_to(x, group)
        dt = self.wo.compute_dtype
        y = None
        for w_in, b_in, w_out in zip(tp.entry_views(self.wi, "weight"),
                                     tp.entry_views(self.wi, "bias"),
                                     tp.entry_views(self.wo, "weight")):
            h = F.gelu(_linear(x, w_in, b_in, dt), approximate="tanh")
            part = _linear(h, w_out, None, dt)
            y = part if y is None else y + part
        return tp.reduce_from(y, group) + self.wo.bias.to(dt)


@contextlib.contextmanager
def _strict_f32():
    """f32 products in full f32 precision (no TF32), whatever the
    caller's setting."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


class _StrictLinear(torch.autograd.Function):
    """``F.linear`` in f32 with TF32 off, forward and backward: the
    router's logits decide each token's expert, and a TF32 product
    could route a near-tie differently from the CPU."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        with _strict_f32():
            return F.linear(x, weight, bias)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        flat = grad.reshape(-1, grad.shape[-1])
        with _strict_f32():
            grad_x = grad @ weight
            grad_w = flat.t() @ x.reshape(-1, x.shape[-1])
        return grad_x, grad_w, flat.sum(0)


class Router(Dense):
    """The MoE router: flax ``Dense(E, dtype=float32)`` on ``x`` in f32,
    its product in strict f32 (``_StrictLinear``)."""

    def __init__(self, in_features, out_features):
        super().__init__(in_features, out_features, torch.float32)

    def forward(self, x):
        return _StrictLinear.apply(x.float(), self.weight, self.bias)


def capacity(tokens: int, k: int, experts: int, factor: float) -> int:
    """The scatter dispatch's slots an expert: ceil(T·k/E·cf), within
    [1, T]."""
    return max(min(int(math.ceil(tokens * k / experts * factor)), tokens), 1)


def capacity_slots(top_idx, experts: int, cap: int, offsets=None):
    """Each (token, choice)'s slot in its expert's buffer and whether it
    is kept (slot < ``cap``), as JAX's ``_scatter_dispatch`` ranks them:
    a cumsum of the one-hot over the (T·k, E) choices flattened token
    by token, all k choices of a token before the next token's.
    ``top_idx``: (B, S, k) expert ids; ``offsets``: (B, E) choices of
    each expert that come before each row in the global token order
    (default: the rows before it in this batch). Returns (pos, keep),
    each (B, S, k)."""
    b, s, k = top_idx.shape
    onehot = F.one_hot(top_idx.reshape(b, s * k), experts)  # (B, S·k, E)
    counts = onehot.sum(1)                                  # (B, E)
    if offsets is None:
        offsets = counts.cumsum(0) - counts
    ranks = onehot.cumsum(1) - 1 + offsets[:, None, :]
    pos = (ranks * onehot).sum(-1).reshape(b, s, k)
    return pos, pos < cap


class MoE(nn.Module):
    """Routed mixture of experts (JAX's ``MoE``): a strict-f32 router,
    softmax gates, top-k (k > 1 renormalises the kept gates by
    max(sum, 1e-9); k = 1 keeps the raw gate), then the experts
    ``wi`` (E, d, F) and ``wo`` (E, F, d), f32 parameters in flax's
    layout applied in the compute dtype with the tanh GELU between, by
    ``cfg.moe_dispatch``:

    - ``dense``: every token through every expert, (B, E, S, F), the
      outputs weighted by the one-hot combine;
    - ``scatter``: each kept choice copied into its expert's slot of an
      (E, C, d) buffer (``capacity_slots``; C = ``capacity`` of the
      global batch's T tokens), the experts run over their slots, each
      choice's row gathered back weighted by its gate; choices past C
      are dropped (they add a zero row at slot 0, so the accumulating
      index-put is exact in any order). A single-token decode step
      takes the dense dispatch.

    Placement (``tensor_parallel.placement``, set by the runner's rules
    ``moe/wi`` ``P("ep", None, "tp")`` and ``moe/wo`` ``P("ep", "tp",
    None)``): each local entry computes its block of experts over its
    block of the hidden dim (an unplaced layer is one entry, ``WHOLE``);
    under dense dispatch an entry's output is weighted by its experts'
    combine columns, under scatter it takes its experts' rows of the
    buffer and gathers back only the choices routed to them; the
    entries' partial outputs are summed. The input and the gates pass
    ``copy_to`` and the sum ``reduce_from`` over the group of the
    ``ep`` and ``tp`` axes, so the router's gradient is whole on every
    process. Where the data axes span processes (``global_batch``, set
    by the runners), the scatter's capacity and ranks are the global
    batch's: the processes exchange their rows' per-expert counts and
    each ranks its choices after those of the tokens before its own.

    ``dropped`` (a device scalar) counts the choices the last forward
    dropped, of ``choices``."""

    reads_placed = True

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        if cfg.moe_dispatch not in ("dense", "scatter"):
            # A typo must not silently buy the E-times-dearer dense einsum.
            raise ValueError(
                f"moe_dispatch must be 'dense' or 'scatter', got "
                f"{cfg.moe_dispatch!r}")
        e, d, f = cfg.moe_experts, cfg.d_model, cfg.d_ff
        self.cfg = cfg
        self.router = Router(d, e)
        # lecun-normal over flax's fans: fan_in = d·E for (E, d, F).
        self.wi = nn.Parameter(torch.randn(e, d, f) / math.sqrt(d * e))
        self.wo = nn.Parameter(torch.randn(e, f, d) / math.sqrt(f * e))
        self.global_batch = None
        self.dropped, self.choices = None, 0

    def route(self, x):
        """``(top_idx, top_vals)``, each (B, S, k): the experts each token
        chose and their gates (f32)."""
        gates = torch.softmax(self.router(x), dim=-1)
        k = min(self.cfg.moe_top_k, self.cfg.moe_experts)
        top_vals, top_idx = torch.topk(gates, k, dim=-1)
        if k > 1:
            top_vals = top_vals / top_vals.sum(
                -1, keepdim=True).clamp_min(1e-9)
        return top_idx, top_vals

    def _entries(self):
        """(group, [(wi view, wo view, first expert)]) of the local
        entries."""
        wi, wo = tp.placement(self, "wi"), tp.placement(self, "wo")
        axes_in = {d: wi.axes_of(d) for d in wi.dims}
        axes_out = {d: wo.axes_of(d) for d in wo.dims}
        if (not set(axes_in) <= {0, 2} or not set(axes_out) <= {0, 1}
                or axes_in.get(0) != axes_out.get(0)
                or axes_in.get(2) != axes_out.get(1)):
            raise NotImplementedError(
                "the experts are placed by (ep, None, tp) and (ep, tp, "
                f"None) alike or not at all: got {wi}, {wo}")
        group = wi.group()
        entries = list(zip(tp.entry_views(self, "wi"),
                           tp.entry_views(self, "wo"),
                           tp.entry_starts(self, "wi", 0)))
        return group, entries

    def forward(self, x, decode_step: bool = False):
        cfg = self.cfg
        dt = cfg.compute_dtype
        top_idx, top_vals = self.route(x)
        group, entries = self._entries()
        x = tp.copy_to(x.to(dt), group)
        if cfg.moe_dispatch == "scatter" and not decode_step:
            out = self._scatter(x, top_idx, tp.copy_to(top_vals, group),
                                entries)
        else:
            combine = (F.one_hot(top_idx, cfg.moe_experts).to(top_vals.dtype)
                       * top_vals[..., None]).sum(-2)          # (B, S, E)
            out = self._dense(x, tp.copy_to(combine, group), entries)
        return tp.reduce_from(out, group)

    def _dense(self, x, combine, entries):
        dt = self.cfg.compute_dtype
        out = None
        for wi, wo, first in entries:
            h = F.gelu(torch.einsum("bsd,edf->besf", x, wi.to(dt)),
                       approximate="tanh")
            y = torch.einsum("besf,efd->besd", h, wo.to(dt))
            part = torch.einsum(
                "besd,bse->bsd", y,
                combine[..., first:first + wi.shape[0]].to(y.dtype))
            out = part if out is None else out + part
        return out

    def _offsets(self, top_idx):
        """(B, E): each expert's choices in the global batch before each
        of this process's rows (token order: row by row, and within a
        row the sequence blocks in order); None where the batch is this
        process's alone."""
        gb = self.global_batch
        if gb is None or (gb.count == 1 and gb.seq_count == 1):
            return None
        b, s, k = top_idx.shape
        e = self.cfg.moe_experts
        counts = F.one_hot(top_idx.reshape(b, s * k), e).sum(1)   # (B, E)
        where = torch.tensor([[gb.index, gb.seq_index]],
                             device=counts.device)
        blocks = gb.gather(where)                           # (Q, 2)
        parts = gb.gather(counts).view(-1, b, e)            # (Q, B, E)
        rows = blocks[:, :1] * b + torch.arange(b, device=counts.device)
        table = counts.new_zeros(gb.count * b, gb.seq_count, e)
        table[rows, blocks[:, 1:]] = parts
        flat = table.reshape(-1, e)
        before = (flat.cumsum(0) - flat).view(gb.count * b, gb.seq_count, e)
        return before[gb.index * b:(gb.index + 1) * b, gb.seq_index]

    def _scatter(self, x, top_idx, top_vals, entries):
        cfg = self.cfg
        dt = cfg.compute_dtype
        e = cfg.moe_experts
        b, s, dm = x.shape
        k = top_idx.shape[-1]
        gb = self.global_batch
        total = b * s * (1 if gb is None else gb.count * gb.seq_count)
        cap = capacity(total, k, e, cfg.moe_capacity_factor)
        pos, keep = capacity_slots(top_idx, e, cap,
                                   self._offsets(top_idx))
        self.dropped = (~keep).sum().detach()
        self.choices = keep.numel()
        t = b * s
        idx, pos, keep = (a.reshape(t, k) for a in (top_idx, pos, keep))
        safe_pos = torch.where(keep, pos, 0)
        tokens = x.reshape(t, dm)
        contrib = tokens[:, None, :] * keep[..., None].to(dt)
        buf = torch.zeros(e, cap, dm, dtype=dt, device=x.device).index_put(
            (idx, safe_pos), contrib, accumulate=True)
        vals = top_vals.reshape(t, k).to(dt)
        out = None
        for wi, wo, first in entries:
            n = wi.shape[0]
            h = F.gelu(torch.einsum("ecd,edf->ecf", buf[first:first + n],
                                    wi.to(dt)), approximate="tanh")
            y = torch.einsum("ecf,efd->ecd", h, wo.to(dt))
            local = idx - first
            inside = (local >= 0) & (local < n)
            rows = y[torch.where(inside, local, 0), safe_pos]   # (T, k, d)
            rows = rows * (vals * (keep & inside).to(dt))[..., None]
            part = rows.sum(1)
            out = part if out is None else out + part
        return out.reshape(b, s, dm)


def dropout(x, rate: float, generator: torch.Generator, global_batch=None):
    """flax ``Dropout``: keep where u >= rate (u uniform on [0, 1) from
    ``generator``, on x's device), scaled by 1/(1 - rate) in x's dtype.
    With a ``global_batch`` (the caller's hook over processes,
    ``parallel/multihost.attach``) the draw is the global batch's
    (batch-leading x; a 3-D x's dim 1 is its sequence) and this process
    keeps its block of it, so the masks are those of the one-process
    run: ``tp`` peers draw the same mask, an ``sp`` process its slice of
    the sequence."""
    if global_batch is None:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        shape, index = list(x.shape), []
        shape[0], start = global_batch.rows(x.shape[0])
        index.append(slice(start, start + x.shape[0]))
        if x.dim() >= 3:
            shape[1], start = global_batch.seq(x.shape[1])
            index.append(slice(start, start + x.shape[1]))
        u = torch.rand(shape, generator=generator,
                       device=x.device)[tuple(index)]
    return x * (u >= rate).to(x.dtype) / (1.0 - rate)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, mesh=None,
                 use_moe: bool = False):
        super().__init__()
        self.rate = cfg.dropout_rate
        self.ln1 = LayerNorm(cfg.d_model, cfg.compute_dtype)
        self.attn = SelfAttention(cfg, mesh)
        self.ln2 = LayerNorm(cfg.d_model, cfg.compute_dtype)
        if use_moe:
            self.moe = MoE(cfg)
        else:
            self.mlp = Mlp(cfg)
        self.global_batch = None

    def forward(self, x, seed: Optional[int] = None, cache=None,
                layer: int = 0):
        """``seed`` (training with dropout only) seeds this block's
        masks, so a recompute under remat draws the same ones;
        ``cache`` (a ``KVCache``) makes it the decode step of layer
        ``layer``."""
        gen = None
        if seed is not None:
            gen = torch.Generator(device=x.device).manual_seed(seed)
        h = self.attn(self.ln1(x), cache, layer)
        if gen is not None:
            h = dropout(h, self.rate, gen, self.global_batch)
        x = x + h
        if hasattr(self, "moe"):
            h = self.moe(self.ln2(x),
                         decode_step=cache is not None and x.shape[1] == 1)
        else:
            h = self.mlp(self.ln2(x))
        if gen is not None:
            h = dropout(h, self.rate, gen, self.global_batch)
        return x + h


class _LMHead(_PlacedDense):
    """The output projection (flax ``lm_head``: bf16 logits plus a bf16
    bias, returned as f32 by the model). Split over the vocabulary
    (``lm_head`` rows over ``tp``), each entry computes its block of
    the logits from ``copy_to``'s input, and the blocks are joined, over
    the processes by ``gather_last``, whose backward takes this
    process's slice: the loss reads whole logits.

    ``fused=True`` (a training forward with ``cfg.fused_head``) returns
    ``(x, kernel, bias)`` instead, as flax's ``_LMHead``: the kernel
    (d, V) in the compute dtype and the f32 bias, each gathered whole
    over ``tp`` (``gather_last``: the backward takes this process's
    block), for ``fused_next_token_cross_entropy``. Every process of the
    group then computes the whole loss, so ``x`` passes no ``copy_to``:
    its gradient is already whole."""

    def forward(self, x, fused: bool = False):
        split = tp.split_over(self, "weight", 0)
        if split is None or tp.split_over(self, "bias", 0) != split:
            raise NotImplementedError(
                "lm_head's weight and bias are split alike, by rows, or "
                f"not at all: got {tp.placement(self, 'weight')}, "
                f"{tp.placement(self, 'bias')}")
        group = split.group()
        if fused:
            kernel = self.weight.to(self.compute_dtype).t()
            return (x, tp.gather_last(kernel, group),
                    tp.gather_last(self.bias, group))
        x = tp.copy_to(x, group)
        blocks = [_linear(x, w, b, self.compute_dtype) for w, b in zip(
            tp.entry_views(self, "weight"), tp.entry_views(self, "bias"))]
        logits = blocks[0] if len(blocks) == 1 else torch.cat(blocks, -1)
        return tp.gather_last(logits, group)


def check_token_ids(tokens, vocab_size: int):
    """Raise ValueError unless every id of the host array lies in
    [0, vocab_size)."""
    if tokens.size and (tokens.min() < 0 or tokens.max() >= vocab_size):
        raise ValueError(f"token ids must lie in [0, {vocab_size})")


class KVCache:
    """The decode state of a ``TransformerLM``: per layer K and V of
    shape (B, max_len, H, D) in the compute dtype on ``device``, written
    in place, and the fill index, a host int (decoding reads nothing
    back from the card)."""

    def __init__(self, cfg: TransformerConfig, batch: int, device):
        shape = (batch, cfg.max_len, cfg.n_heads, cfg.head_dim)
        self.k = [torch.zeros(shape, dtype=cfg.compute_dtype, device=device)
                  for _ in range(cfg.n_layers)]
        self.v = [torch.zeros_like(k) for k in self.k]
        self.max_len = cfg.max_len
        self.index = 0

    def check_room(self, tokens: int):
        """Raise before a write past the cache's end (JAX's dynamic
        slice would clamp it and return wrong tokens)."""
        if self.index + tokens > self.max_len:
            raise ValueError(
                f"the KV cache holds {self.max_len} positions: "
                f"{self.index} filled + {tokens} new overflows it")


class TransformerLM(nn.Module):
    """``tokens`` = integer ids (B, S) → f32 logits (B, S, V), or the
    fused head's ``(hidden, kernel, bias)`` in training with
    ``cfg.fused_head``. With a ``mesh``, attention is the ring over its
    ``sp`` axis. With a ``cache`` (``KVCache``), the forward is a decode
    step: the tokens sit at the cache's fill index, which moves on by
    their count."""

    def __init__(self, cfg: TransformerConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.token_embed = tp.PlacedEmbedding(cfg.vocab_size, cfg.d_model)
        self.pos_embed = nn.Parameter(
            torch.randn(cfg.max_len, cfg.d_model) * 0.02
        )
        self.blocks = nn.ModuleList(
            Block(cfg, mesh, use_moe=(cfg.moe_experts > 0
                                      and (i + 1) % cfg.moe_every == 0))
            for i in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.d_model, cfg.compute_dtype)
        self.lm_head = _LMHead(cfg.d_model, cfg.vocab_size,
                               cfg.compute_dtype)

    def forward(self, tokens, generator: Optional[torch.Generator] = None,
                cache: Optional[KVCache] = None):
        """``generator`` (a CPU generator) seeds dropout in training."""
        cfg = self.cfg
        if tokens.dim() != 2:
            raise ValueError(
                f"tokens must be (batch, seq), got {tuple(tokens.shape)}"
            )
        s = tokens.shape[1]
        if cache is not None:
            cache.check_room(s)
        offset = (self._position_offset(s) if cache is None
                  else cache.index)
        if offset + s > cfg.max_len:
            raise ValueError(
                f"sequence length {offset + s} > max_len {cfg.max_len}")
        tokens = tokens.long()
        # On the card the ids are not read back (that would stall the
        # queue every forward): the serving layer checks them on the
        # host, where an out-of-range id is a 400, not a device assert.
        if tokens.device.type == "cpu":
            check_token_ids(tokens.numpy(), cfg.vocab_size)
        dtype = cfg.compute_dtype
        x = self.token_embed(tokens).to(dtype)
        x = x + self.pos_embed[offset:offset + s].to(dtype)[None]
        training = self.training and cache is None
        use_dropout = training and cfg.dropout_rate > 0
        if use_dropout and generator is None:
            raise ValueError("dropout in training needs a generator")
        for i, block in enumerate(self.blocks):
            seed = None
            if use_dropout:
                seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
            if cache is not None:
                x = block(x, None, cache, i)
            elif training and cfg.remat:
                x = torch.utils.checkpoint.checkpoint(
                    block, x, seed, use_reentrant=False)
            else:
                x = block(x, seed)
        if cache is not None:
            cache.index += s
        x = self.ln_f(x)
        if training and cfg.fused_head:
            return self.lm_head(x, fused=True)
        return self.lm_head(x).float()

    def _position_offset(self, s: int) -> int:
        """The global position of this process's first token: 0 unless
        the mesh's ``sp`` spans processes, where the tokens are the
        process's block of the sequence."""
        mesh = self.mesh
        if (mesh is None or not mesh.spans_processes
                or "sp" not in mesh.shape):
            return 0
        lo, hi = mesh.axis_block("sp")
        return lo * (s // (hi - lo))


def _decoder(cfg: TransformerConfig, model: TransformerLM) -> TransformerLM:
    """``model`` where it runs ``cfg`` unsharded, else an unsharded
    ``TransformerLM(cfg)`` holding its weights (as JAX's
    ``_generate_fn`` builds ``TransformerLM(cfg, mesh=None)`` over the
    params; the param tree does not depend on the dispatch or the
    head). A parameter held as a process's block cannot be copied."""
    placed = any(getattr(m, "_placed", None) for m in model.modules())
    if model.cfg == cfg and model.mesh is None and not placed:
        return model
    state = model.state_dict()
    for m in model.modules():
        for leaf, sharding in getattr(m, "_placed", {}).items():
            if sharding.spans_processes:
                raise NotImplementedError(
                    "generate from a model split across processes: its "
                    f"{type(m).__name__}.{leaf} holds a block")
    device = next(model.parameters()).device
    decoder = TransformerLM(cfg).to(device)
    decoder.load_state_dict(state)
    return decoder


def generate(cfg: TransformerConfig, model_or_state, prompt,
             max_new_tokens: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Autoregressive decoding with the KV cache (JAX's ``generate``):
    the prompt (B, P) prefills the cache in one pass, then one token a
    step, each fed back on the card (nothing is read back between
    steps). Temperature 0 is greedy (argmax); above 0 each token is
    drawn from softmax(logits / T) by inverse transform of a uniform
    drawn on the CPU from ``generator`` (JAX's ``PRNGKey`` draws cannot
    be reproduced here). ``model_or_state``: a ``TransformerLM`` or a
    train state holding one; it decodes unsharded, on its parameters'
    device, in eval mode. Returns (B, max_new_tokens) int32 tokens on
    that device."""
    model = getattr(model_or_state, "model", model_or_state)
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    prompt = torch.as_tensor(prompt)
    if prompt.dim() != 2:
        raise ValueError(
            f"prompt must be (batch, length), got {tuple(prompt.shape)}")
    total = prompt.shape[1] + max_new_tokens
    if total > cfg.max_len:
        raise ValueError(
            f"prompt ({prompt.shape[1]}) + max_new_tokens "
            f"({max_new_tokens}) = {total} exceeds max_len {cfg.max_len}")
    if prompt.numel():
        check_token_ids(prompt.cpu().numpy(), cfg.vocab_size)
    decoder = _decoder(cfg, model)
    device = next(decoder.parameters()).device
    prompt = prompt.to(device=device, dtype=torch.long)
    cache = KVCache(cfg, prompt.shape[0], device)

    def sample(logits):
        if temperature == 0.0:
            return logits.argmax(-1)
        cdf = torch.softmax(logits / temperature, dim=-1).cumsum(-1)
        u = torch.rand((logits.shape[0], 1), generator=generator)
        picked = torch.searchsorted(cdf, u.to(device=device,
                                              dtype=cdf.dtype))
        return picked[:, 0].clamp_max(cfg.vocab_size - 1)

    was_training = decoder.training
    decoder.eval()
    try:
        with torch.no_grad():
            token = sample(decoder(prompt, cache=cache)[:, -1])
            out = [token]
            for _ in range(max_new_tokens - 1):
                token = sample(decoder(token[:, None], cache=cache)[:, -1])
                out.append(token)
    finally:
        decoder.train(was_training)
    return torch.stack(out, dim=1).to(torch.int32)
