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
forward). Not ported yet: MoE, KV-cache decode (``generate``), the
fused head.
"""

import dataclasses
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
    moe_experts: int = 0        # > 0 is not ported yet
    remat: bool = False
    compute_dtype: torch.dtype = torch.bfloat16
    fused_head: bool = False    # True is not ported yet

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
    def __init__(self, cfg: TransformerConfig, mesh=None,
                 decode: bool = False):
        super().__init__()
        if decode:
            raise NotImplementedError(
                "KV-cache decode (generate) not yet ported"
            )
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

    def forward(self, x):
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
    def __init__(self, cfg: TransformerConfig, mesh=None):
        super().__init__()
        self.rate = cfg.dropout_rate
        self.ln1 = LayerNorm(cfg.d_model, cfg.compute_dtype)
        self.attn = SelfAttention(cfg, mesh)
        self.ln2 = LayerNorm(cfg.d_model, cfg.compute_dtype)
        self.mlp = Mlp(cfg)
        self.global_batch = None

    def forward(self, x, seed: Optional[int] = None):
        """``seed`` (training with dropout only) seeds this block's
        masks, so a recompute under remat draws the same ones."""
        gen = None
        if seed is not None:
            gen = torch.Generator(device=x.device).manual_seed(seed)
        h = self.attn(self.ln1(x))
        if gen is not None:
            h = dropout(h, self.rate, gen, self.global_batch)
        x = x + h
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
    process's slice: the loss reads whole logits."""

    def forward(self, x):
        split = tp.split_over(self, "weight", 0)
        if split is None or tp.split_over(self, "bias", 0) != split:
            raise NotImplementedError(
                "lm_head's weight and bias are split alike, by rows, or "
                f"not at all: got {tp.placement(self, 'weight')}, "
                f"{tp.placement(self, 'bias')}")
        group = split.group()
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


class TransformerLM(nn.Module):
    """``tokens`` = integer ids (B, S) → f32 logits (B, S, V). With a
    ``mesh``, attention is the ring over its ``sp`` axis."""

    def __init__(self, cfg: TransformerConfig, mesh=None,
                 decode: bool = False):
        super().__init__()
        if cfg.moe_experts > 0:
            raise NotImplementedError("MoE blocks not yet ported")
        if cfg.fused_head:
            raise NotImplementedError("fused LM head not yet ported")
        if decode:
            raise NotImplementedError(
                "KV-cache decode (generate) not yet ported"
            )
        self.cfg = cfg
        self.mesh = mesh
        self.token_embed = tp.PlacedEmbedding(cfg.vocab_size, cfg.d_model)
        self.pos_embed = nn.Parameter(
            torch.randn(cfg.max_len, cfg.d_model) * 0.02
        )
        self.blocks = nn.ModuleList(Block(cfg, mesh)
                                    for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.d_model, cfg.compute_dtype)
        self.lm_head = _LMHead(cfg.d_model, cfg.vocab_size,
                               cfg.compute_dtype)

    def forward(self, tokens, generator: Optional[torch.Generator] = None):
        """``generator`` (a CPU generator) seeds dropout in training."""
        cfg = self.cfg
        if tokens.dim() != 2:
            raise ValueError(
                f"tokens must be (batch, seq), got {tuple(tokens.shape)}"
            )
        s = tokens.shape[1]
        offset = self._position_offset(s)
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
        use_dropout = self.training and cfg.dropout_rate > 0
        if use_dropout and generator is None:
            raise ValueError("dropout in training needs a generator")
        for block in self.blocks:
            seed = None
            if use_dropout:
                seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
            if self.training and cfg.remat:
                x = torch.utils.checkpoint.checkpoint(
                    block, x, seed, use_reentrant=False)
            else:
                x = block(x, seed)
        return self.lm_head(self.ln_f(x)).float()

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
