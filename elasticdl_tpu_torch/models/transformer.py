"""Decoder-only transformer LM (port of elasticdl_tpu/models/transformer.py,
single device).

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
backward is the flash backward kernels.

Training (``model.train()``): dropout after attention and after the
MLP of each block, as flax ``Dropout`` does (keep where u >= rate,
scale by 1/(1 - rate)), with u drawn on the tokens' device from a
generator seeded per block from the caller's CPU ``torch.Generator``
(``forward(tokens, generator=...)``): the train state's generator, so
a run is reproducible from its seed. ``remat`` recomputes each block
in the backward (``torch.utils.checkpoint``, non-reentrant); the
block's seed is drawn outside the checkpointed function, so the
recompute draws the same masks. Not ported yet: MoE, KV-cache decode
(``generate``), the fused head, the mesh paths.
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
from elasticdl_tpu_torch.ops.ring_attention import dense_attention


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


class Dense(nn.Linear):
    """``nn.Linear`` with flax's rounding: x and W in ``dtype``, then the
    bias added in ``dtype``."""

    def __init__(self, in_features, out_features, dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.linear(x.to(self.compute_dtype),
                     self.weight.to(self.compute_dtype))
        return y + self.bias.to(self.compute_dtype)


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


class SelfAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, decode: bool = False):
        super().__init__()
        if decode:
            raise NotImplementedError(
                "KV-cache decode (generate) not yet ported"
            )
        self.cfg = cfg
        inner = cfg.n_heads * cfg.head_dim
        self.query = Dense(cfg.d_model, inner, cfg.compute_dtype)
        self.key = Dense(cfg.d_model, inner, cfg.compute_dtype)
        self.value = Dense(cfg.d_model, inner, cfg.compute_dtype)
        self.out = Dense(inner, cfg.d_model, cfg.compute_dtype)

    def forward(self, x):
        cfg = self.cfg
        b, s, _ = x.shape
        heads = (b, s, cfg.n_heads, cfg.head_dim)
        q = self.query(x).view(heads)
        k = self.key(x).view(heads)
        v = self.value(x).view(heads)
        scale = cfg.head_dim ** -0.5
        if flash_supports(q.shape, q.dtype):
            o = flash_attention(q, k, v, causal=True, scale=scale)
        elif q.device.type == "cpu":
            o = dense_attention(q, k, v, causal=True, scale=scale)
        else:
            raise NotImplementedError(
                f"attention on {q.device}: the flash kernel takes head "
                f"dims {HEAD_DIMS} in bfloat16 or float32, got "
                f"{cfg.head_dim} in {q.dtype}"
            )
        return self.out(o.reshape(b, s, cfg.n_heads * cfg.head_dim))


class Mlp(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.wi = Dense(cfg.d_model, cfg.d_ff, cfg.compute_dtype)
        self.wo = Dense(cfg.d_ff, cfg.d_model, cfg.compute_dtype)

    def forward(self, x):
        return self.wo(F.gelu(self.wi(x), approximate="tanh"))


def dropout(x, rate: float, generator: torch.Generator):
    """flax ``Dropout``: keep where u >= rate (u uniform on [0, 1) from
    ``generator``, on x's device), scaled by 1/(1 - rate) in x's dtype."""
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return x * (u >= rate).to(x.dtype) / (1.0 - rate)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.rate = cfg.dropout_rate
        self.ln1 = LayerNorm(cfg.d_model, cfg.compute_dtype)
        self.attn = SelfAttention(cfg)
        self.ln2 = LayerNorm(cfg.d_model, cfg.compute_dtype)
        self.mlp = Mlp(cfg)

    def forward(self, x, seed: Optional[int] = None):
        """``seed`` (training with dropout only) seeds this block's
        masks, so a recompute under remat draws the same ones."""
        gen = None
        if seed is not None:
            gen = torch.Generator(device=x.device).manual_seed(seed)
        h = self.attn(self.ln1(x))
        if gen is not None:
            h = dropout(h, self.rate, gen)
        x = x + h
        h = self.mlp(self.ln2(x))
        if gen is not None:
            h = dropout(h, self.rate, gen)
        return x + h


class _LMHead(Dense):
    """The output projection (flax ``lm_head``: bf16 logits plus a bf16
    bias, returned as f32 by the model)."""


def check_token_ids(tokens, vocab_size: int):
    """Raise ValueError unless every id of the host array lies in
    [0, vocab_size)."""
    if tokens.size and (tokens.min() < 0 or tokens.max() >= vocab_size):
        raise ValueError(f"token ids must lie in [0, {vocab_size})")


class TransformerLM(nn.Module):
    """``tokens`` = integer ids (B, S) → f32 logits (B, S, V)."""

    def __init__(self, cfg: TransformerConfig, decode: bool = False):
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
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.pos_embed = nn.Parameter(
            torch.randn(cfg.max_len, cfg.d_model) * 0.02
        )
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
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
        if s > cfg.max_len:
            raise ValueError(f"sequence length {s} > max_len {cfg.max_len}")
        tokens = tokens.long()
        # On the card the ids are not read back (that would stall the
        # queue every forward): the serving layer checks them on the
        # host, where an out-of-range id is a 400, not a device assert.
        if tokens.device.type == "cpu":
            check_token_ids(tokens.numpy(), cfg.vocab_size)
        dtype = cfg.compute_dtype
        x = self.token_embed(tokens).to(dtype)
        x = x + self.pos_embed[:s].to(dtype)[None]
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
