"""Masked losses (port of elasticdl_tpu/ops/losses.py).

They take ``(labels, predictions, mask)`` like the model-zoo loss
contract, ``mask`` weighting padded rows of the final partial batch
(data/batcher.py), and reduce in log space in f32, as the JAX package
does. ``fused_next_token_cross_entropy`` takes the fused LM head's
``(hidden, kernel, bias)`` and never holds the (B, S, V) logits.
"""

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from elasticdl_tpu_torch.data.batcher import masked_mean


def masked_softmax_cross_entropy(labels, logits, mask):
    """Integer-label softmax CE, masked mean over real rows."""
    logp = F.log_softmax(logits, dim=-1)
    per_example = -logp.gather(-1, labels.long()[..., None])[..., 0]
    return masked_mean(per_example, mask)


def masked_sigmoid_cross_entropy(labels, logits, mask):
    """Binary CE on logits, masked mean over real rows:
    ``max(x, 0) - x*z + log1p(exp(-|x|))``.

    At a logit of exactly 0 (zero biases on an empty embedding row) the
    gradient takes JAX's conventions: ``max`` splits the tie (1/2) and
    ``|x|`` has slope 1, as ``jnp.maximum`` and ``jnp.abs`` do."""
    x = logits
    z = labels.to(x.dtype)
    if x.dim() == z.dim() + 1 and x.shape[-1] == 1:
        x = x[..., 0]
    abs_x = torch.where(x >= 0, x, -x)
    per_example = (torch.maximum(x, torch.zeros_like(x)) - x * z
                   + torch.log1p(torch.exp(-abs_x)))
    return masked_mean(per_example, mask)


def _chunk_loss(h, kernel, bias, labels, weights):
    """Σ w·(logsumexp − label logit) of one sequence chunk: f32 logits
    from the bf16 hidden and kernel upcast (a product of two bf16 values
    is exact in f32, as XLA's f32-accumulating ``dot_general``), plus
    the f32 bias. The kernel is upcast here, inside the chunk, so each
    chunk's kernel gradient is rounded to the kernel's dtype and summed
    in it, as JAX's scan carries a closed-over bf16 kernel's cotangent."""
    logits = torch.matmul(h.float(), kernel.float()) + bias.float()
    lse = torch.logsumexp(logits, dim=-1)
    lab_logit = logits.gather(-1, labels[..., None])[..., 0]
    return ((lse - lab_logit) * weights).sum()


def fused_next_token_cross_entropy(labels, outputs, mask,
                                   chunk_size: int = 128):
    """LM cross entropy without the (B, S, V) logits (JAX's fused loss):
    ``outputs`` is the fused head's ``(hidden (B, S, d), kernel (d, V),
    bias (V,))``. The sequence is walked in chunks of ``chunk_size``,
    each under ``torch.utils.checkpoint``, so a chunk's f32 logits live
    only while it is summed and the backward recomputes them. Numerics
    as ``masked_next_token_cross_entropy``: log-space reduction in f32,
    Σw·(lse − label logit) / max(Σw, 1), w the (B,) row mask over the
    tokens. Raises ValueError when the sequence does not tile by the
    chunk. The product is a plain one (JAX computes it outside any
    Pallas kernel), so ``torch.matmul`` computes it here."""
    hidden, kernel, bias = outputs
    b, s, _ = hidden.shape
    labels = labels.long()
    weights = mask.float()[:, None].expand(b, s)
    chunk = min(chunk_size, s)
    if s % chunk:
        raise ValueError(f"seq len {s} must tile by chunk {chunk}")
    total = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, s, chunk):
        total = total + torch.utils.checkpoint.checkpoint(
            _chunk_loss, hidden[:, i:i + chunk], kernel, bias,
            labels[:, i:i + chunk], weights[:, i:i + chunk],
            use_reentrant=False)
    return total / weights.sum().clamp_min(1.0)


def masked_next_token_cross_entropy(labels, logits, mask):
    """Per-token LM cross entropy: labels (B, S) int, logits (B, S, V),
    ``mask`` the (B,) padded-row mask broadcast over tokens; computed as
    ``logsumexp(x) - x[label]`` in f32, divided by max(Σw, 1)."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    lab_logit = logits32.gather(-1, labels.long()[..., None])[..., 0]
    ll = lab_logit - lse
    weights = mask.to(ll.dtype)[:, None].expand_as(ll)
    return -(ll * weights).sum() / weights.sum().clamp_min(1.0)
