"""Masked losses (port of elasticdl_tpu/ops/losses.py).

They take ``(labels, predictions, mask)`` like the model-zoo loss
contract, ``mask`` weighting padded rows of the final partial batch
(data/batcher.py), and reduce in log space in f32, as the JAX package
does. The fused next-token loss waits for the fused LM head.
"""

import torch
import torch.nn.functional as F

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


def fused_next_token_cross_entropy(labels, outputs, mask,
                                   chunk_size: int = 128):
    raise NotImplementedError(
        "fused_next_token_cross_entropy waits for the fused LM head "
        "(not yet ported)"
    )


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
