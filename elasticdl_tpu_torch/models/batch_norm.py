"""BatchNorm with flax ``nn.BatchNorm`` semantics, and ``TpuBatchNorm``
(port of elasticdl_tpu/models/batch_norm.py).

Not ``torch.nn.BatchNorm2d``: that one keeps the unbiased variance in its
running average, takes momentum the other way round and normalises over
dim 1. These follow flax, step for step:

- the feature axis is the last (NHWC activations);
- in training the statistics are the batch's, in the promoted dtype
  (f32 for a bf16 or f32 input): mean = E[x], var = E[x²] − E[x]²
  clamped at 0 (biased; flax's fast variance), and the running averages
  move as ``ra = m·ra + (1 − m)·batch`` (flax's momentum, default
  0.99);
- in eval (``model.eval()``) the running averages are the statistics;
- parameters ``scale`` (ones, or ``scale_init``) and ``bias`` (zeros),
  buffers ``mean`` (zeros) and ``var`` (ones), all f32, named as flax
  names them (params {scale, bias}, batch_stats {mean, var}).

``BatchNorm`` normalises in the promoted dtype, ``(x − mean) ·
(rsqrt(var + eps) · scale) + bias`` (f32 for a bf16 or f32 input), and
casts to ``dtype``. ``TpuBatchNorm`` folds the per-channel constants
first, ``a = scale · rsqrt(var + eps)``, ``b = bias − mean · a`` (f32),
and computes ``x·a + b`` in ``dtype`` (bf16 by default, momentum 0.9).

``global_batch`` is None, or the hook a runner over a mesh that spans
processes gives the layer (``parallel/multihost.attach``), as
``SyncBatchNorm`` carries its process group: with one, the batch
statistics are the global batch's, as under GSPMD: each process's sums
of x and x² are summed over the processes in the forward, a sum whose
backward sums the gradients. With none nothing changes.

A training forward updates the running averages in place; what keeps
them (a padded batch, a gradient-only step) is the train step's
business (``core/step.py``), as in the JAX package, where the step
decides which ``batch_stats`` to keep.
"""

import torch
from torch import nn


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=not training, momentum,
    epsilon, dtype)`` over the last axis of ``features`` channels."""

    # The buffers a training forward rewrites (core/train_state.py).
    STATISTICS = ("mean", "var")

    def __init__(self, features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5, dtype=torch.float32,
                 scale_init: float = 1.0):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.full((features,), float(scale_init)))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.global_batch = None

    def statistics(self, x):
        """(mean, var) to normalise ``x`` with: the batch's in training
        (the running averages then move toward them), else the running
        averages."""
        if not self.training:
            return self.mean, self.var
        axes = tuple(range(x.dim() - 1))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.global_batch is not None:
            count = (x.numel() // x.shape[-1]) * self.global_batch.count
            sums = self.global_batch.sum(
                torch.stack([xf.sum(axes), (xf * xf).sum(axes)]))
            mean = sums[0] / count
            var = (sums[1] / count - mean * mean).clamp_min(0.0)
        else:
            mean = xf.mean(axes)
            var = ((xf * xf).mean(axes) - mean * mean).clamp_min(0.0)
        m = self.momentum
        with torch.no_grad():
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return mean, var

    def forward(self, x):
        mean, var = self.statistics(x)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((x - mean) * mul + self.bias).to(self.dtype)


class TpuBatchNorm(BatchNorm):
    """``BatchNorm`` with the folded normalize: the same statistics and
    variables; ``x·a + b`` in ``dtype``."""

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype=torch.bfloat16,
                 scale_init: float = 1.0):
        super().__init__(features, momentum, epsilon, dtype, scale_init)

    def forward(self, x):
        mean, var = self.statistics(x)
        a = self.scale * torch.rsqrt(var + self.epsilon)
        b = self.bias - mean * a
        return x.to(self.dtype) * a.to(self.dtype) + b.to(self.dtype)
