"""The flax layers the vision zoo twins are built of, on NHWC activations.

Features arrive as (B, H, W, C), as the JAX zoo takes them, and every
activation between layers stays (B, H, W, C). A convolution or a pool
views it as NCHW with ``permute`` (no copy: the view is the
``torch.channels_last`` layout, which cuDNN's tensor-core convolutions
take as it is) and views its output back. ``place`` puts a model's
4-D weights in the same layout on the card.

- ``Conv``: flax ``nn.Conv(features, kernel_size, strides, padding,
  use_bias, dtype)``. The kernel (out, in, kh, kw) and bias stay f32;
  input, kernel and bias are cast to ``dtype`` at the call and the bias
  is added in ``dtype``. ``"SAME"`` padding is flax's: total =
  max((out − 1)·s + k − in, 0) with total // 2 before and the rest after
  (asymmetric at stride 2: a 3×3/s2 at an even input pads (0, 1), a
  7×7/s2 at 224 (2, 3)); ``torch.nn.Conv2d``'s padding is symmetric, so
  an asymmetric one is an explicit ``F.pad``.
- ``max_pool``: flax ``nn.max_pool``; ``"SAME"`` pads the same way with
  −inf (the resnet stems' 3×3/s2 pads (0, 1)).
- Dense layers are ``models.transformer.Dense`` (flax's rounding).

Weights are drawn as flax draws them (truncated-normal lecun for
kernels, zero biases); parity tests carry the JAX weights across with
``bridge.flax_state_dict``.
"""

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.common.device import resolve_device

Padding = Union[str, Sequence[Tuple[int, int]]]


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA "SAME" padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pads(padding: Padding, hw, kernel, stride):
    if padding == "SAME":
        return [same_pads(n, k, s) for n, k, s in zip(hw, kernel, stride)]
    if padding == "VALID":
        return [(0, 0), (0, 0)]
    return [tuple(p) for p in padding]


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _pad_nchw(x, pads, value=0.0):
    (top, bottom), (left, right) = pads
    return F.pad(x, (left, right, top, bottom), value=value)


def lecun_normal_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal of variance 1/fan_in truncated
    at two standard deviations (its std corrected for the cut)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


class Conv(nn.Module):
    """flax ``nn.Conv`` on (B, H, W, C) activations."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 strides: int = 1, padding: Padding = "SAME",
                 use_bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.kernel = (kernel_size, kernel_size)
        self.strides = (strides, strides)
        self.padding = padding
        self.compute_dtype = dtype
        self.weight = nn.Parameter(lecun_normal_(
            torch.empty(features, in_features, kernel_size, kernel_size),
            in_features * kernel_size * kernel_size))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def forward(self, x):
        pads = _pads(self.padding, x.shape[1:3], self.kernel, self.strides)
        xc = _nchw(x.to(self.compute_dtype))
        weight = self.weight.to(self.compute_dtype)
        (top, bottom), (left, right) = pads
        if top == bottom and left == right:
            y = F.conv2d(xc, weight, stride=self.strides,
                         padding=(top, left))
        else:
            y = F.conv2d(_pad_nchw(xc, pads), weight, stride=self.strides)
        y = _nhwc(y)
        if self.bias is not None:
            y = y + self.bias.to(self.compute_dtype)
        return y


def max_pool(x, window: int, strides: int, padding: Padding = "VALID"):
    """flax ``nn.max_pool`` of (B, H, W, C) over window x window."""
    kernel, stride = (window, window), (strides, strides)
    xc = _nchw(x)
    pads = _pads(padding, x.shape[1:3], kernel, stride)
    if any(p for pair in pads for p in pair):
        xc = _pad_nchw(xc, pads, value=float("-inf"))
    return _nhwc(F.max_pool2d(xc, kernel, stride))


def space_to_depth(x, block: int = 2):
    """(B, H, W, C) -> (B, H/b, W/b, b·b·C), channels in (bh, bw, c)
    order: each b x b patch folds into channels."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // block, w // block,
                                               block * block * c)


def place(model: nn.Module, device=None) -> nn.Module:
    """``model`` on ``device`` (CUDA unless "cpu" is asked for), its 4-D
    weights in the channels-last layout on the card."""
    dev = resolve_device(device)
    model = model.to(dev)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model
