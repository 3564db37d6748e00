"""ResNet-50 (bottleneck v1.5) — zoo twin of model_zoo/resnet50/resnet50.py
(BASELINE #3, bench_suite.py's ``resnet50`` config: B 128 at 224×224).

bfloat16 convolutions, BatchNorm statistics and parameters in f32 (the
normalized activations in ``norm_dtype``, bf16), momentum 0.9, epsilon
1e-5; the stride in the bottleneck's 3×3 (v1.5), whose flax "SAME"
padding at stride 2 and an even input is (0, 1); ``norm3`` starts at
scale 0. ``tpu_norm`` takes ``TpuBatchNorm`` (the folded normalize; the
stem's norm is then ``TpuBatchNorm_0``, as flax names it). The stem is
a 7×7/s2 conv padded (3, 3), or, with ``space_to_depth`` (the zoo's
``custom_model()``), a 2×2 space-to-depth, channels in (bh, bw, c)
order, then a 4×4/s1 conv padded (2, 1); then BatchNorm, ReLU and a
3×3/s2 max pool padded "SAME" with −inf. The head is the mean over H
and W (taken in f32 at least and rounded to the compute dtype, as
``jnp.mean`` of bf16 gives it) into an f32 Dense. Module names are
flax's (``Conv_0``, ``BatchNorm_0``, ``BottleneckBlock_k``,
``Dense_0``; in a block ``Conv_k``, ``norm_proj``, ``norm1``-``norm3``).
"""

import functools
from typing import Sequence

import torch
from torch import nn

from elasticdl_tpu_torch.data.decoders import (
    argmax_accuracy_metrics,
    image_classification_dataset_fn,
)
from elasticdl_tpu_torch.models.batch_norm import BatchNorm, TpuBatchNorm
from elasticdl_tpu_torch.models.transformer import Dense
from elasticdl_tpu_torch.models.vision import (
    Conv,
    max_pool,
    place,
    space_to_depth,
)
from elasticdl_tpu_torch.ops.losses import masked_softmax_cross_entropy


class BottleneckBlock(nn.Module):
    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 projection: bool = False, compute_dtype=torch.bfloat16,
                 norm_dtype=torch.bfloat16, tpu_norm: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.projection = projection
        conv = functools.partial(Conv, use_bias=False, dtype=compute_dtype)
        norm = functools.partial(TpuBatchNorm if tpu_norm else BatchNorm,
                                 momentum=0.9, epsilon=1e-5,
                                 dtype=norm_dtype)
        convs = []
        if projection:
            convs.append(conv(in_features, filters * 4, 1, strides))
            self.norm_proj = norm(filters * 4)
        convs += [conv(in_features, filters, 1),
                  conv(filters, filters, 3, strides),
                  conv(filters, filters * 4, 1)]
        for k, layer in enumerate(convs):
            self.add_module(f"Conv_{k}", layer)
        self.norm1 = norm(filters)
        self.norm2 = norm(filters)
        self.norm3 = norm(filters * 4, scale_init=0.0)

    def forward(self, x):
        first = 1 if self.projection else 0
        convs = [getattr(self, f"Conv_{first + k}") for k in range(3)]
        shortcut = x
        if self.projection:
            shortcut = self.norm_proj(self.Conv_0(x))
        y = torch.relu(self.norm1(convs[0](x)))
        y = torch.relu(self.norm2(convs[1](y)))
        y = self.norm3(convs[2](y))
        return torch.relu((y + shortcut).to(self.compute_dtype))


class ResNet50(nn.Module):
    def __init__(self, num_classes: int = 1000,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 compute_dtype=torch.bfloat16, norm_dtype=torch.bfloat16,
                 space_to_depth: bool = False, tpu_norm: bool = False,
                 in_channels: int = 3):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.space_to_depth = space_to_depth
        if space_to_depth:
            self.Conv_0 = Conv(4 * in_channels, 64, 4, 1,
                               padding=[(2, 1), (2, 1)], use_bias=False,
                               dtype=compute_dtype)
        else:
            self.Conv_0 = Conv(in_channels, 64, 7, 2,
                               padding=[(3, 3), (3, 3)], use_bias=False,
                               dtype=compute_dtype)
        norm = TpuBatchNorm if tpu_norm else BatchNorm
        self.stem_norm_name = f"{norm.__name__}_0"
        self.add_module(self.stem_norm_name, norm(
            64, momentum=0.9, epsilon=1e-5, dtype=norm_dtype))
        width, k = 64, 0
        for stage, num_blocks in enumerate(stage_sizes):
            filters = 64 * 2 ** stage
            for block in range(num_blocks):
                self.add_module(f"BottleneckBlock_{k}", BottleneckBlock(
                    width, filters, 2 if stage > 0 and block == 0 else 1,
                    projection=block == 0, compute_dtype=compute_dtype,
                    norm_dtype=norm_dtype, tpu_norm=tpu_norm))
                width, k = filters * 4, k + 1
        self.num_blocks = k
        self.Dense_0 = Dense(width, num_classes, torch.float32)

    def forward(self, features):
        x = torch.as_tensor(features).to(self.compute_dtype)
        if self.space_to_depth:
            if x.shape[1] % 2 or x.shape[2] % 2:
                raise ValueError(
                    "space_to_depth=True needs even spatial dims, got "
                    f"{x.shape[1]}x{x.shape[2]}; pad the input or set "
                    "space_to_depth=False")
            x = space_to_depth(x, 2)
        x = getattr(self, self.stem_norm_name)(self.Conv_0(x))
        x = torch.relu(x).to(self.compute_dtype)
        x = max_pool(x, 3, 2, "SAME")
        for k in range(self.num_blocks):
            x = getattr(self, f"BottleneckBlock_{k}")(x)
        wide = torch.promote_types(x.dtype, torch.float32)
        x = x.to(wide).mean(dim=(1, 2)).to(x.dtype)
        return self.Dense_0(x)


def custom_model(device=None):
    # 10 classes for the synthetic cifar-shaped records, the s2d stem, as
    # the JAX zoo's entry.
    return place(ResNet50(num_classes=10, space_to_depth=True), device)


def loss(labels, predictions, mask):
    return masked_softmax_cross_entropy(labels, predictions, mask)


def optimizer(lr=0.02):
    return lambda params: torch.optim.SGD(params, lr=lr, momentum=0.9,
                                          nesterov=True)


def dataset_fn(records, mode, metadata):
    return image_classification_dataset_fn(records, mode, metadata)


def eval_metrics_fn():
    return argmax_accuracy_metrics()
