"""ResNet-50 v2 (pre-activation) — zoo twin of
model_zoo/resnet50/resnet50_v2.py.

Full pre-activation bottlenecks (BN → ReLU → conv), the projection taken
from the pre-activated tensor; a 7×7/s2 ``stem`` with flax's "SAME"
padding ((2, 3) at 224), a 3×3/s2 max pool ("SAME", −inf), then
``final_norm`` and ReLU, the mean over H and W and an f32 ``head``.
bfloat16 convolutions, every BatchNorm f32 (momentum 0.9, epsilon
1e-5). Module names are flax's (``stem``, ``stage{s}_block{b}`` with
``pre_norm``, ``proj``, ``Conv_0``-``Conv_2``, ``norm1``, ``norm2``;
``final_norm``, ``head``). ``stages`` ((filters, blocks) a stage;
``STAGES`` by default) lets a test build it shallow.
"""

import functools

import torch
from torch import nn

from elasticdl_tpu_torch.data.decoders import (
    argmax_accuracy_metrics,
    image_classification_dataset_fn,
)
from elasticdl_tpu_torch.models.batch_norm import BatchNorm
from elasticdl_tpu_torch.models.transformer import Dense
from elasticdl_tpu_torch.models.vision import Conv, max_pool, place
from elasticdl_tpu_torch.ops.losses import masked_softmax_cross_entropy

STAGES = ((64, 3), (128, 4), (256, 6), (512, 3))

_norm = functools.partial(BatchNorm, momentum=0.9, epsilon=1e-5,
                          dtype=torch.float32)


class PreActBottleneck(nn.Module):
    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 projection: bool = False, compute_dtype=torch.bfloat16):
        super().__init__()
        conv = functools.partial(Conv, use_bias=False, dtype=compute_dtype)
        self.pre_norm = _norm(in_features)
        self.proj = (conv(in_features, filters * 4, 1, strides)
                     if projection else None)
        self.Conv_0 = conv(in_features, filters, 1)
        self.norm1 = _norm(filters)
        self.Conv_1 = conv(filters, filters, 3, strides)
        self.norm2 = _norm(filters)
        self.Conv_2 = conv(filters, filters * 4, 1)

    def forward(self, x):
        pre = torch.relu(self.pre_norm(x))
        shortcut = x if self.proj is None else self.proj(pre)
        y = torch.relu(self.norm1(self.Conv_0(pre)))
        y = torch.relu(self.norm2(self.Conv_1(y)))
        return shortcut + self.Conv_2(y)


class ResNet50V2(nn.Module):
    def __init__(self, num_classes: int = 10, compute_dtype=torch.bfloat16,
                 stages=STAGES, in_channels: int = 3):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.stem = Conv(in_channels, 64, 7, 2, use_bias=False,
                         dtype=compute_dtype)
        self.block_names = []
        width = 64
        for stage, (filters, blocks) in enumerate(stages):
            for block in range(blocks):
                name = f"stage{stage}_block{block}"
                self.add_module(name, PreActBottleneck(
                    width, filters, 2 if stage > 0 and block == 0 else 1,
                    projection=block == 0, compute_dtype=compute_dtype))
                self.block_names.append(name)
                width = filters * 4
        self.final_norm = _norm(width)
        self.head = Dense(width, num_classes, torch.float32)

    def forward(self, features):
        x = torch.as_tensor(features).to(self.compute_dtype)
        if x.dim() == 3:
            x = x[..., None]
        x = max_pool(self.stem(x), 3, 2, "SAME")
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = torch.relu(self.final_norm(x))
        return self.head(x.mean(dim=(1, 2)))


def custom_model(device=None):
    return place(ResNet50V2(), device)


def loss(labels, predictions, mask):
    return masked_softmax_cross_entropy(labels, predictions, mask)


def optimizer(lr=0.05):
    return lambda params: torch.optim.SGD(params, lr=lr, momentum=0.9,
                                          nesterov=True)


dataset_fn = image_classification_dataset_fn
eval_metrics_fn = argmax_accuracy_metrics
