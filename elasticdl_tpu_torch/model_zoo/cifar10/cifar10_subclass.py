"""CIFAR-10 CNN, subclass style — zoo twin of
model_zoo/cifar10/cifar10_subclass.py: two ``ConvBlock``s (``conv_a``,
``norm_a``, ``conv_b``, ``norm_b``; BatchNorm momentum 0.9, epsilon
1e-6) then ``hidden`` (Dense 512) and ``head``, flax's names; bfloat16
compute and no dropout, as there.
"""

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


class ConvBlock(nn.Module):
    def __init__(self, in_features: int, width: int, compute_dtype):
        super().__init__()
        self.conv_a = Conv(in_features, width, 3, dtype=compute_dtype)
        self.norm_a = BatchNorm(width, momentum=0.9, epsilon=1e-6,
                                dtype=compute_dtype)
        self.conv_b = Conv(width, width, 3, dtype=compute_dtype)
        self.norm_b = BatchNorm(width, momentum=0.9, epsilon=1e-6,
                                dtype=compute_dtype)

    def forward(self, x):
        x = torch.relu(self.norm_a(self.conv_a(x)))
        x = torch.relu(self.norm_b(self.conv_b(x)))
        return max_pool(x, 2, 2)


class Cifar10SubclassModel(nn.Module):
    def __init__(self, num_classes: int = 10, compute_dtype=torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.block1 = ConvBlock(3, 32, compute_dtype)
        self.block2 = ConvBlock(32, 64, compute_dtype)
        self.hidden = Dense(8 * 8 * 64, 512, compute_dtype)
        self.head = Dense(512, num_classes, compute_dtype)

    def forward(self, features):
        x = torch.as_tensor(features).to(self.compute_dtype)
        x = self.block2(self.block1(x))
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(self.hidden(x))
        return self.head(x).float()


def custom_model(device=None):
    return place(Cifar10SubclassModel(), device)


def loss(labels, predictions, mask):
    return masked_softmax_cross_entropy(labels, predictions, mask)


def optimizer(lr=0.1):
    return lambda params: torch.optim.SGD(params, lr=lr, momentum=0.9)


def dataset_fn(records, mode, metadata):
    return image_classification_dataset_fn(records, mode, metadata)


def eval_metrics_fn():
    return argmax_accuracy_metrics()
