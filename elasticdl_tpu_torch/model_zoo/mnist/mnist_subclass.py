"""MNIST CNN, subclass style — zoo twin of
model_zoo/mnist/mnist_subclass.py: the functional twin's layers as named
submodules (``conv1``, ``conv2``, ``norm``, ``dense``, flax's names).
The BatchNorm has flax's default momentum, 0.99.
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


class MnistSubclassModel(nn.Module):
    def __init__(self, num_classes: int = 10, compute_dtype=torch.bfloat16,
                 image_hw: int = 28):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = Conv(1, 32, 3, dtype=compute_dtype)
        self.conv2 = Conv(32, 64, 3, dtype=compute_dtype)
        self.norm = BatchNorm(64, dtype=compute_dtype)
        self.dense = Dense((image_hw // 2) ** 2 * 64, num_classes,
                           compute_dtype)

    def forward(self, features):
        x = torch.as_tensor(features).to(self.compute_dtype)
        if x.dim() == 3:
            x = x[..., None]
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        x = self.norm(x)
        x = max_pool(x, 2, 2)
        x = x.reshape(x.shape[0], -1)
        return self.dense(x).float()


def custom_model(device=None):
    return place(MnistSubclassModel(), device)


def loss(labels, predictions, mask):
    return masked_softmax_cross_entropy(labels, predictions, mask)


def optimizer(lr=0.1):
    return lambda params: torch.optim.SGD(params, lr=lr, momentum=0.9)


def dataset_fn(records, mode, metadata):
    return image_classification_dataset_fn(records, mode, metadata)


def eval_metrics_fn():
    return argmax_accuracy_metrics()
