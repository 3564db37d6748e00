"""MNIST CNN — zoo twin of model_zoo/mnist/mnist_functional.py (BASELINE
#1, bench_suite.py's ``mnist`` config at B 512).

Conv(32) → Conv(64) → BatchNorm → MaxPool → Dense(10) with bfloat16
compute, module names as flax gives them (``Conv_0``, ``Conv_1``,
``BatchNorm_0``, ``Dense_0``). The BatchNorm has flax's default momentum
0.99. The pooled (B, 14, 14, 64) activations flatten in NHWC order, so
the flax Dense kernel carries over unpermuted. Records decode inline,
as in the JAX module.
"""

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.models.batch_norm import BatchNorm
from elasticdl_tpu_torch.models.transformer import Dense
from elasticdl_tpu_torch.models.vision import Conv, max_pool, place
from elasticdl_tpu_torch.ops.losses import masked_softmax_cross_entropy


class MnistModel(nn.Module):
    def __init__(self, compute_dtype=torch.bfloat16, image_hw: int = 28):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.Conv_0 = Conv(1, 32, 3, dtype=compute_dtype)
        self.Conv_1 = Conv(32, 64, 3, dtype=compute_dtype)
        self.BatchNorm_0 = BatchNorm(64, dtype=compute_dtype)
        self.Dense_0 = Dense((image_hw // 2) ** 2 * 64, 10, compute_dtype)

    def forward(self, features):
        x = torch.as_tensor(features).to(self.compute_dtype)
        if x.dim() == 3:
            x = x[..., None]
        x = torch.relu(self.Conv_0(x))
        x = torch.relu(self.Conv_1(x))
        x = self.BatchNorm_0(x)
        x = max_pool(x, 2, 2)
        x = x.reshape(x.shape[0], -1)
        return self.Dense_0(x).float()


def custom_model(device=None):
    return place(MnistModel(), device)


def loss(labels, predictions, mask):
    return masked_softmax_cross_entropy(labels, predictions, mask)


def optimizer(lr=0.1):
    return lambda params: torch.optim.SGD(params, lr=lr, momentum=0.9)


def dataset_fn(records, mode, metadata):
    images, labels = [], []
    for payload in records:
        rec = tensor_utils.loads(payload)
        images.append(np.asarray(rec["image"], np.float32) / 255.0)
        labels.append(int(rec.get("label", 0)))
    features = np.stack(images).astype(np.float32)
    labels = np.asarray(labels, np.int32)
    if mode == Mode.PREDICTION:
        return features, np.zeros_like(labels)
    return features, labels


def eval_metrics_fn():
    return {
        "accuracy": lambda labels, outputs: float(
            np.mean(np.argmax(outputs, axis=1) == labels)
        )
    }
