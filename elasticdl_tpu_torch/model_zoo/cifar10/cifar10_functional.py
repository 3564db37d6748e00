"""CIFAR-10 VGG-style CNN — zoo twin of
model_zoo/cifar10/cifar10_functional.py (BASELINE #2, bench_suite.py's
``cifar10`` config at B 256).

(Conv+BN)×2 → pool + dropout 0.2 → (Conv+BN)×2 → pool + dropout 0.3 →
Dense 512 → dropout 0.5 → Dense 10, bfloat16 compute; BatchNorm momentum
0.9, epsilon 1e-6; module names as flax gives them (``Conv_k``,
``BatchNorm_k``, ``Dense_k``). Dropout is flax's (keep where u >= rate,
scaled by 1/(1 - rate)); in training its masks come from a generator
seeded from the train state's CPU generator (``forward(features,
generator=...)``), so a run is reproducible from its seed. ``callbacks``
gives the reference's version-based learning-rate decay: the
multiplier of the base rate (0.1) is 1.0, then 0.1 from version 200,
then 0.01 from version 400.
"""

from typing import Optional

import torch
from torch import nn

from elasticdl_tpu_torch.callbacks import LearningRateScheduler
from elasticdl_tpu_torch.data.decoders import (
    argmax_accuracy_metrics,
    image_classification_dataset_fn,
)
from elasticdl_tpu_torch.models.batch_norm import BatchNorm
from elasticdl_tpu_torch.models.transformer import Dense, dropout
from elasticdl_tpu_torch.models.vision import Conv, max_pool, place
from elasticdl_tpu_torch.ops.losses import masked_softmax_cross_entropy

# (width, dropout rate after the pool) of the two conv stages.
STAGES = ((32, 0.2), (64, 0.3))


def dropout_generator(x, generator: Optional[torch.Generator]):
    """A generator on x's device seeded from ``generator`` (the train
    state's CPU generator)."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
    return torch.Generator(device=x.device).manual_seed(seed)


class Cifar10Model(nn.Module):
    def __init__(self, num_classes: int = 10, compute_dtype=torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        width_in, k = 3, 0
        for width, _ in STAGES:
            for _ in range(2):
                self.add_module(f"Conv_{k}", Conv(width_in, width, 3,
                                                  dtype=compute_dtype))
                self.add_module(f"BatchNorm_{k}", BatchNorm(
                    width, momentum=0.9, epsilon=1e-6, dtype=compute_dtype))
                width_in, k = width, k + 1
        self.Dense_0 = Dense(8 * 8 * width_in, 512, compute_dtype)
        self.Dense_1 = Dense(512, num_classes, compute_dtype)
        # The dropout draws' hook over processes (parallel/multihost.attach).
        self.global_batch = None

    def forward(self, features, generator: Optional[torch.Generator] = None):
        x = torch.as_tensor(features).to(self.compute_dtype)
        gen = None
        if self.training:
            if generator is None:
                raise ValueError("dropout in training needs a generator")
            gen = dropout_generator(x, generator)
        k = 0
        for _, rate in STAGES:
            for _ in range(2):
                x = getattr(self, f"BatchNorm_{k}")(
                    getattr(self, f"Conv_{k}")(x))
                x = torch.relu(x)
                k += 1
            x = max_pool(x, 2, 2)
            if gen is not None:
                x = dropout(x, rate, gen, self.global_batch)
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(self.Dense_0(x))
        if gen is not None:
            x = dropout(x, 0.5, gen, self.global_batch)
        return self.Dense_1(x).float()


def custom_model(device=None):
    return place(Cifar10Model(), device)


def loss(labels, predictions, mask):
    return masked_softmax_cross_entropy(labels, predictions, mask)


def optimizer(lr=0.1):
    return lambda params: torch.optim.SGD(params, lr=lr, momentum=0.9)


def lr_multiplier(model_version: int) -> float:
    """The reference's decay: 0.1 → 0.01 → 0.001 as a multiplier of the
    base rate."""
    if model_version < 200:
        return 1.0
    return 0.1 if model_version < 400 else 0.01


def callbacks():
    return [LearningRateScheduler(lr_multiplier)]


def dataset_fn(records, mode, metadata):
    return image_classification_dataset_fn(records, mode, metadata)


def eval_metrics_fn():
    return argmax_accuracy_metrics()
