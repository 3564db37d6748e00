"""Training state: module + optimizer + model version (port of
elasticdl_tpu/core/train_state.py).

PyTorch keeps parameters and optimizer slots inside the module and the
optimizer and updates them in place, so the state is a small host
object around them. ``step`` doubles as the model version (one
optimizer apply = one version). ``generator`` is an explicit CPU
``torch.Generator`` seeded from ``--random_seed``; the step hands it to
the model, which draws each block's dropout seed from it (this
replaces the JAX state's ``rng`` and ``next_rng``);
``model_takes_generator`` says whether the model's ``forward`` takes
it, read once when the state is built.
"""

import inspect
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    model_takes_generator: bool = False
    step: int = 0

    @property
    def version(self) -> int:
        """Model version == number of optimizer applies."""
        return self.step

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def init_train_state(model: nn.Module,
                     make_optimizer: Callable[..., torch.optim.Optimizer],
                     seed: int = 0) -> TrainState:
    """The state around ``model`` (already built and on its device) with
    the optimizer ``make_optimizer(params)``. Models with BatchNorm
    statistics wait for the slice that ports them."""
    if any(isinstance(m, nn.modules.batchnorm._BatchNorm)
           for m in model.modules()):
        raise NotImplementedError(
            "BatchNorm statistics (batch_stats) are not ported yet"
        )
    generator = torch.Generator().manual_seed(int(seed))
    try:
        takes = "generator" in inspect.signature(model.forward).parameters
    except (TypeError, ValueError):
        takes = False
    return TrainState(model=model,
                      optimizer=make_optimizer(model.parameters()),
                      generator=generator, model_takes_generator=takes)
