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
it, read once when the state is built. ``global_batch``: None, or,
over a mesh that spans processes, the hook through which the step reads
the global batch whose rows this process's batch is (set by the runner,
``parallel/multihost.attach``; not saved).

``batch_stats`` are the model's statistic buffers, by name: the
buffers that a training forward rewrites (the JAX state's
``batch_stats`` collection), read off the modules when the state is
built: a module's ``STATISTICS`` names them (``models/batch_norm.py``:
``mean`` and ``var``), and ``torch.nn`` BatchNorms have their running
statistics. The train step keeps their old values where the JAX step
keeps the old ``batch_stats`` (``core/step.py``).
"""

import inspect
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch
from torch import nn


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    model_takes_generator: bool = False
    step: int = 0
    batch_stats: Dict[str, torch.Tensor] = field(default_factory=dict)
    global_batch: Optional[object] = None

    @property
    def version(self) -> int:
        """Model version == number of optimizer applies."""
        return self.step

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def statistic_buffers(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{buffer name: buffer} of every statistic a training forward of
    ``model`` rewrites."""
    out = {}
    for prefix, module in model.named_modules():
        names = getattr(module, "STATISTICS", ())
        if isinstance(module, nn.modules.batchnorm._BatchNorm):
            names = ("running_mean", "running_var", "num_batches_tracked")
        for name in names:
            buf = getattr(module, name, None)
            if isinstance(buf, torch.Tensor):
                out[f"{prefix}.{name}" if prefix else name] = buf
    return out


def init_train_state(model: nn.Module,
                     make_optimizer: Callable[..., torch.optim.Optimizer],
                     seed: int = 0) -> TrainState:
    """The state around ``model`` (already built and on its device) with
    the optimizer ``make_optimizer(params)``."""
    generator = torch.Generator().manual_seed(int(seed))
    try:
        takes = "generator" in inspect.signature(model.forward).parameters
    except (TypeError, ValueError):
        takes = False
    return TrainState(model=model,
                      optimizer=make_optimizer(model.parameters()),
                      generator=generator, model_takes_generator=takes,
                      batch_stats=statistic_buffers(model))
