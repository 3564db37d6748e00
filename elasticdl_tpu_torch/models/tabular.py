"""What the tabular zoo twins (census, heart, iris) share: the flax-named
MLP.

A flax module that calls ``nn.Dense`` in a loop names the layers
``Dense_0``, ``Dense_1``, ... on itself; ``add_dense_layers`` registers
``models.transformer.Dense`` layers (flax's rounding) under the same
names on the twin, so ``bridge.flax_state_dict`` maps the JAX params by
path.
"""

from typing import List, Sequence

import torch
from torch import nn

from elasticdl_tpu_torch.models.transformer import Dense


def add_dense_layers(module: nn.Module, in_features: int,
                     widths: Sequence[int], dtype) -> List[Dense]:
    """``Dense_k`` (``in -> widths[k]``) on ``module``, in order."""
    layers = []
    sizes = [in_features] + list(widths)
    for k, (a, b) in enumerate(zip(sizes, sizes[1:])):
        layer = Dense(a, b, dtype)
        module.add_module(f"Dense_{k}", layer)
        layers.append(layer)
    return layers


def relu_mlp(layers: Sequence[Dense], x: torch.Tensor) -> torch.Tensor:
    """relu after every layer but the last."""
    for layer in layers[:-1]:
        x = torch.relu(layer(x))
    return layers[-1](x)

