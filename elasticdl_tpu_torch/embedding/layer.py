"""The ``Embedding`` layer of the in-HBM tier (port of
elasticdl_tpu/embedding/layer.py).

One module owns its (input_dim, output_dim) table as a parameter.

- Int ids of any shape -> embeddings with a trailing ``output_dim``
  axis (a plain gather).
- ``RaggedIds`` + ``combiner`` -> (batch, output_dim) combined rows:
  the lookup kernel (#6, through its autograd function) with
  ``pallas=True``, the library gather + ``combine`` otherwise.
"""

from typing import Callable, Optional

import torch
from torch import nn

from elasticdl_tpu_torch.embedding.combiner import RaggedIds, combine

# Keras Embedding's default init, RandomUniform(-0.05, 0.05), as the
# reference's parameter server initialises rows.
EMBEDDING_INIT_SCALE = 0.05

# The parameter name the partition pass matches on (``self.embedding``).
EMBEDDING_PARAM_NAME = "embedding"


def embedding_init(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype).uniform_(-EMBEDDING_INIT_SCALE,
                                                    EMBEDDING_INIT_SCALE)


class Embedding(nn.Module):
    """Embedding lookup with an optional ragged-input combiner.

    ``input_dim``   — vocabulary size (rows),
    ``output_dim``  — embedding width,
    ``combiner``    — sum | mean | sqrtn, required for RaggedIds input,
    ``initializer`` — ``(shape, dtype) -> tensor``; None is uniform ±0.05,
    ``pallas``      — the ragged path's kernel: None = auto (the library
    route: ``use_pallas_lookup`` is False), True pins the lookup kernel,
    False the library route.
    """

    def __init__(self, input_dim: int, output_dim: int,
                 combiner: Optional[str] = None,
                 initializer: Optional[Callable] = None,
                 pallas: Optional[bool] = None):
        super().__init__()
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.combiner = combiner
        self.pallas = pallas
        init = initializer or embedding_init
        self.embedding = nn.Parameter(init((input_dim, output_dim),
                                           torch.float32))

    def _use_pallas(self, table, ids) -> bool:
        from elasticdl_tpu_torch.ops.pallas_embedding import (
            use_pallas_lookup,
        )

        if self.pallas is not None:
            return self.pallas
        return use_pallas_lookup(table.shape[1], ids.shape[1])

    def forward(self, ids):
        table = self.embedding
        if isinstance(ids, RaggedIds):
            if self.combiner is None:
                raise ValueError("RaggedIds input requires a combiner")
            ragged = ids.to(table.device)
            if self._use_pallas(table, ragged.ids):
                from elasticdl_tpu_torch.ops.pallas_embedding import (
                    lookup_combine,
                )

                return lookup_combine(table, ragged.ids, ragged.weights,
                                      self.combiner, force_pallas=True)
            rows = table[ragged.ids.long()]
            return combine(rows, ragged.weights, self.combiner)
        ids = torch.as_tensor(ids, device=table.device)
        return table[ids.long()]
