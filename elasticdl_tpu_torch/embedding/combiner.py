"""Ragged id batches and combiner reductions (port of
elasticdl_tpu/embedding/combiner.py).

A ragged batch of ids is stored padded to ``(batch, max_ids)`` with
per-slot weights; weight 0 marks padding. Empty rows combine to the
zero vector, never NaN.
"""

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

COMBINERS = ("sum", "mean", "sqrtn")


@dataclass
class RaggedIds:
    """A padded ragged batch of embedding ids.

    ``ids``:     (batch, max_ids) int32, padded with 0,
    ``weights``: (batch, max_ids) float32, 0.0 on padded slots (1.0 on
    real slots for unweighted input).

    Either numpy arrays (as ``from_lists`` and a ``dataset_fn`` make
    them) or tensors (``to`` moves them to a device).
    """

    ids: Any
    weights: Any

    @classmethod
    def from_lists(
        cls,
        id_lists: Sequence[Sequence[int]],
        weight_lists: Optional[Sequence[Sequence[float]]] = None,
        max_ids: Optional[int] = None,
    ) -> "RaggedIds":
        """Pad a list of lists (host side, numpy) into a RaggedIds batch."""
        batch = len(id_lists)
        width = max_ids
        if width is None:
            width = max((len(r) for r in id_lists), default=1) or 1
        ids = np.zeros((batch, width), np.int32)
        weights = np.zeros((batch, width), np.float32)
        for i, row in enumerate(id_lists):
            row = list(row)
            if len(row) > width:
                raise ValueError(
                    f"row {i} has {len(row)} ids > max_ids={width}; "
                    "raise max_ids (silent truncation would drop features)"
                )
            n = len(row)
            ids[i, :n] = row
            if weight_lists is not None:
                weights[i, :n] = list(weight_lists[i])[:n]
            else:
                weights[i, :n] = 1.0
        return cls(ids=ids, weights=weights)

    @property
    def batch_size(self):
        return self.ids.shape[0]

    def to(self, device) -> "RaggedIds":
        """int32 ids and f32 weights as tensors on ``device``."""
        return RaggedIds(
            ids=torch.as_tensor(self.ids, device=device).to(torch.int32),
            weights=torch.as_tensor(self.weights,
                                    device=device).to(torch.float32),
        )


def combine(embeddings, weights, combiner: str):
    """Reduce per-slot embeddings ``(batch, max_ids, dim)`` with weights
    ``(batch, max_ids)`` to ``(batch, dim)``:

    sum   = Σ w·e
    mean  = Σ w·e / Σ w
    sqrtn = Σ w·e / sqrt(Σ w²)

    Empty rows (all weights 0) give zeros, not NaN.
    """
    if combiner not in COMBINERS:
        raise ValueError(
            f"combiner must be one of {COMBINERS}, got {combiner!r}"
        )
    summed = (embeddings * weights[..., None]).sum(dim=-2)
    if combiner == "sum":
        return summed
    if combiner == "mean":
        denom = weights.sum(dim=-1, keepdim=True)
    else:  # sqrtn
        denom = torch.sqrt((weights * weights).sum(dim=-1, keepdim=True))
    positive = denom > 0
    return torch.where(positive,
                       summed / torch.where(positive, denom, 1.0), 0.0)
