"""Pieces the DeepFM twins share: the FM second-order term, the deep
tower and the frappe record decode (each JAX zoo module spells them out
inline; the arithmetic here is theirs, step for step)."""

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.models.transformer import Dense


def fm_second_order(emb: torch.Tensor) -> torch.Tensor:
    """FM: 0.5 * ((Σ e)² − Σ e²) over the fields, summed over the width:
    (B, fields, k) -> (B, 1), in ``emb``'s dtype."""
    sum_emb = emb.sum(dim=1)
    sum_sq = (emb * emb).sum(dim=1)
    return 0.5 * (sum_emb * sum_emb - sum_sq).sum(dim=1, keepdim=True)


class DeepTower(nn.Module):
    """Dense + relu per hidden width, then Dense(1), each rounding as
    flax's ``Dense(dtype=compute_dtype)``; ``layers.k`` is flax's
    ``Dense_k``."""

    def __init__(self, in_features: int, hidden, compute_dtype):
        super().__init__()
        widths = [in_features] + list(hidden)
        self.layers = nn.ModuleList(
            [Dense(a, b, compute_dtype) for a, b in zip(widths, widths[1:])]
            + [Dense(widths[-1], 1, compute_dtype)])

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)


def read_frappe(records):
    """(ids (N, fields) int32, labels (N,) int32) of frappe record
    payloads {"feature_ids": [...], "label": 0 or 1}."""
    ids, labels = [], []
    for payload in records:
        rec = tensor_utils.loads(payload)
        ids.append(np.asarray(rec["feature_ids"], np.int32))
        labels.append(int(rec.get("label", 0)))
    return np.stack(ids), np.asarray(labels, np.int32)


def sign_agreement(labels, outputs) -> float:
    """Share of examples whose logit's sign matches the label."""
    return float(np.mean((outputs > 0) == (labels > 0)))
