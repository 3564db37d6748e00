"""DeepFM over frappe-style sparse feature ids — zoo twin of
model_zoo/deepfm/deepfm_functional.py (BASELINE #4, bench_suite.py's
``deepfm`` config at B 512).

First-order linear + second-order FM interactions + a deep MLP over the
field embeddings. Both tables are the port's ``Embedding`` layer as
ordinary parameters, read with dense ids (a gather: no kernel), trained
with the MLP by dense Adam on the Local executor.
"""

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.embedding.layer import Embedding
from elasticdl_tpu_torch.model_zoo.deepfm.fm_layers import (
    DeepTower,
    fm_second_order,
    read_frappe,
)
from elasticdl_tpu_torch.ops.losses import masked_sigmoid_cross_entropy

INPUT_LENGTH = 10
MAX_ID = 5500
EMBEDDING_DIM = 16


class DeepFM(nn.Module):
    """(B, fields) ids -> logit: first order in f32, FM and the deep
    tower in ``compute_dtype``, summed in f32."""

    def __init__(self, input_dim: int = MAX_ID,
                 embedding_dim: int = EMBEDDING_DIM, hidden=(64, 32),
                 compute_dtype=torch.bfloat16, fields: int = INPUT_LENGTH):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.fm_embedding = Embedding(input_dim, embedding_dim)
        self.fm_linear = Embedding(input_dim, 1)
        self.deep = DeepTower(fields * embedding_dim, hidden, compute_dtype)

    def forward(self, features):
        ids = torch.as_tensor(features).to(torch.int32)
        emb = self.fm_embedding(ids).to(self.compute_dtype)
        lin = self.fm_linear(ids)
        first_order = lin[..., 0].sum(dim=1, keepdim=True)
        deep = self.deep(emb.reshape(emb.shape[0], -1))
        logits = (first_order.float() + fm_second_order(emb).float()
                  + deep.float())
        return logits[..., 0]


def custom_model(device=None):
    return DeepFM().to(resolve_device(device))


def loss(labels, predictions, mask):
    return masked_sigmoid_cross_entropy(labels, predictions, mask)


def optimizer(lr=0.001):
    return lambda params: torch.optim.Adam(params, lr=lr)


def dataset_fn(records, mode, metadata):
    features, labels = read_frappe(records)
    if mode == Mode.PREDICTION:
        return features, np.zeros_like(labels)
    return features, labels


def eval_metrics_fn():
    def accuracy(labels, outputs):
        return float(np.mean((outputs > 0).astype(np.int32) == labels))

    def auc(labels, outputs):
        order = np.argsort(outputs)
        ranks = np.empty_like(order, np.float64)
        ranks[order] = np.arange(1, len(outputs) + 1)
        pos = labels == 1
        n_pos, n_neg = int(pos.sum()), int((~pos).sum())
        if n_pos == 0 or n_neg == 0:
            return 0.5
        return float(
            (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
        )

    return {"accuracy": accuracy, "auc": auc}
