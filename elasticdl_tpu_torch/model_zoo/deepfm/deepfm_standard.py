"""DeepFM with standard (unsharded) embedding tables — zoo twin of
model_zoo/deepfm/deepfm_standard.py: ``PlacedEmbedding`` (an
``nn.Embedding`` whose table a ``MeshRunner`` may split by rows, as
JAX's partitions a table over 2 MB) for flax's ``nn.Embed``,
initialised as flax's default (truncated normal, standard
deviation 1/sqrt(width)). The first-order sum, the FM term and the deep
tower add in ``compute_dtype``; the logit is cast to f32 at the end.
"""

import math

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.model_zoo.deepfm.fm_layers import (
    DeepTower,
    fm_second_order,
    read_frappe,
)
from elasticdl_tpu_torch.ops.losses import masked_sigmoid_cross_entropy
from elasticdl_tpu_torch.parallel.tensor_parallel import PlacedEmbedding

INPUT_LENGTH = 10
MAX_ID = 5500
EMBEDDING_DIM = 16


def _embed(vocab: int, width: int) -> PlacedEmbedding:
    """flax's ``default_embed_init``: variance_scaling(1, fan_in,
    truncated normal) over a (vocab, width) table, fan_in = width."""
    table = PlacedEmbedding(vocab, width)
    std = math.sqrt(1.0 / width) / 0.87962566103423978
    nn.init.trunc_normal_(table.weight, std=std, a=-2 * std, b=2 * std)
    return table


class DeepFMStandard(nn.Module):
    def __init__(self, input_dim: int = MAX_ID,
                 embedding_dim: int = EMBEDDING_DIM, hidden=(64, 32),
                 compute_dtype=torch.bfloat16, fields: int = INPUT_LENGTH):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.fm_embedding = _embed(input_dim, embedding_dim)
        self.fm_linear = _embed(input_dim, 1)
        self.deep = DeepTower(fields * embedding_dim, hidden, compute_dtype)

    def forward(self, features):
        ids = torch.as_tensor(features).long()
        emb = self.fm_embedding(ids).to(self.compute_dtype)
        lin = self.fm_linear(ids).to(self.compute_dtype)
        deep = self.deep(emb.reshape(emb.shape[0], -1))
        logit = lin.sum(dim=1) + fm_second_order(emb) + deep
        return logit[:, 0].float()


def custom_model(device=None):
    return DeepFMStandard().to(resolve_device(device))


def loss(labels, predictions, mask):
    return masked_sigmoid_cross_entropy(labels, predictions, mask)


def optimizer(lr=0.001):
    return lambda params: torch.optim.Adam(params, lr=lr)


def dataset_fn(records, mode, metadata):
    features, labels = read_frappe(records)
    labels = labels.astype(np.float32)
    if mode == Mode.PREDICTION:
        return features, np.zeros_like(labels)
    return features, labels


def eval_metrics_fn():
    def accuracy(labels, outputs):
        return float(np.mean((outputs > 0).astype(np.float32) == labels))

    return {"accuracy": accuracy}
