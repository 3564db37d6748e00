"""Census-income plain DNN — zoo twin of model_zoo/census/census_dnn.py.

The census feature pipeline of ``census_wide_deep.py`` (loaded by file
path, as the JAX module loads its sibling: zoo modules are loaded by
path, not as a package) under one deep tower: ``Embedding(22, 8)``
named ``embedding``, then a ``compute_dtype`` (bf16) MLP 34-32-16-1
(``Dense_0``-``Dense_2``). Adam at 1e-3.
"""

import os

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.core.model_spec import load_module
from elasticdl_tpu_torch.embedding.layer import Embedding
from elasticdl_tpu_torch.models.tabular import add_dense_layers, relu_mlp
from elasticdl_tpu_torch.ops.losses import masked_sigmoid_cross_entropy

_wide_deep = load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "census_wide_deep.py")
)
FEATURE_GROUP = _wide_deep.FEATURE_GROUP
_wide_deep_dataset_fn = _wide_deep.dataset_fn


class CensusDNN(nn.Module):
    def __init__(self, id_space: int = FEATURE_GROUP.total_buckets,
                 embedding_dim: int = 8, hidden=(32, 16),
                 compute_dtype=torch.bfloat16,
                 num_columns: int = len(FEATURE_GROUP.columns),
                 num_dense: int = len(_wide_deep.NUMERIC_KEYS)):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.embedding = Embedding(id_space, embedding_dim)
        self.mlp = add_dense_layers(
            self, num_columns * embedding_dim + num_dense,
            list(hidden) + [1], compute_dtype)

    def forward(self, features):
        ids = torch.as_tensor(features["ids"])
        dense = torch.as_tensor(features["dense"]).float()
        emb = self.embedding(ids)
        x = torch.cat([emb.reshape(emb.shape[0], -1).to(self.compute_dtype),
                       dense.to(self.compute_dtype)], dim=1)
        return relu_mlp(self.mlp, x).float()[..., 0]


def custom_model(device=None):
    return CensusDNN().to(resolve_device(device))


def loss(labels, predictions, mask):
    return masked_sigmoid_cross_entropy(labels, predictions, mask)


def optimizer(lr=0.001):
    return lambda params: torch.optim.Adam(params, lr=lr)


def dataset_fn(records, mode, metadata):
    return _wide_deep_dataset_fn(records, mode, metadata)


def eval_metrics_fn():
    def accuracy(labels, outputs):
        return float(np.mean((outputs > 0).astype(np.int32) == labels))

    return {"accuracy": accuracy}
