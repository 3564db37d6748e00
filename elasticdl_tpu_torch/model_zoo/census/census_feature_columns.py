"""Census-income DNN built from the feature-column API — zoo twin of
model_zoo/census/census_feature_columns.py.

Two numeric columns (standardized by their ``normalizer_fn``) and two
``embedding_column(categorical_column_with_hash_bucket(key, 64), 8)``
(mean combiner) declared as feature columns: the host plane runs
``apply_host_transforms`` in ``dataset_fn`` (the strings hash to stable
int32s there), the device plane is the ``DenseFeatures`` module named
``features`` (tables ``features.{key}_embedding.embedding``), then a
``compute_dtype`` (bf16) MLP 18-32-16-1. Adam at 1e-3.
"""

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.models.tabular import add_dense_layers, relu_mlp
from elasticdl_tpu_torch.ops.losses import masked_sigmoid_cross_entropy
from elasticdl_tpu_torch.preprocessing import (
    DenseFeatures,
    apply_host_transforms,
    categorical_column_with_hash_bucket,
    embedding_column,
    numeric_column,
)

CATEGORICAL_KEYS = ("education", "workclass")
NUMERIC_KEYS = ("age", "hours_per_week")
# Fixed census-scale standardization, as in census_wide_deep.py.
_NUMERIC_SCALE = {"age": (38.0, 13.0), "hours_per_week": (40.0, 12.0)}


def _columns():
    cols = []
    for key in NUMERIC_KEYS:
        mean, scale = _NUMERIC_SCALE[key]
        cols.append(numeric_column(
            key, normalizer_fn=lambda v, m=mean, s=scale: (v - m) / s
        ))
    for key in CATEGORICAL_KEYS:
        cols.append(embedding_column(
            categorical_column_with_hash_bucket(key, 64), dimension=8
        ))
    return cols


COLUMNS = _columns()


class CensusColumnsDNN(nn.Module):
    def __init__(self, hidden=(32, 16), compute_dtype=torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.features = DenseFeatures(COLUMNS)
        width = sum(c.output_dim for c in COLUMNS)
        self.mlp = add_dense_layers(self, width, list(hidden) + [1],
                                    compute_dtype)

    def forward(self, features):
        x = self.features(features).to(self.compute_dtype)
        return relu_mlp(self.mlp, x).float()[..., 0]


def custom_model(device=None):
    return CensusColumnsDNN().to(resolve_device(device))


def loss(labels, predictions, mask):
    return masked_sigmoid_cross_entropy(labels, predictions, mask)


def optimizer(lr=0.001):
    return lambda params: torch.optim.Adam(params, lr=lr)


def dataset_fn(records, mode, metadata):
    rows = [tensor_utils.loads(payload) for payload in records]
    raw = {
        key: np.asarray([row[key] for row in rows])
        for key in CATEGORICAL_KEYS + NUMERIC_KEYS
    }
    features = apply_host_transforms(COLUMNS, raw)
    labels = np.asarray(
        [int(row.get("label", 0)) for row in rows], np.int32
    )
    if mode == Mode.PREDICTION:
        return features, np.zeros_like(labels)
    return features, labels


def eval_metrics_fn():
    def accuracy(labels, outputs):
        return float(np.mean((outputs > 0).astype(np.int32) == labels))

    return {"accuracy": accuracy}
