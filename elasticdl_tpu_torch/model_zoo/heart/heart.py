"""Heart-disease classifier over mixed features — zoo twin of
model_zoo/heart/heart.py.

Six numeric columns scaled by fixed clinical constants, ``age``
bucketized on the device by the preprocessing package's
``Discretization`` (10 boundaries) into an 11-way one-hot (an id outside
the range would give a zero row, as ``jax.nn.one_hot`` does), and the
``thal`` string hashed on the host (``CategoryHash(100)``) into an
8-wide ``Embedding`` (``thal_embedding``). The three concatenate in f32,
then a ``compute_dtype`` (bf16) MLP 25-16-16-1. SGD at 0.01.
"""

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.embedding.layer import Embedding
from elasticdl_tpu_torch.models.tabular import add_dense_layers, relu_mlp
from elasticdl_tpu_torch.ops.losses import masked_sigmoid_cross_entropy
from elasticdl_tpu_torch.preprocessing import CategoryHash, Discretization
from elasticdl_tpu_torch.preprocessing.layers import one_hot

NUMERIC_KEYS = ("trestbps", "chol", "thalach", "oldpeak", "slope", "ca")
AGE_BOUNDARIES = [18.0, 25.0, 30.0, 35.0, 40.0, 45.0, 50.0, 55.0, 60.0, 65.0]
THAL_HASH_BUCKETS = 100
THAL_HASH = CategoryHash(THAL_HASH_BUCKETS)

# One instance for every model and device: it keeps its boundaries on
# each device it has run on.
_AGE_BUCKETIZE = Discretization(AGE_BOUNDARIES)


class HeartModel(nn.Module):
    def __init__(self, thal_buckets: int = THAL_HASH_BUCKETS,
                 thal_dim: int = 8, compute_dtype=torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.thal_embedding = Embedding(thal_buckets, thal_dim)
        width = len(NUMERIC_KEYS) + _AGE_BUCKETIZE.num_buckets + thal_dim
        self.mlp = add_dense_layers(self, width, [16, 16, 1], compute_dtype)

    def forward(self, features):
        dense = torch.as_tensor(features["numeric"]).float()
        age_bucket = _AGE_BUCKETIZE(features["age"])       # (B,) int ids
        age_onehot = one_hot(age_bucket, _AGE_BUCKETIZE.num_buckets)
        thal = self.thal_embedding(torch.as_tensor(features["thal_id"]))
        x = torch.cat([dense, age_onehot, thal.float()], dim=1).to(
            self.compute_dtype)
        return relu_mlp(self.mlp, x).float()[..., 0]


def custom_model(device=None):
    return HeartModel().to(resolve_device(device))


def loss(labels, predictions, mask):
    return masked_sigmoid_cross_entropy(labels, predictions, mask)


def optimizer(lr=0.01):
    return lambda params: torch.optim.SGD(params, lr=lr)


def dataset_fn(records, mode, metadata):
    rows = [tensor_utils.loads(payload) for payload in records]
    numeric = np.stack(
        [np.asarray([float(row[k]) for k in NUMERIC_KEYS], np.float32)
         for row in rows]
    )
    # scale numerics to unit-ish range (fixed clinical-scale constants)
    numeric = numeric / np.asarray(
        [130.0, 250.0, 150.0, 1.0, 2.0, 1.0], np.float32
    )
    features = {
        "numeric": numeric,
        "age": np.asarray([float(row["age"]) for row in rows], np.float32),
        "thal_id": THAL_HASH([row["thal"] for row in rows]).astype(np.int32),
    }
    labels = np.asarray(
        [int(row.get("target", 0)) for row in rows], np.int32
    )
    if mode == Mode.PREDICTION:
        return features, np.zeros_like(labels)
    return features, labels


def eval_metrics_fn():
    def accuracy(labels, outputs):
        return float(np.mean((outputs > 0).astype(np.int32) == labels))

    return {"accuracy": accuracy}
