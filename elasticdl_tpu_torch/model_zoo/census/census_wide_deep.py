"""Census-income Wide & Deep — zoo twin of
model_zoo/census/census_wide_deep.py (BASELINE #5, bench_suite.py's
``census`` config at B 512).

The host plane is the JAX module's: ``dataset_fn`` fuses the four
columns into ONE id space with the preprocessing package's
``FeatureGroup`` (22 ids) and standardizes the two numerics with fixed
census-scale constants, giving ``{"ids": (B, 4) int32, "dense": (B, 2)
f32}``. On the device: the wide tower, ``Embedding(22, 1)`` in f32 and
its sum over the columns; the deep tower, ``Embedding(22, 8)`` and a
``compute_dtype`` (bf16) MLP 34-16-8-1; the two logits summed in f32.
Submodules carry flax's names (``wide_weights``, ``deep_embedding``,
``Dense_0``-``Dense_2``). Adam at 1e-3 under the version schedule of
``lr_multiplier`` (0.3, then 0.2 from version 5000, 0.1 from 12000).
"""

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.callbacks import LearningRateScheduler
from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.embedding.layer import Embedding
from elasticdl_tpu_torch.models.tabular import add_dense_layers, relu_mlp
from elasticdl_tpu_torch.ops.losses import masked_sigmoid_cross_entropy
from elasticdl_tpu_torch.preprocessing import (
    CategoryLookup,
    FeatureGroup,
    NumericBucket,
)

EDUCATION_VOCAB = [
    "Bachelors", "HS-grad", "Masters", "Doctorate", "Some-college",
]
WORKCLASS_VOCAB = ["Private", "Self-emp", "Federal-gov", "Local-gov"]
AGE_BOUNDARIES = [25.0, 35.0, 45.0, 55.0, 65.0]
HOURS_BOUNDARIES = [20.0, 35.0, 45.0, 60.0]

FEATURE_GROUP = FeatureGroup([
    ("education", CategoryLookup(EDUCATION_VOCAB, num_oov_buckets=1)),
    ("workclass", CategoryLookup(WORKCLASS_VOCAB, num_oov_buckets=1)),
    ("age", NumericBucket(AGE_BOUNDARIES)),
    ("hours_per_week", NumericBucket(HOURS_BOUNDARIES)),
])
NUMERIC_KEYS = ("age", "hours_per_week")
EMBEDDING_DIM = 8


class WideAndDeep(nn.Module):
    def __init__(self, id_space: int = FEATURE_GROUP.total_buckets,
                 embedding_dim: int = EMBEDDING_DIM, hidden=(16, 8),
                 compute_dtype=torch.bfloat16,
                 num_columns: int = len(FEATURE_GROUP.columns),
                 num_dense: int = len(NUMERIC_KEYS)):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.wide_weights = Embedding(id_space, 1)
        self.deep_embedding = Embedding(id_space, embedding_dim)
        self.mlp = add_dense_layers(
            self, num_columns * embedding_dim + num_dense,
            list(hidden) + [1], compute_dtype)

    def forward(self, features):
        ids = torch.as_tensor(features["ids"])              # (B, C)
        dense = torch.as_tensor(features["dense"]).float()  # (B, D)
        # Wide: a learned scalar per category id (linear over one-hots).
        wide_logit = self.wide_weights(ids)[..., 0].sum(dim=1, keepdim=True)
        # Deep: shared embedding table + MLP over [embeddings, numerics].
        emb = self.deep_embedding(ids)
        deep = torch.cat([emb.reshape(emb.shape[0], -1)
                          .to(self.compute_dtype),
                          dense.to(self.compute_dtype)], dim=1)
        deep_logit = relu_mlp(self.mlp, deep)
        return (wide_logit.float() + deep_logit.float())[..., 0]


def custom_model(device=None):
    return WideAndDeep().to(resolve_device(device))


def loss(labels, predictions, mask):
    return masked_sigmoid_cross_entropy(labels, predictions, mask)


def optimizer(lr=0.001):
    return lambda params: torch.optim.Adam(params, lr=lr)


def lr_multiplier(model_version: int) -> float:
    """The reference's version-based decay (3e-4 -> 2e-4 -> 1e-4) as a
    multiplier of the base rate, 1e-3."""
    if model_version < 5000:
        return 0.3
    return 0.2 if model_version < 12000 else 0.1


def callbacks():
    return [LearningRateScheduler(lr_multiplier)]


def dataset_fn(records, mode, metadata):
    rows = [tensor_utils.loads(payload) for payload in records]
    raw = {
        key: np.asarray([row[key] for row in rows])
        for key in ("education", "workclass", "age", "hours_per_week")
    }
    ids = FEATURE_GROUP(raw).astype(np.int32)
    dense = np.stack(
        [np.asarray(raw[k], np.float32) for k in NUMERIC_KEYS], axis=1
    )
    # standardize numerics with fixed census-scale constants
    dense = (dense - np.asarray([38.0, 40.0], np.float32)) / np.asarray(
        [13.0, 12.0], np.float32
    )
    features = {"ids": ids, "dense": dense}
    labels = np.asarray([int(row.get("label", 0)) for row in rows], np.int32)
    if mode == Mode.PREDICTION:
        return features, np.zeros_like(labels)
    return features, labels


def eval_metrics_fn():
    def accuracy(labels, outputs):
        return float(np.mean((outputs > 0).astype(np.int32) == labels))

    return {"accuracy": accuracy}
