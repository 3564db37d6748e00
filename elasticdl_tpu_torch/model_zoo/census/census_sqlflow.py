"""Census wide&deep built from a declarative column spec — zoo twin of
model_zoo/census/census_sqlflow.py.

The spec is a list of (name, transform, towers) tuples, the "COLUMN
clauses" a SQLFlow statement generates; the model and the host-plane
``dataset_fn`` both derive from it. Features are a bare (B, 4) id
array over the fused id space (22 ids), labels float32. The wide tower
is the top-level parameter ``wide_weights`` (22, 1), initialised to
zeros and summed over the wide slots in f32; the deep tower is flax's
``nn.Embed`` (``deep_embedding``: a (22, 8) table drawn as flax draws
it, a truncated normal of standard deviation 1/sqrt(8)) cast to
``compute_dtype`` (bf16), then an MLP 32-16-8-1. Adam at 1e-3.
"""

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.embedding.layer import Embedding
from elasticdl_tpu_torch.models.tabular import add_dense_layers, relu_mlp
from elasticdl_tpu_torch.models.vision import lecun_normal_
from elasticdl_tpu_torch.ops.losses import masked_sigmoid_cross_entropy
from elasticdl_tpu_torch.preprocessing import (
    CategoryLookup,
    FeatureGroup,
    NumericBucket,
)

# (column, transform, towers) — the declarative spec ("COLUMN clauses").
WIDE, DEEP = "wide", "deep"
COLUMNS = [
    ("education",
     CategoryLookup(["Bachelors", "HS-grad", "Masters", "Doctorate",
                     "Some-college"], num_oov_buckets=1),
     (WIDE, DEEP)),
    ("workclass",
     CategoryLookup(["Private", "Self-emp", "Federal-gov", "Local-gov"],
                    num_oov_buckets=1),
     (WIDE, DEEP)),
    ("age", NumericBucket([25.0, 35.0, 45.0, 55.0, 65.0]), (WIDE, DEEP)),
    ("hours_per_week", NumericBucket([20.0, 35.0, 45.0, 60.0]),
     (WIDE, DEEP)),
]
NUMERIC_KEYS = ("age", "hours_per_week")

FEATURE_GROUP = FeatureGroup([(c, t) for c, t, _ in COLUMNS])
WIDE_SLOTS = tuple(
    i for i, (_, _, towers) in enumerate(COLUMNS) if WIDE in towers
)
DEEP_SLOTS = tuple(
    i for i, (_, _, towers) in enumerate(COLUMNS) if DEEP in towers
)
EMBEDDING_DIM = 8


def flax_embed_init(shape, dtype=torch.float32):
    """flax's ``default_embed_init``: variance_scaling(1, fan_in,
    truncated normal) over a (vocab, width) table, fan_in = width."""
    return lecun_normal_(torch.empty(shape, dtype=dtype), shape[1])


class SqlflowWideAndDeep(nn.Module):
    def __init__(self, id_space: int = FEATURE_GROUP.total_buckets,
                 embedding_dim: int = EMBEDDING_DIM, hidden=(16, 8),
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.wide_weights = nn.Parameter(torch.zeros(id_space, 1))
        self.deep_embedding = Embedding(id_space, embedding_dim,
                                        initializer=flax_embed_init)
        self.mlp = add_dense_layers(self, len(DEEP_SLOTS) * embedding_dim,
                                    list(hidden) + [1], compute_dtype)
        # The slots' indices live on the model's device (no copy a step).
        self.register_buffer("wide_slots", torch.tensor(WIDE_SLOTS),
                             persistent=False)
        self.register_buffer("deep_slots", torch.tensor(DEEP_SLOTS),
                             persistent=False)

    def forward(self, features):
        ids = torch.as_tensor(features).long()  # (B, num_columns)
        # Wide tower: one-hot linear over the fused id space.
        wide = self.wide_weights[ids[:, self.wide_slots]].sum(dim=1)
        # Deep tower: embeddings of the deep slots, concatenated.
        emb = self.deep_embedding(ids[:, self.deep_slots]).to(
            self.compute_dtype)
        deep = relu_mlp(self.mlp, emb.reshape(emb.shape[0], -1))
        return (wide + deep)[:, 0].float()


def custom_model(device=None):
    return SqlflowWideAndDeep().to(resolve_device(device))


def loss(labels, predictions, mask):
    return masked_sigmoid_cross_entropy(labels, predictions, mask)


def optimizer(lr=0.001):
    return lambda params: torch.optim.Adam(params, lr=lr)


def dataset_fn(records, mode, metadata):
    rows = [tensor_utils.loads(p) for p in records]
    raw = {
        key: np.asarray([row[key] for row in rows])
        for key, _, _ in COLUMNS
    }
    ids = FEATURE_GROUP(raw).astype(np.int32)
    labels = np.asarray(
        [float(r.get("label", 0)) for r in rows], np.float32
    )
    if mode == Mode.PREDICTION:
        return ids, np.zeros_like(labels)
    return ids, labels


def eval_metrics_fn():
    def accuracy(labels, outputs):
        return float(np.mean((outputs > 0).astype(np.float32) == labels))

    return {"accuracy": accuracy}
