"""Large-vocabulary recsys ranker on the device-tier sparse plane — zoo
twin of model_zoo/recsys/recsys_sparse.py: the model, its loss,
optimizer, dataset, eval metrics and sparse-runner factory under the zoo
contract's names.

A million-row embedding table trained sparsely: the table lives in the
card's memory, the forward reads only the looked-up rows, the backward
gives gradients of only the batch's unique ids, and Adagrad updates just
those rows (``embedding.device_sparse.DeviceSparseRunner``). The dense
MLP trains with Adam.

Records are msgpack payloads {"feature_ids": [INPUT_LENGTH ints],
"label": 0 or 1} (``testing.data.create_frappe_record_file`` with
``input_length=32, max_id=1_000_000``).
"""

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.embedding.device_sparse import (
    DeviceSparseRunner,
    SparseEmbed,
    TableSpec,
)
from elasticdl_tpu_torch.embedding.optimizer import Adagrad
from elasticdl_tpu_torch.models.transformer import Dense
from elasticdl_tpu_torch.ops.losses import masked_sigmoid_cross_entropy

VOCAB = 1_000_000
DIM = 256
INPUT_LENGTH = 32  # ids per example (padded-ragged width)
TABLE_NAME = "item_emb"
FEATURE_KEY = "ids"

TABLE_SPECS = (
    TableSpec(
        name=TABLE_NAME, vocab=VOCAB, dim=DIM, combiner="sum",
        feature_key=FEATURE_KEY,
    ),
)


class RecsysRanker(nn.Module):
    """Combined item embedding -> MLP -> click logit.

    The (B, emb_dim) f32 embedding comes from the sparse runner and is
    cast to ``compute_dtype`` here (so its gradient returns through that
    cast); the hidden Dense layers round as flax's ``Dense(dtype=...)``
    (input, kernel and bias in ``compute_dtype``); the last Dense is f32.
    ``compute_dtype`` is a constructor argument, so a test can build the
    model in f32. ``layers.k`` is flax's ``Dense_k``."""

    def __init__(self, hidden=(256, 128), compute_dtype=torch.bfloat16,
                 table_name: str = TABLE_NAME, emb_dim: int = DIM):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.table_name = table_name
        self.emb = SparseEmbed(table_name, emb_dim)
        widths = [emb_dim] + list(hidden)
        self.layers = nn.ModuleList(
            [Dense(a, b, compute_dtype) for a, b in zip(widths, widths[1:])]
            + [Dense(widths[-1], 1, torch.float32)])

    def forward(self, features, sparse_emb=None):
        x = self.emb(sparse_emb).to(self.compute_dtype)
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)[..., 0]


def custom_model(device=None):
    # The module globals are read at call time (not bound as defaults),
    # so a test's monkeypatch of VOCAB/DIM takes effect.
    return RecsysRanker(table_name=TABLE_NAME, emb_dim=DIM).to(
        resolve_device(device))


class RecsysRankerDense(nn.Module):
    """Dense-embedding control: the same ranker with the (VOCAB, DIM)
    table as an ordinary parameter trained by the dense optimizer — what
    training this model without the sparse plane costs (a dense (V, D)
    gradient and optimizer traffic over the whole table every step)."""

    def __init__(self, hidden=(256, 128), compute_dtype=torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.item_emb = nn.Parameter(torch.randn(VOCAB, DIM) / np.sqrt(DIM))
        widths = [DIM] + list(hidden)
        self.layers = nn.ModuleList(
            [Dense(a, b, compute_dtype) for a, b in zip(widths, widths[1:])]
            + [Dense(widths[-1], 1, torch.float32)])

    def forward(self, features):
        ids = torch.as_tensor(features[FEATURE_KEY]).long()
        x = self.item_emb[ids].sum(dim=1).to(self.compute_dtype)
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)[..., 0]


def dense_model(device=None):
    return RecsysRankerDense().to(resolve_device(device))


def loss(labels, predictions, mask):
    return masked_sigmoid_cross_entropy(labels, predictions, mask)


def optimizer(lr=0.001):
    return lambda params: torch.optim.Adam(params, lr=lr)


def make_sparse_runner(use_pallas: str = "auto",
                       packed_slots: bool = False) -> DeviceSparseRunner:
    """Step-runner factory: Adagrad rows at lr 0.05 (the reference
    parameter server's canonical sparse optimizer). ``use_pallas``
    "always" pins the lookup and row-update kernels on every step;
    ``packed_slots`` keeps the accumulator inside the table's rows."""
    return DeviceSparseRunner(
        TABLE_SPECS, Adagrad(lr=0.05), use_pallas=use_pallas,
        packed_slots=packed_slots,
    )


def dataset_fn(records, mode, metadata):
    ids, labels = [], []
    for payload in records:
        rec = tensor_utils.loads(payload)
        ids.append(np.asarray(rec["feature_ids"], np.int64))
        labels.append(int(rec.get("label", 0)))
    features = {FEATURE_KEY: np.stack(ids)}
    labels = np.asarray(labels, np.int32)
    if mode == Mode.PREDICTION:
        return features, np.zeros_like(labels)
    return features, labels


def eval_metrics_fn():
    def accuracy(labels, outputs):
        return float(np.mean((outputs > 0).astype(np.int32) == labels))

    return {"accuracy": accuracy}
