"""DeepFM with THREE host-tier tables (field groups) — zoo twin of
model_zoo/deepfm/deepfm_host_multi.py.

The frappe record's 10 id columns split into user, item and context
groups, each on its own host table, which exercises the engine's
per-table loop. Id values may repeat across groups: the tables are
independent row spaces. Same records as deepfm_host.
"""

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.embedding.host_engine import (
    HostEmbedding,
    HostEmbeddingEngine,
    HostStepRunner,
)
from elasticdl_tpu_torch.embedding.optimizer import SGD
from elasticdl_tpu_torch.model_zoo.deepfm.fm_layers import (
    DeepTower,
    fm_second_order,
    read_frappe,
    sign_agreement,
)
from elasticdl_tpu_torch.ops.losses import masked_sigmoid_cross_entropy

MAX_ID = 5500
EMBEDDING_DIM = 16
# Field groups: {table: (feature key, column slice of feature_ids)}.
FIELD_GROUPS = {
    "host_emb_user": ("ids_user", (0, 4)),
    "host_emb_item": ("ids_item", (4, 7)),
    "host_emb_ctx": ("ids_ctx", (7, 10)),
}
# The serving export materialises each table dense up to this vocab.
host_serving_vocab = {name: MAX_ID for name in FIELD_GROUPS}


class HostDeepFMMulti(nn.Module):
    def __init__(self, embedding_dim: int = EMBEDDING_DIM,
                 hidden=(64, 32), compute_dtype=torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.groups = nn.ModuleList(
            [HostEmbedding(name, embedding_dim) for name in FIELD_GROUPS])
        fields = sum(hi - lo for _, (lo, hi) in FIELD_GROUPS.values())
        self.deep = DeepTower(fields * embedding_dim, hidden, compute_dtype)

    def forward(self, features, host_rows=None):
        emb = torch.cat(
            [group(features[key], host_rows) for group, (key, _) in
             zip(self.groups, FIELD_GROUPS.values())], dim=1)  # (B, 10, D)
        emb = emb.to(self.compute_dtype)
        deep = self.deep(emb.reshape(emb.shape[0], -1))
        logits = fm_second_order(emb).float() + deep.float()
        return logits[..., 0]


def custom_model(device=None):
    return HostDeepFMMulti().to(resolve_device(device))


def _make_tables():
    from elasticdl_tpu_torch.native.row_store import make_host_table

    return {name: make_host_table(name, EMBEDDING_DIM)
            for name in FIELD_GROUPS}


def make_host_runner(row_lr: float = 0.05,
                     remote_addr: str = "") -> HostStepRunner:
    """The three host tables in this process, or (``remote_addr``) on a
    shared row service."""
    id_keys = {name: key for name, (key, _) in FIELD_GROUPS.items()}
    if remote_addr:
        from elasticdl_tpu_torch.embedding.row_service import (
            make_remote_engine,
        )

        return HostStepRunner(make_remote_engine(remote_addr,
                                                 id_keys=id_keys))
    from elasticdl_tpu_torch.native.row_store import make_host_optimizer

    engine = HostEmbeddingEngine(
        _make_tables(), make_host_optimizer(SGD(lr=row_lr)),
        id_keys=id_keys,
    )
    return HostStepRunner(engine)


def make_row_service():
    """The server side of a multi-process job: the three tables and SGD
    rows at 0.05."""
    from elasticdl_tpu_torch.embedding.row_service import HostRowService
    from elasticdl_tpu_torch.native.row_store import make_host_optimizer

    return HostRowService(_make_tables(), make_host_optimizer(SGD(lr=0.05)))


def loss(labels, predictions, mask):
    return masked_sigmoid_cross_entropy(labels, predictions, mask)


def optimizer(lr=0.001):
    return lambda params: torch.optim.Adam(params, lr=lr)


def dataset_fn(records, mode, metadata):
    all_ids, labels = read_frappe(records)
    features = {key: all_ids[:, lo:hi]
                for key, (lo, hi) in FIELD_GROUPS.values()}
    if mode == Mode.PREDICTION:
        return features, np.zeros_like(labels)
    return features, labels


def eval_metrics_fn():
    return {"auc_proxy": sign_agreement}
