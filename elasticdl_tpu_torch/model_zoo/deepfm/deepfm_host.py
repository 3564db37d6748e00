"""DeepFM with its embedding table on the HOST tier — zoo twin of
model_zoo/deepfm/deepfm_host.py, at its widths.

The reference's deepfm_edl_embedding kept its table on parameter-server
pods; this is that deployment in one process: the table lives in host
RAM (the C++ row store when it builds), each batch's rows are pulled as
a bucket-padded block and their gradients applied back
(``embedding/host_engine.py``). The executor picks ``make_host_runner``
up by name. Several worker processes share one table through a row
service (``make_row_service``, ``make_host_runner(remote_addr=...)``).
Rows train with SGD at lr 0.05, the MLP with Adam at 1e-3, bf16
compute. ``--output`` bundles the table dense up to
``host_serving_vocab``; ``export_serving_bundle(host_id_keys=...)``
bundles it for serving from a row service instead.

Records are frappe payloads {"feature_ids": [INPUT_LENGTH ints in
[0, MAX_ID)], "label": 0 or 1} (``testing.data.create_frappe_record_file``).
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

INPUT_LENGTH = 10
MAX_ID = 5500
EMBEDDING_DIM = 16
TABLE_NAME = "deepfm_host_embedding"
FEATURE_KEY = "feature_ids"
# The serving export materialises the host table dense up to this vocab
# (``SavedModelExporter``); a served batch's raw ids index it.
host_serving_vocab = {TABLE_NAME: MAX_ID}


class HostDeepFM(nn.Module):
    """The (B, fields, D) rows from the host block, cast to
    ``compute_dtype``; FM second order + the deep tower, summed in f32."""

    def __init__(self, embedding_dim: int = EMBEDDING_DIM,
                 hidden=(64, 32), compute_dtype=torch.bfloat16,
                 fields: int = INPUT_LENGTH):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.emb = HostEmbedding(TABLE_NAME, embedding_dim)
        self.deep = DeepTower(fields * embedding_dim, hidden, compute_dtype)

    def forward(self, features, host_rows=None):
        emb = self.emb(features[FEATURE_KEY], host_rows)
        emb = emb.to(self.compute_dtype)
        deep = self.deep(emb.reshape(emb.shape[0], -1))
        logits = fm_second_order(emb).float() + deep.float()
        return logits[..., 0]


def custom_model(device=None):
    return HostDeepFM().to(resolve_device(device))


def make_host_runner(row_lr: float = 0.05,
                     remote_addr: str = "") -> HostStepRunner:
    """The runner holding the host table (native when it builds), its
    rows trained by SGD at ``row_lr``. ``remote_addr`` points at a
    shared ``HostRowService`` for multi-process jobs
    (``--row_service_addr``); the service then owns the rows and their
    checkpoints."""
    if remote_addr:
        from elasticdl_tpu_torch.embedding.row_service import (
            make_remote_engine,
        )

        return HostStepRunner(make_remote_engine(
            remote_addr, id_keys={TABLE_NAME: FEATURE_KEY}))
    from elasticdl_tpu_torch.native.row_store import (
        make_host_optimizer,
        make_host_table,
    )

    engine = HostEmbeddingEngine(
        {TABLE_NAME: make_host_table(TABLE_NAME, EMBEDDING_DIM)},
        make_host_optimizer(SGD(lr=row_lr)),
        id_keys={TABLE_NAME: FEATURE_KEY},
    )
    return HostStepRunner(engine)


def make_row_service():
    """The server side of a multi-process job: run it in its own process
    (``python -m elasticdl_tpu_torch.embedding.row_service``) or
    ``.start(addr)`` it. Its table sits in host RAM; rows train with SGD
    at 0.05."""
    from elasticdl_tpu_torch.embedding.row_service import HostRowService
    from elasticdl_tpu_torch.native.row_store import (
        make_host_optimizer,
        make_host_table,
    )

    return HostRowService(
        {TABLE_NAME: make_host_table(TABLE_NAME, EMBEDDING_DIM)},
        make_host_optimizer(SGD(lr=0.05)),
    )


def loss(labels, predictions, mask):
    return masked_sigmoid_cross_entropy(labels, predictions, mask)


def optimizer(lr=0.001):
    return lambda params: torch.optim.Adam(params, lr=lr)


def dataset_fn(records, mode, metadata):
    ids, labels = read_frappe(records)
    features = {FEATURE_KEY: ids}
    if mode == Mode.PREDICTION:
        return features, np.zeros_like(labels)
    return features, labels


def eval_metrics_fn():
    return {"auc_proxy": sign_agreement}
