"""Iris DNN over CSV rows — zoo twin of model_zoo/iris/iris_dnn.py.

Records arrive as raw CSV lines from ``CSVDataReader``;
``metadata.column_names`` and ``metadata.extra["sep"]`` drive the parse,
as in the JAX module. An f32 MLP 4-16-16-3 (``Dense_0``-``Dense_2``),
softmax cross entropy, SGD at 0.05 with momentum 0.9.
"""

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.models.tabular import add_dense_layers, relu_mlp
from elasticdl_tpu_torch.ops.losses import masked_softmax_cross_entropy

FEATURE_KEYS = ("sepal_length", "sepal_width", "petal_length", "petal_width")
LABEL_KEY = "class"


class IrisDNN(nn.Module):
    def __init__(self, num_classes: int = 3):
        super().__init__()
        self.mlp = add_dense_layers(self, len(FEATURE_KEYS),
                                    [16, 16, num_classes], torch.float32)

    def forward(self, features):
        return relu_mlp(self.mlp, torch.as_tensor(features).float())


def custom_model(device=None):
    return IrisDNN().to(resolve_device(device))


def loss(labels, predictions, mask):
    return masked_softmax_cross_entropy(labels, predictions, mask)


def optimizer(lr=0.05):
    return lambda params: torch.optim.SGD(params, lr=lr, momentum=0.9)


def dataset_fn(records, mode, metadata):
    columns = list(getattr(metadata, "column_names", None) or
                   (*FEATURE_KEYS, LABEL_KEY))
    sep = getattr(metadata, "extra", {}).get("sep", ",")
    feat_idx = [columns.index(k) for k in FEATURE_KEYS]
    label_idx = columns.index(LABEL_KEY) if LABEL_KEY in columns else -1
    rows, labels = [], []
    for payload in records:
        if isinstance(payload, bytes):
            payload = payload.decode("utf-8")
        cells = payload.split(sep) if isinstance(payload, str) else list(
            payload
        )
        rows.append([float(cells[i]) for i in feat_idx])
        labels.append(
            int(float(cells[label_idx])) if label_idx >= 0 else 0
        )
    features = np.asarray(rows, np.float32)
    labels = np.asarray(labels, np.int32)
    if mode == Mode.PREDICTION:
        return features, np.zeros_like(labels)
    return features, labels


def eval_metrics_fn():
    return {
        "accuracy": lambda labels, outputs: float(
            np.mean(np.argmax(outputs, axis=1) == labels)
        )
    }
