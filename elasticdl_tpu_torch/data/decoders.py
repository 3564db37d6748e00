"""Common record decoders for model-zoo dataset_fns (port of
elasticdl_tpu/data/decoders.py): the image models' shared decode, on
the port's own record codec (``common/tensor_utils``)."""

import numpy as np

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.common.constants import Mode


def image_classification_dataset_fn(records, mode, metadata,
                                    image_key="image", label_key="label",
                                    scale=255.0):
    """Decode {image, label} records into (B,H,W[,C]) float features in
    [0,1] plus int32 labels (zeroed for PREDICTION)."""
    del metadata
    images, labels = [], []
    for payload in records:
        rec = tensor_utils.loads(payload)
        images.append(np.asarray(rec[image_key], np.float32) / scale)
        labels.append(int(rec.get(label_key, 0)))
    features = np.stack(images).astype(np.float32)
    labels = np.asarray(labels, np.int32)
    if mode == Mode.PREDICTION:
        return features, np.zeros_like(labels)
    return features, labels


def argmax_accuracy_metrics():
    """{'accuracy': fn} for softmax-logit classifiers."""
    return {
        "accuracy": lambda labels, outputs: float(
            np.mean(np.argmax(outputs, axis=1) == labels)
        )
    }
