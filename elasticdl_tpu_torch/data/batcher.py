"""Static-shape batching (port of elasticdl_tpu/data/batcher.py).

Every batch is padded to ``batch_size`` and carries a float ``mask``
(1.0 = real row, 0.0 = padding) that the loss and metrics weight by,
as in the JAX package: the same batches go through both, and a fixed
shape keeps the card's work per step the same. Padding replicates
row 0.
"""

from typing import Any, Callable, Dict, Iterator, List

import numpy as np
import torch


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, value) for value in tree)
    return fn(tree)


def pad_batch(features, labels, actual: int, batch_size: int):
    """Pad feature/label trees along axis 0 up to batch_size + build mask."""

    def _pad(arr):
        arr = np.asarray(arr)
        if arr.shape[0] == batch_size:
            return arr
        pad_rows = np.repeat(arr[:1], batch_size - arr.shape[0], axis=0)
        return np.concatenate([arr, pad_rows], axis=0)

    mask = np.zeros((batch_size,), np.float32)
    mask[:actual] = 1.0
    return {
        "features": tree_map(_pad, features),
        "labels": tree_map(_pad, labels),
        "mask": mask,
    }


def batch_records(
    records: Iterator[Any],
    batch_size: int,
    dataset_fn: Callable,
    mode: str,
    metadata,
    drop_remainder: bool = False,
) -> Iterator[Dict[str, Any]]:
    """Group raw records into padded, masked batches via the user
    ``dataset_fn(records, mode, metadata) -> (features, labels)``."""
    buf: List[Any] = []
    for record in records:
        buf.append(record)
        if len(buf) == batch_size:
            features, labels = dataset_fn(buf, mode, metadata)
            yield pad_batch(features, labels, batch_size, batch_size)
            buf = []
    if buf and not drop_remainder:
        features, labels = dataset_fn(buf, mode, metadata)
        yield pad_batch(features, labels, len(buf), batch_size)


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over real rows only — helper for user losses/metrics."""
    mask = mask.to(values.dtype)
    return (values * mask).sum() / mask.sum().clamp_min(1.0)
