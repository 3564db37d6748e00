"""Concatenated categorical feature groups (the port's own copy of
elasticdl_tpu/preprocessing/feature_group.py; numpy, host side).

Twin of the reference's ``concatenated_categorical_column``: many
categorical columns share ONE embedding table by offsetting each
column's id range into a disjoint slice of a combined id space, so the
device does one gather over one table instead of one a column.
"""

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np


@dataclass
class FeatureGroup:
    """An ordered set of (name, transform) categorical columns fused into one
    id space. Each transform maps raw record values → ids in
    [0, transform.num_buckets)."""

    columns: List[Tuple[str, Callable]]

    def __post_init__(self):
        self.offsets = {}
        offset = 0
        for name, transform in self.columns:
            self.offsets[name] = offset
            offset += int(transform.num_buckets)
        self.total_buckets = offset

    def __call__(self, record_values: Dict[str, np.ndarray]) -> np.ndarray:
        """record_values: feature name → (B,) raw values.
        Returns (B, num_columns) int64 ids in [0, total_buckets)."""
        cols = []
        for name, transform in self.columns:
            ids = np.asarray(transform(record_values[name]), np.int64)
            cols.append(ids.reshape(-1, 1) + self.offsets[name])
        return np.concatenate(cols, axis=1)


def concat_feature_ids(groups: List[np.ndarray],
                       group_sizes: List[int]) -> np.ndarray:
    """Concatenate already-grouped id matrices into one id space (the
    multi-group form used by the census wide&deep model's MODEL_INPUTS)."""
    offsets = np.concatenate([[0], np.cumsum(group_sizes)[:-1]])
    return np.concatenate(
        [g + offsets[i] for i, g in enumerate(groups)], axis=1
    )
