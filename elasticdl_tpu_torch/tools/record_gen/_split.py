"""Shared seeded-shuffle train/val split writer for the per-dataset
converters (census_gen / heart_gen)."""

import os

import numpy as np

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.data.record_file import RecordFileWriter


def write_split(rows, out_dir, prefix, val_fraction, seed):
    """Shuffle ``rows`` (seeded) and write ``{prefix}_train.rec`` /
    ``{prefix}_val.rec`` under ``out_dir``; returns {filename: count}."""
    order = np.random.RandomState(seed).permutation(len(rows))
    n_val = int(len(rows) * val_fraction)
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for name, idx in (
        (f"{prefix}_val.rec", order[:n_val]),
        (f"{prefix}_train.rec", order[n_val:]),
    ):
        path = os.path.join(out_dir, name)
        with RecordFileWriter(path) as writer:
            for i in idx:
                writer.write(tensor_utils.dumps(rows[i]))
        out[name] = len(idx)
    return out
