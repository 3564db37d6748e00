"""Frappe libfm dataset → RecordFiles for the DeepFM zoo model.

Counterpart of the reference's
``data/recordio_gen/frappe_recordio_gen.py`` (LoadFrappe: build a dense
feature-id map across ALL splits, binarize the label, left-pad feature
lists to the global max length, write per-split record shards). Input is
the already-downloaded libfm text files (this image has no egress; the
reference fetched them from github) — each line is
``<label> <raw_feat> <raw_feat> ...``.

Feature ids start at 1 (0 is the pad value, exactly the reference's
``pad_sequences`` default), and the map is built over every provided
split so train/validation/test agree — the property DeepFM's embedding
table depends on.

Usage:
  python -m elasticdl_tpu_torch.tools.record_gen.frappe_gen outdir \
      --train frappe.train.libfm --validation frappe.validation.libfm \
      --test frappe.test.libfm
"""

import argparse
import os

import numpy as np

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.data.record_file import RecordFileWriter


def build_feature_map(paths):
    """Raw token -> dense id (1-based; 0 reserved for padding), built
    over every split (reference gen_feature_map)."""
    features = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                for item in line.strip().split(" ")[1:]:
                    features.setdefault(item, len(features) + 1)
    return features


def read_split(path, features):
    """[(ids, label)] with the binarized label (reference read_data)."""
    rows = []
    with open(path) as f:
        for line in f:
            arr = line.strip().split(" ")
            if not arr or not arr[0]:
                continue
            label = 1 if float(arr[0]) > 0 else 0
            rows.append(([features[i] for i in arr[1:]], label))
    return rows


def convert(out_dir, splits):
    """``splits``: {name: libfm_path}. Returns {filename: count}."""
    features = build_feature_map(list(splits.values()))
    data = {n: read_split(p, features) for n, p in splits.items()}
    maxlen = max(
        (len(ids) for rows in data.values() for ids, _ in rows),
        default=0,
    )
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for name, rows in data.items():
        fname = f"frappe_{name}.rec"
        with RecordFileWriter(os.path.join(out_dir, fname)) as w:
            for ids, label in rows:
                # Left-pad with 0 to the global maxlen (the reference
                # used keras pad_sequences, which pads 'pre').
                padded = np.zeros(maxlen, np.int64)
                if ids:
                    padded[maxlen - len(ids):] = ids
                w.write(tensor_utils.dumps(
                    {"features": padded, "label": np.int64(label)}
                ))
        out[fname] = len(rows)
    out["feature_num"] = len(features) + 1  # +1 for the pad id
    out["maxlen"] = maxlen
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("out_dir")
    parser.add_argument("--train", required=True)
    parser.add_argument("--validation")
    parser.add_argument("--test")
    args = parser.parse_args()
    splits = {"train": args.train}
    if args.validation:
        splits["validation"] = args.validation
    if args.test:
        splits["test"] = args.test
    for key, value in convert(args.out_dir, splits).items():
        print(f"{key}: {value}")


if __name__ == "__main__":
    main()
