"""Heart-disease raw CSV → train/val RecordFiles.

Counterpart of the reference's ``data/recordio_gen/heart_recordio_gen.py``
(download heart.csv, dtype-driven feature conversion, train/test split).
Input: a local header CSV (the applied-dl heart.csv schema: numeric
columns + the string ``thal`` column + integer ``target``/``label``).
Numerics are coerced per column from the data itself (the reference used
pandas dtypes); strings pass through — the zoo's heart model hashes
``thal`` host-side in its dataset_fn.

Usage:
  python -m elasticdl_tpu_torch.tools.record_gen.heart_gen heart.csv outdir \
      [--val_fraction 0.2] [--seed 0] [--label_key target]
"""

import argparse
import csv
import os

from elasticdl_tpu_torch.tools.record_gen._split import write_split


def _coerce(value: str):
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            continue
    return value


def convert(csv_path: str, out_dir: str, val_fraction: float = 0.2,
            seed: int = 0, label_key: str = "target"):
    with open(csv_path, newline="") as f:
        reader = csv.reader(f)
        columns = next(reader)
        rows = []
        for raw in reader:
            if len(raw) != len(columns):
                continue
            row = {c: _coerce(v.strip()) for c, v in zip(columns, raw)}
            if label_key in row and label_key != "label":
                row["label"] = int(row.pop(label_key))
            rows.append(row)
    if not rows:
        raise SystemExit(f"no valid rows in {csv_path}")
    return write_split(rows, out_dir, "heart", val_fraction, seed)


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("csv_path")
    parser.add_argument("out_dir")
    parser.add_argument("--val_fraction", type=float, default=0.2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--label_key", default="target")
    args = parser.parse_args()
    for name, n in convert(args.csv_path, args.out_dir,
                           args.val_fraction, args.seed,
                           args.label_key).items():
        print(f"wrote {n} records to {os.path.join(args.out_dir, name)}")


if __name__ == "__main__":
    main()
