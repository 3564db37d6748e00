"""Census (UCI Adult) raw CSV → train/val RecordFiles.

Counterpart of the reference's ``data/recordio_gen/census_recordio_gen.py``
(download adult.data, pandas-clean, train/test split, RecordIO of
tf.train.Example). TPU-build edition: no egress, so the input is a local
``adult.data``-format file (15 comma-separated columns, no header);
rows are cleaned (whitespace, malformed/missing drops), column names
normalized (``hours-per-week`` → ``hours_per_week`` — the zoo's census
models key on the underscore names), the label binarized
(``>50K`` → 1), numerics coerced, and a seeded shuffle split writes
``census_train.rec`` / ``census_val.rec`` msgpack records.

Usage:
  python -m elasticdl_tpu_torch.tools.record_gen.census_gen adult.data outdir \
      [--val_fraction 0.1] [--seed 0]
"""

import argparse
import csv
import os

from elasticdl_tpu_torch.tools.record_gen._split import write_split

COLUMNS = [
    "age", "workclass", "fnlwgt", "education", "education_num",
    "marital_status", "occupation", "relationship", "race", "sex",
    "capital_gain", "capital_loss", "hours_per_week", "native_country",
    "label",
]
NUMERIC = {"age", "fnlwgt", "education_num", "capital_gain",
           "capital_loss", "hours_per_week"}


def clean_row(raw):
    """One adult.data line → record dict, or None if malformed."""
    if len(raw) != len(COLUMNS):
        return None
    row = {}
    for name, value in zip(COLUMNS, raw):
        value = value.strip()
        if value in ("", "?"):
            return None  # reference drops rows with missing values
        if name == "label":
            row[name] = int(value.rstrip(".") == ">50K")
        elif name in NUMERIC:
            try:
                row[name] = float(value)
            except ValueError:
                return None
        else:
            row[name] = value
    return row


def convert(csv_path: str, out_dir: str, val_fraction: float = 0.1,
            seed: int = 0):
    rows = []
    with open(csv_path, newline="") as f:
        for raw in csv.reader(f):
            row = clean_row(raw)
            if row is not None:
                rows.append(row)
    if not rows:
        raise SystemExit(f"no valid rows in {csv_path}")
    return write_split(rows, out_dir, "census", val_fraction, seed)


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("csv_path", help="adult.data-format CSV")
    parser.add_argument("out_dir")
    parser.add_argument("--val_fraction", type=float, default=0.1)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    for name, n in convert(args.csv_path, args.out_dir,
                           args.val_fraction, args.seed).items():
        print(f"wrote {n} records to {os.path.join(args.out_dir, name)}")


if __name__ == "__main__":
    main()
