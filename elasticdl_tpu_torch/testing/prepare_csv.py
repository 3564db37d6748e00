"""A minimal ``prepare(fileobj, filename)`` for distributed_gen (the
user-module contract of ``elasticdl_tpu_torch/tools/record_gen/
distributed_gen.py``; port of elasticdl_tpu/testing/prepare_csv.py)."""

import csv
import io


def prepare(fileobj, filename):
    text = io.TextIOWrapper(fileobj, newline="")
    reader = csv.reader(text)
    columns = next(reader)
    for row in reader:
        yield {c: v for c, v in zip(columns, row)}
