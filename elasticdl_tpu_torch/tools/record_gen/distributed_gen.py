"""Distributed RecordFile generation over a pool of workers.

Counterpart of the reference's PySpark sample
(``data/recordio_gen/sample_pyspark_recordio_gen/spark_gen_recordio.py``):
partition a list of raw input files across workers; each worker runs a
user-supplied ``prepare(fileobj, filename) -> iterable[dict]`` from a
model-zoo module and writes its own ``data-<partition>-%04d`` shards of
``records_per_file`` records — the same output naming/layout contract,
so a training job shards over the result identically.

The execution backend is pluggable:
- ``multiprocessing`` (default): a local process pool — the TPU-native
  deployment runs converters on the job's CPU hosts rather than a Spark
  cluster.
- ``pyspark``: the reference's backend, used verbatim when pyspark is
  installed (mapPartitions over the same partition lists); import-gated
  like every other optional dependency.

Usage:
  python -m elasticdl_tpu_torch.tools.record_gen.distributed_gen --output_dir out \
      --module elasticdl_tpu_torch.testing.prepare_csv --num_workers 4 \
      data/*.csv
The module must expose ``prepare(fileobj, filename)`` yielding dict
records (tensor_utils payloads).
"""

import argparse
import glob
import importlib
import os
from typing import List

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.data.record_file import RecordFileWriter


def partition_files(files: List[str], num_workers: int) -> List[List[str]]:
    """Round-robin partition (reference parallelizes the filename list
    with numSlices=num_workers)."""
    parts = [[] for _ in range(max(1, num_workers))]
    for i, f in enumerate(sorted(files)):
        parts[i % len(parts)].append(f)
    return [p for p in parts if p]


def write_partition(partition_id: int, files: List[str], module_name: str,
                    output_dir: str, records_per_file: int) -> List[str]:
    """One worker: convert its files, emit data-<pid>-%04d shards
    (reference _process_data)."""
    prepare = importlib.import_module(module_name).prepare
    os.makedirs(output_dir, exist_ok=True)
    # Idempotent re-runs: clear this partition's previous shards only.
    for stale in glob.glob(
        os.path.join(output_dir, f"data-{partition_id}-*")
    ):
        os.remove(stale)
    shards, buf = [], []

    def flush():
        path = os.path.join(
            output_dir, f"data-{partition_id}-{len(shards):04d}"
        )
        with RecordFileWriter(path) as w:
            for rec in buf:
                w.write(tensor_utils.dumps(rec))
        shards.append(path)
        buf.clear()

    for filename in files:
        with open(filename, "rb") as f:
            for record in prepare(f, filename):
                buf.append(record)
                if len(buf) == records_per_file:
                    flush()
    if buf:
        flush()
    return shards


def run_multiprocessing(parts, module_name, output_dir, records_per_file):
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(len(parts)) as pool:
        results = [
            pool.apply_async(
                write_partition,
                (i, files, module_name, output_dir, records_per_file),
            )
            for i, files in enumerate(parts)
        ]
        return [s for r in results for s in r.get()]


def run_pyspark(parts, module_name, output_dir, records_per_file):
    from pyspark import SparkContext, TaskContext  # import-gated

    sc = SparkContext(appName="elasticdl_tpu-record-gen")
    try:
        flat = [f for p in parts for f in p]

        def do_partition(files):
            files = list(files)
            if not files:
                return []
            pid = TaskContext().partitionId()
            return write_partition(
                pid, files, module_name, output_dir, records_per_file
            )

        return (
            sc.parallelize(flat, numSlices=len(parts))
            .mapPartitions(do_partition)
            .collect()
        )
    finally:
        sc.stop()


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("inputs", nargs="+",
                        help="raw input files (globs accepted)")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--module", required=True,
                        help="module exposing prepare(fileobj, filename)")
    parser.add_argument("--num_workers", type=int, default=2)
    parser.add_argument("--records_per_file", type=int, default=1024)
    parser.add_argument("--backend", default="multiprocessing",
                        choices=("multiprocessing", "pyspark"))
    args = parser.parse_args()
    files = [f for pat in args.inputs for f in sorted(glob.glob(pat))]
    if not files:
        raise SystemExit("no input files matched")
    parts = partition_files(files, args.num_workers)
    runner = (run_pyspark if args.backend == "pyspark"
              else run_multiprocessing)
    shards = runner(parts, args.module, args.output_dir,
                    args.records_per_file)
    print(f"wrote {len(shards)} shard(s) across {len(parts)} partitions")


if __name__ == "__main__":
    main()
