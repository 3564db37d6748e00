"""(images, labels) numpy arrays → sharded RecordFiles.

Counterpart of the reference's ``data/recordio_gen/image_label.py``
(convert(): shard every ``records_per_shard`` rows into
``<dir>/<dataset>/<subdir>/data-%05d``, honoring ``--fraction``). Input
is a ``.npz`` with ``x``/``y`` arrays (or any two arrays named via
``--x_key/--y_key``) — the reference pulled keras datasets, which need
egress this image doesn't have.

Usage:
  python -m elasticdl_tpu_torch.tools.record_gen.image_label_gen data.npz outdir \
      --dataset mnist --subdir train [--records_per_shard 4096] \
      [--fraction 1.0]
"""

import argparse
import os

import numpy as np

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.data.record_file import RecordFileWriter


def convert(x, y, out_dir, dataset, subdir, records_per_shard=4096,
            fraction=1.0):
    """Write ``ceil(n*fraction / records_per_shard)`` shards named
    ``data-%05d``; returns the shard paths (reference image_label.py
    convert())."""
    n = int(x.shape[0] * fraction)
    target = os.path.join(out_dir, dataset, subdir)
    os.makedirs(target, exist_ok=True)
    shards = []
    writer = None
    try:
        for row in range(n):
            if row % records_per_shard == 0:
                if writer is not None:
                    writer.close()
                path = os.path.join(target, "data-%05d" % len(shards))
                writer = RecordFileWriter(path)
                shards.append(path)
            writer.write(tensor_utils.dumps({
                "features": np.asarray(x[row], np.float32),
                "label": np.int64(np.ravel(y[row])[0]),
            }))
    finally:
        if writer is not None:
            writer.close()
    return shards


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("npz_path")
    parser.add_argument("out_dir")
    parser.add_argument("--dataset", default="mnist")
    parser.add_argument("--subdir", default="train")
    parser.add_argument("--records_per_shard", type=int, default=4096)
    parser.add_argument("--fraction", type=float, default=1.0)
    parser.add_argument("--x_key", default="x")
    parser.add_argument("--y_key", default="y")
    args = parser.parse_args()
    data = np.load(args.npz_path)
    shards = convert(
        data[args.x_key], data[args.y_key], args.out_dir, args.dataset,
        args.subdir, args.records_per_shard, args.fraction,
    )
    print(f"wrote {len(shards)} shard(s): {shards[0]} ..")


if __name__ == "__main__":
    main()
