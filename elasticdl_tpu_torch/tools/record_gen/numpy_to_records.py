"""Convert .npy/.npz arrays into RecordFiles of image/label records.

Counterpart of the reference's image dataset converters
(``elasticdl/python/data/recordio_gen/image_label.py`` and the
mnist/cifar generation scripts): given a features array (N, ...) and a
labels array (N,), emit records ``{"image": ..., "label": int}`` in the
shape the bundled mnist/cifar zoo models consume.

Usage:
  python -m elasticdl_tpu_torch.tools.record_gen.numpy_to_records features.npy labels.npy \
      out.rec [--key image]
  python -m elasticdl_tpu_torch.tools.record_gen.numpy_to_records data.npz out.rec \
      --features_key x_train --labels_key y_train
"""

import argparse

import numpy as np

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.data.record_file import RecordFileWriter


def convert(features: np.ndarray, labels: np.ndarray, out_path: str,
            key: str = "image", records_per_shard: int = 0,
            fraction: float = 1.0) -> int:
    """``records_per_shard > 0`` writes numbered shard files
    ``out_path-%05d`` (reference image_label.py convert: data-%05d
    shards); ``fraction`` keeps the leading subset like its
    ``--fraction`` flag."""
    assert len(features) == len(labels), (
        f"{len(features)} features vs {len(labels)} labels"
    )
    total = int(len(features) * fraction)
    if not records_per_shard:
        with RecordFileWriter(out_path) as writer:
            for x, y in zip(features[:total], labels[:total]):
                writer.write(tensor_utils.dumps(
                    {key: np.asarray(x), "label": int(y)}
                ))
        return total
    written = 0
    shard = 0
    while written < total:
        hi = min(written + records_per_shard, total)
        with RecordFileWriter(f"{out_path}-{shard:05d}") as writer:
            for x, y in zip(features[written:hi], labels[written:hi]):
                writer.write(tensor_utils.dumps(
                    {key: np.asarray(x), "label": int(y)}
                ))
        written = hi
        shard += 1
    return total


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("inputs", nargs="+",
                        help="features.npy labels.npy OR one .npz")
    parser.add_argument("out_path")
    parser.add_argument("--key", default="image")
    parser.add_argument("--features_key", default="x_train")
    parser.add_argument("--labels_key", default="y_train")
    parser.add_argument("--records_per_shard", type=int, default=0,
                        help="split output into out_path-%%05d shards")
    parser.add_argument("--fraction", type=float, default=1.0,
                        help="keep only the leading fraction of rows")
    args = parser.parse_args()
    if len(args.inputs) == 1 and args.inputs[0].endswith(".npz"):
        data = np.load(args.inputs[0])
        features, labels = data[args.features_key], data[args.labels_key]
    elif len(args.inputs) == 2:
        features = np.load(args.inputs[0])
        labels = np.load(args.inputs[1])
    else:
        parser.error("pass features.npy labels.npy, or one .npz")
    n = convert(features, labels, args.out_path, key=args.key,
                records_per_shard=args.records_per_shard,
                fraction=args.fraction)
    print(f"wrote {n} records to {args.out_path}")


if __name__ == "__main__":
    main()
