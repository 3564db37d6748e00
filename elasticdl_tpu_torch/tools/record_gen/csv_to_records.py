"""Convert a header CSV into a RecordFile of msgpack row dicts.

Counterpart of the reference's RecordIO generation tools
(``elasticdl/python/data/recordio_gen/``): users convert raw datasets
into the framework's sharded record format once, then train from it.

Usage: python -m elasticdl_tpu_torch.tools.record_gen.csv_to_records in.csv out.rec \
           [--records_per_file N]
"""

import argparse
import csv

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.data.record_file import RecordFileWriter


def convert(csv_path: str, out_path: str,
            records_per_file: int = 0) -> list:
    """Write one RecordFile (or numbered shards of records_per_file)."""

    def _coerce(value: str):
        for cast in (int, float):
            try:
                return cast(value)
            except ValueError:
                continue
        return value

    outputs = []
    with open(csv_path, newline="") as f:
        reader = csv.reader(f)
        columns = next(reader)
        writer = None
        count = 0
        for row in reader:
            if writer is None or (
                records_per_file and count % records_per_file == 0
            ):
                if writer is not None:
                    writer.close()
                path = (
                    f"{out_path}-{len(outputs):05d}"
                    if records_per_file else out_path
                )
                writer = RecordFileWriter(path)
                outputs.append(path)
            payload = {
                c: _coerce(v) for c, v in zip(columns, row)
            }
            writer.write(tensor_utils.dumps(payload))
            count += 1
        if writer is not None:
            writer.close()
    return outputs


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("csv_path")
    parser.add_argument("out_path")
    parser.add_argument("--records_per_file", type=int, default=0,
                        help="0 = single output file")
    args = parser.parse_args()
    outputs = convert(args.csv_path, args.out_path,
                      args.records_per_file)
    print(f"wrote {len(outputs)} file(s): {outputs}")


if __name__ == "__main__":
    main()
