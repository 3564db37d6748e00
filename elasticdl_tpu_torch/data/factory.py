"""Reader factory (port of elasticdl_tpu/data/factory.py): a reader from
the data origin's extension, an explicit ``reader_type`` in
data_reader_params, or a user ``custom_data_reader``. Stream and table
origins are not ported yet and raise."""

import os

from elasticdl_tpu_torch.common.constants import ReaderType
from elasticdl_tpu_torch.data.reader import (
    CSVDataReader,
    RecordFileDataReader,
)


def parse_data_reader_params(params: str) -> dict:
    """Parse 'k1=v1;k2=v2' data_reader_params strings."""
    out = {}
    if not params:
        return out
    for kv in params.replace(",", ";").split(";"):
        kv = kv.strip()
        if not kv:
            continue
        key, _, value = kv.partition("=")
        out[key.strip()] = value.strip()
    return out


def create_data_reader(data_origin: str, custom_reader=None, **kwargs):
    if custom_reader is not None:
        return custom_reader(data_origin=data_origin, **kwargs)
    reader_type = kwargs.pop("reader_type", None)
    if reader_type in (ReaderType.STREAM, ReaderType.TABLE) or (
            data_origin.startswith(("stream://", "table+sqlite://",
                                    "table+csv://", "table+rpc://",
                                    "odps://"))):
        raise NotImplementedError(
            f"data origin {data_origin!r}: stream and table readers are "
            "not ported yet (ported: RecordFile, CSV)"
        )
    if reader_type == ReaderType.CSV:
        return CSVDataReader(data_origin=data_origin, **kwargs)
    if reader_type == ReaderType.RECORD_FILE:
        return RecordFileDataReader(data_origin=data_origin, **kwargs)
    if reader_type is None:
        ext = os.path.splitext(data_origin.rstrip("/*"))[1].lower()
        if ext == ".csv":
            return CSVDataReader(data_origin=data_origin, **kwargs)
        return RecordFileDataReader(data_origin=data_origin, **kwargs)
    raise ValueError(f"Unknown reader_type {reader_type!r}")
