"""Reader factory (port of elasticdl_tpu/data/factory.py): a reader from
the data origin's extension, an explicit ``reader_type`` in
data_reader_params, or a user ``custom_data_reader``. A ``stream://``
origin (or ``reader_type=Stream``) tails ``data/stream.py``'s append-only
partitions; ``table+sqlite://``, ``table+csv://``, ``table+rpc://`` and
``odps://`` origins (or ``reader_type=Table``) read rows through
``data/table_reader.py``."""

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
    # Table origins (sqlite/csv-table/ODPS) route by URL scheme.
    # Stream origins (data/stream.py): the tail of append-only
    # partitions, selected by scheme or explicit reader_type.
    if reader_type == ReaderType.STREAM or data_origin.startswith(
        "stream://"
    ):
        from elasticdl_tpu_torch.data.stream import StreamDataReader

        stream_dir = data_origin
        if stream_dir.startswith("stream://"):
            stream_dir = stream_dir[len("stream://"):]
        return StreamDataReader(stream_dir=stream_dir, **kwargs)
    if reader_type == ReaderType.TABLE or data_origin.startswith(
            ("table+sqlite://", "table+csv://", "table+rpc://", "odps://")):
        from elasticdl_tpu_torch.data.table_reader import TableDataReader

        return TableDataReader(data_origin=data_origin, **kwargs)
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
