"""Data reader contract (port of elasticdl_tpu/data/reader.py).

A reader exposes:
- ``create_shards()`` -> {shard_name: (start, num_records)},
- ``read_records(task)`` -> iterator of raw record payloads for one task,
- ``metadata`` -> arbitrary dict forwarded to the user ``dataset_fn``.

RecordFiles are read through the native mmap reader
(``native/record_codec.py``) where the mean record is small, else with
the Python scanner; CSV as in the JAX package. Only the RecordFile
framing is native: each record's msgpack decode stays in Python.
"""

import csv
import glob
import os
from abc import ABC, abstractmethod
from typing import Dict, Iterator, Tuple

from elasticdl_tpu_torch.data.record_file import (
    RecordFileScanner,
    num_records_in_file,
)


class Metadata:
    def __init__(self, column_names=None, **extra):
        self.column_names = column_names
        self.extra = extra


class AbstractDataReader(ABC):
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    @abstractmethod
    def read_records(self, task) -> Iterator[bytes]:
        """Yield raw record payloads for ``task``'s shard range."""

    @abstractmethod
    def create_shards(self) -> Dict[str, Tuple[int, int]]:
        """Return {shard_name: (start_index, num_records)}."""

    @property
    def records_output_type(self) -> str:
        return "bytes"

    @property
    def metadata(self) -> Metadata:
        return Metadata()


def _expand_paths(data_origin: str):
    """A data origin is a file, a directory, or a glob."""
    if os.path.isdir(data_origin):
        paths = sorted(
            p for p in glob.glob(os.path.join(data_origin, "*"))
            if os.path.isfile(p)
        )
    else:
        paths = sorted(glob.glob(data_origin))
        if not paths and os.path.exists(data_origin):
            paths = [data_origin]
    if not paths:
        raise FileNotFoundError(f"No data files match {data_origin!r}")
    return paths


# Task ranges read through the native extension in this process (a plain
# counter, like the kernels' launch counts; instrumentation only).
native_range_reads = 0


class RecordFileDataReader(AbstractDataReader):
    """Shards RecordFiles by record ranges."""

    def __init__(self, data_origin: str, **kwargs):
        super().__init__(**kwargs)
        self._data_origin = data_origin

    # Below this mean record size the native mmap reader wins (the
    # per-record Python interpreter overhead dominates); above it the
    # buffered sequential scanner is already memcpy-bound. The JAX
    # package's threshold, kept as it is.
    NATIVE_READ_MAX_MEAN_RECORD_BYTES = 1024

    def read_records(self, task) -> Iterator[bytes]:
        global native_range_reads
        from elasticdl_tpu_torch.native.record_codec import (
            native_record_reader_available,
            read_range,
        )

        if native_record_reader_available():
            total = num_records_in_file(task.shard_name)
            mean = os.path.getsize(task.shard_name) / max(total, 1)
            if mean <= self.NATIVE_READ_MAX_MEAN_RECORD_BYTES:
                # Clamp like RecordFileScanner does (a shard table built
                # before a file was rewritten shorter must not fail the
                # task on one path and succeed on the other).
                start = min(max(task.start, 0), total)
                end = min(task.end, total)
                records = read_range(task.shard_name, start,
                                     max(end - start, 0))
                native_range_reads += 1
                yield from records
                return
        with RecordFileScanner(
            task.shard_name, task.start, task.end - task.start
        ) as scanner:
            yield from scanner

    def create_shards(self) -> Dict[str, Tuple[int, int]]:
        return {
            path: (0, num_records_in_file(path))
            for path in _expand_paths(self._data_origin)
        }


class CSVDataReader(AbstractDataReader):
    """CSV rows as records; parsed rows are cached per path."""

    def __init__(self, data_origin: str, sep: str = ",", **kwargs):
        super().__init__(**kwargs)
        self._data_origin = data_origin
        self._sep = sep
        self._columns = None
        self._cache = {}  # path -> (mtime, header, rows)

    def _read_rows(self, path):
        mtime = os.path.getmtime(path)
        cached = self._cache.get(path)
        if cached is not None and cached[0] == mtime:
            return cached[1], cached[2]
        with open(path, newline="") as f:
            rows = list(csv.reader(f, delimiter=self._sep))
        header, body = (rows[0], rows[1:]) if rows else ([], [])
        self._cache[path] = (mtime, header, body)
        return header, body

    def read_records(self, task) -> Iterator[bytes]:
        header, rows = self._read_rows(task.shard_name)
        self._columns = header
        for row in rows[task.start:task.end]:
            yield self._sep.join(row).encode("utf-8")

    def create_shards(self) -> Dict[str, Tuple[int, int]]:
        flat = {}
        for path in _expand_paths(self._data_origin):
            header, rows = self._read_rows(path)
            self._columns = header
            flat[path] = (0, len(rows))
        return flat

    @property
    def records_output_type(self) -> str:
        return "csv"

    @property
    def metadata(self) -> Metadata:
        return Metadata(column_names=self._columns, sep=self._sep)
