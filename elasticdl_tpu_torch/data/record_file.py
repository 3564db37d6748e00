"""RecordFile: a seekable length-prefixed record container.

Copy of elasticdl_tpu/data/record_file.py: the same record files feed
both packages.

This framework's replacement for the reference's RecordIO dependency
(reference data/reader/recordio_reader.py uses the external ``pyrecordio``
package). The design requirement is identical — the master shards files into
(start, count) record ranges and workers must seek straight to record
``start`` — so the format carries a trailing offset index:

    header : b"EDLR" | uint32 version
    body   : repeat [uint32 len | payload bytes]
    index  : uint64 offset per record
    footer : uint64 index_offset | uint64 num_records | b"EDLI"

All integers little-endian. Payloads are opaque bytes; by convention the
framework stores msgpack-encoded feature dicts (see tensor_utils.dumps).
"""

import os
import struct
from typing import Iterator, List, Optional

_MAGIC = b"EDLR"
_FOOTER_MAGIC = b"EDLI"
_VERSION = 1
_HEADER = struct.Struct("<4sI")
_LEN = struct.Struct("<I")
_FOOTER = struct.Struct("<QQ4s")


class RecordFileWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._offsets: List[int] = []
        self._f.write(_HEADER.pack(_MAGIC, _VERSION))

    def write(self, payload: bytes):
        self._offsets.append(self._f.tell())
        self._f.write(_LEN.pack(len(payload)))
        self._f.write(payload)

    def close(self):
        index_offset = self._f.tell()
        for off in self._offsets:
            self._f.write(struct.pack("<Q", off))
        self._f.write(_FOOTER.pack(index_offset, len(self._offsets),
                                   _FOOTER_MAGIC))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordFileScanner:
    """Random-access scanner over a RecordFile.

    ``Scanner(path, start, count)`` mirrors the reference's
    ``recordio.Scanner(shard_name, start, end-start)``
    (recordio_reader.py:20-41).
    """

    def __init__(self, path: str, start: int = 0,
                 count: Optional[int] = None):
        self._path = path
        self._f = open(path, "rb")
        header = self._f.read(_HEADER.size)
        magic, version = _HEADER.unpack(header)
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a RecordFile (bad magic)")
        if version != _VERSION:
            raise ValueError(f"{path}: unsupported version {version}")
        self._f.seek(-_FOOTER.size, os.SEEK_END)
        index_offset, num_records, fmagic = _FOOTER.unpack(
            self._f.read(_FOOTER.size)
        )
        if fmagic != _FOOTER_MAGIC:
            raise ValueError(f"{path}: truncated RecordFile (bad footer)")
        self._num_records = num_records
        self._index_offset = index_offset
        start = max(0, start)
        if count is None:
            count = num_records - start
        self._end = min(num_records, start + count)
        self._pos = start
        if start < self._end:
            self._f.seek(index_offset + 8 * start)
            first_offset = struct.unpack("<Q", self._f.read(8))[0]
            self._f.seek(first_offset)

    @property
    def num_records(self) -> int:
        return self._num_records

    def record(self) -> Optional[bytes]:
        """Next record payload, or None at shard end (reference API shape)."""
        if self._pos >= self._end:
            return None
        (length,) = _LEN.unpack(self._f.read(_LEN.size))
        payload = self._f.read(length)
        self._pos += 1
        return payload

    def __iter__(self) -> Iterator[bytes]:
        while True:
            rec = self.record()
            if rec is None:
                return
            yield rec

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def num_records_in_file(path: str) -> int:
    with open(path, "rb") as f:
        f.seek(-_FOOTER.size, os.SEEK_END)
        _, num_records, fmagic = _FOOTER.unpack(f.read(_FOOTER.size))
        if fmagic != _FOOTER_MAGIC:
            raise ValueError(f"{path}: truncated RecordFile (bad footer)")
        return num_records
