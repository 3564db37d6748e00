"""Native RecordFile range reader (port of
elasticdl_tpu/native/record_codec.py; the CPython extension
``native/record_ext.c``).

``read_range(path, start, count)`` mmaps the file and builds the final
``list[bytes]`` in C — one memcpy per record, no Python-side loop. (A
ctypes batch-copy design was measured *slower* than the pure-Python
scanner, because re-slicing the returned buffer into bytes objects costs
another full Python pass; creating the PyBytes directly in C is what
wins.) Callers gate on ``native_record_reader_available()`` and fall
back to ``RecordFileScanner`` (``data/reader.py``).
"""

from typing import List

from elasticdl_tpu_torch.native import get_record_ext


def native_record_reader_available() -> bool:
    return get_record_ext() is not None


def read_range(path: str, start: int, count: int) -> List[bytes]:
    """Payloads of records [start, start+count); raises ValueError on a
    corrupt file or out-of-bounds range. NOTE: unlike RecordFileScanner
    (which clamps), out-of-range raises — callers that want clamping do
    it themselves (data/reader.py does)."""
    return get_record_ext().read_range(path, start, count)


def num_records(path: str) -> int:
    return get_record_ext().num_records(path)
