"""Append-only record streams for online / continual learning (copy of
elasticdl_tpu/data/stream.py; the port keeps its own). The frame files
are the JAX package's bytes, so either package tails what the other
writes.

Batch readers (data/reader.py) expose a FINITE shard table and the
dispatcher walks it per epoch; a stream has no epochs. The contract
here is deliberately tiny so real buses (Kafka, Pub/Sub, a CDC tail)
can slot in behind it:

- a stream is a set of named **partitions**, each an append-only
  sequence of records with dense integer **offsets** ``0..end``;
- ``end_offset(partition)`` is the exclusive high-water mark — it only
  grows;
- ``read(partition, start, end)`` must serve any offset range that has
  not fallen off the retention horizon, byte-identical on every call
  (replays after a worker SIGKILL re-read the same bytes);
- ``append_time(partition, offset)`` is the record's ingest timestamp,
  feeding the ``stream_ingest_watermark_lag_seconds`` gauge.

The reference implementation is a **file tail**: one append-only frame
file per partition (``<dir>/<partition>.edlstream``), written by
``StreamWriter`` and tailed by ``FileTailStream``. Frames are
``[u32 len][u32 crc][f64 ts][payload]`` — a torn tail (crash mid-append)
is detected by length/crc and treated as end-of-stream, mirroring the
master journal's torn-frame discipline (master/journal.py). Recent
payloads stay in a bounded ``ReplayBuffer`` so the common case (a task
reading just-appended records) never touches disk twice; older ranges
fall back to the retained per-offset byte index and re-read the file.

Watermarks live in the MASTER's journal, not here: the committed
watermark for a partition advances only when the journal records the
resolving task report (master/stream_ingest.py), so a relaunched
pipeline resumes from what was durably acknowledged — never from what
a dead worker had merely read.
"""

import os
import struct
import threading
import zlib
from abc import ABC, abstractmethod
from collections import deque
from typing import Dict, Iterator, List, Tuple

from elasticdl_tpu_torch.data.reader import AbstractDataReader, Metadata

STREAM_SUFFIX = ".edlstream"

# Frame header: payload length (u32) + crc32 of body (u32); body is
# an 8-byte little-endian ingest timestamp followed by the payload.
_HEADER = struct.Struct("<II")
_TS = struct.Struct("<d")


class StreamTruncatedError(Exception):
    """A requested offset range fell off the retention horizon (the
    backing file was truncated or rotated away under the tail)."""


class ReplayBuffer:
    """Bounded in-memory tail of one partition: the newest
    ``capacity`` payloads keyed by offset. Reads inside the window are
    pure memory; reads behind it miss (the source falls back to its
    durable store). Not a durability mechanism — just the cache that
    keeps steady-state ingestion off the disk read path."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"replay buffer capacity must be > 0, "
                             f"got {capacity}")
        self.capacity = int(capacity)
        self._payloads = deque()  # leftmost is self._base
        self._base = 0  # offset of _payloads[0]

    def push(self, offset: int, payload: bytes):
        if self._payloads and offset != self._base + len(self._payloads):
            raise ValueError(
                f"non-contiguous append: offset {offset}, "
                f"expected {self._base + len(self._payloads)}"
            )
        if not self._payloads:
            self._base = offset
        self._payloads.append(payload)
        while len(self._payloads) > self.capacity:
            self._payloads.popleft()
            self._base += 1

    def get_range(self, start: int, end: int):
        """payloads for [start, end) or ``None`` if any offset is
        outside the buffered window (caller re-reads durably)."""
        if start < self._base or end > self._base + len(self._payloads):
            return None
        return [self._payloads[i - self._base]
                for i in range(start, end)]

    @property
    def span(self) -> Tuple[int, int]:
        return self._base, self._base + len(self._payloads)


class StreamSource(ABC):
    """Abstract append-only record stream (see module docstring for
    the contract)."""

    @abstractmethod
    def partitions(self) -> List[str]:
        """Known partition names (may grow over time)."""

    @abstractmethod
    def end_offset(self, partition: str) -> int:
        """Exclusive high-water offset — monotonically nondecreasing."""

    @abstractmethod
    def read(self, partition: str, start: int, end: int) -> List[bytes]:
        """Payloads for offsets [start, end); raises
        ``StreamTruncatedError`` when the range fell off retention."""

    def append_time(self, partition: str, offset: int) -> float:
        """Epoch-seconds ingest time of ``offset`` (0.0 if unknown)."""
        return 0.0


class StreamWriter:
    """Producer side of the file-tail reference stream: append records
    to per-partition frame files. ``append`` returns the record's
    offset. ``fsync=True`` makes the append durable before returning
    (the drills' acked-producer mode)."""

    def __init__(self, stream_dir: str):
        self.stream_dir = stream_dir
        os.makedirs(stream_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._files: Dict[str, object] = {}
        self._counts: Dict[str, int] = {}

    def _path(self, partition: str) -> str:
        if "/" in partition or partition.startswith("."):
            raise ValueError(f"bad partition name: {partition!r}")
        return os.path.join(self.stream_dir, partition + STREAM_SUFFIX)

    def append(self, partition: str, payload: bytes,
               ts: float = None, fsync: bool = False) -> int:
        import time as _time

        body = _TS.pack(_time.time() if ts is None else float(ts))
        body += bytes(payload)
        frame = _HEADER.pack(
            len(body), zlib.crc32(body) & 0xFFFFFFFF
        ) + body
        with self._lock:
            fh = self._files.get(partition)
            if fh is None:
                path = self._path(partition)
                count, pos, _idx = _scan_stream_file(path)
                fh = open(path, "ab")
                if fh.tell() != pos:
                    # Torn tail from a crashed producer: overwrite it
                    # so the next frame starts on a valid boundary.
                    fh.truncate(pos)
                    fh.seek(pos)
                self._files[partition] = fh
                self._counts[partition] = count
            offset = self._counts[partition]
            fh.write(frame)
            fh.flush()
            if fsync:
                os.fsync(fh.fileno())
            self._counts[partition] = offset + 1
            return offset

    def close(self):
        with self._lock:
            for fh in self._files.values():
                fh.close()
            self._files.clear()


def _scan_stream_file(path: str, start_pos: int = 0,
                      start_offset: int = 0):
    """Scan frames from ``start_pos``; returns (record_count,
    clean_end_pos, [(offset, byte_pos, ts)]). A torn or corrupt tail
    frame ends the scan (it is not yet part of the stream)."""
    index: List[Tuple[int, int, float]] = []
    if not os.path.exists(path):
        return start_offset, start_pos, index
    size = os.path.getsize(path)
    offset, pos = start_offset, start_pos
    with open(path, "rb") as fh:
        fh.seek(pos)
        while pos + _HEADER.size <= size:
            length, crc = _HEADER.unpack(fh.read(_HEADER.size))
            if length < _TS.size or pos + _HEADER.size + length > size:
                break  # torn tail
            body = fh.read(length)
            if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
                break  # corrupt tail frame: stop before it
            (ts,) = _TS.unpack_from(body, 0)
            index.append((offset, pos, ts))
            pos += _HEADER.size + length
            offset += 1
    return offset, pos, index


class FileTailStream(StreamSource):
    """Tail ``<dir>/*.edlstream`` files as a live stream. Each
    ``poll()`` (or any read-path call) picks up newly appended frames
    and newly created partitions. Per-offset byte positions and ingest
    timestamps are retained for the whole stream (16B/record); payload
    bytes are cached only inside the bounded replay buffer."""

    def __init__(self, stream_dir: str,
                 replay_buffer_records: int = 4096):
        self.stream_dir = stream_dir
        self._lock = threading.Lock()
        self._replay_capacity = int(replay_buffer_records)
        # partition -> {"end": int, "pos": int, "index": [(pos, ts)],
        #               "buffer": ReplayBuffer}
        self._parts: Dict[str, dict] = {}

    # ---- tailing ------------------------------------------------------

    def poll(self) -> Dict[str, int]:
        """Absorb new partitions/frames; returns {partition: end}."""
        with self._lock:
            self._poll_locked()
            return {p: st["end"] for p, st in self._parts.items()}

    def _poll_locked(self):
        try:
            names = sorted(os.listdir(self.stream_dir))
        except OSError:
            names = []
        for name in names:
            if not name.endswith(STREAM_SUFFIX):
                continue
            partition = name[: -len(STREAM_SUFFIX)]
            st = self._parts.get(partition)
            if st is None:
                st = {"end": 0, "pos": 0, "index": [],
                      "buffer": ReplayBuffer(self._replay_capacity)}
                self._parts[partition] = st
            path = os.path.join(self.stream_dir, name)
            if os.path.getsize(path) <= st["pos"]:
                continue
            end, pos, fresh = _scan_stream_file(
                path, st["pos"], st["end"]
            )
            if fresh:
                with open(path, "rb") as fh:
                    for offset, byte_pos, ts in fresh:
                        fh.seek(byte_pos)
                        length, _crc = _HEADER.unpack(
                            fh.read(_HEADER.size)
                        )
                        payload = fh.read(length)[_TS.size:]
                        st["index"].append((byte_pos, ts))
                        st["buffer"].push(offset, payload)
            st["end"], st["pos"] = end, pos

    # ---- StreamSource -------------------------------------------------

    def partitions(self) -> List[str]:
        with self._lock:
            self._poll_locked()
            return sorted(self._parts)

    def end_offset(self, partition: str) -> int:
        with self._lock:
            self._poll_locked()
            st = self._parts.get(partition)
            return st["end"] if st else 0

    def read(self, partition: str, start: int, end: int) -> List[bytes]:
        if end < start or start < 0:
            raise ValueError(f"bad range [{start}, {end})")
        with self._lock:
            self._poll_locked()
            st = self._parts.get(partition)
            if st is None or end > st["end"]:
                raise StreamTruncatedError(
                    f"{partition}: [{start}, {end}) beyond appended "
                    f"end {st['end'] if st else 0}"
                )
            cached = st["buffer"].get_range(start, end)
            if cached is not None:
                return cached
            index = [st["index"][i] for i in range(start, end)]
        # Cache miss: re-read from the durable file (outside the lock —
        # frames are immutable once scanned).
        path = os.path.join(self.stream_dir, partition + STREAM_SUFFIX)
        out = []
        try:
            with open(path, "rb") as fh:
                for byte_pos, _ts in index:
                    fh.seek(byte_pos)
                    head = fh.read(_HEADER.size)
                    length, crc = _HEADER.unpack(head)
                    body = fh.read(length)
                    if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
                        raise StreamTruncatedError(
                            f"{partition}: frame at byte {byte_pos} "
                            "no longer matches its crc"
                        )
                    out.append(body[_TS.size:])
        except OSError as err:
            raise StreamTruncatedError(
                f"{partition}: backing file unreadable ({err})"
            )
        return out

    def append_time(self, partition: str, offset: int) -> float:
        with self._lock:
            st = self._parts.get(partition)
            if st is None or offset >= len(st["index"]):
                self._poll_locked()
                st = self._parts.get(partition)
            if st is None or not (0 <= offset < len(st["index"])):
                return 0.0
            return st["index"][offset][1]


class StreamDataReader(AbstractDataReader):
    """Worker-side reader for STREAM tasks: ``task.shard_name`` is the
    partition, ``task.start``/``task.end`` the offset range. There is
    no static shard table (``create_shards`` is empty — the master's
    stream ingestor generates tasks from the live tail instead), which
    is exactly why the dispatcher's streaming mode never reports
    ``finished`` while the source is live."""

    def __init__(self, stream_dir: str = "", source: StreamSource = None,
                 fallback=None, **kwargs):
        super().__init__(**kwargs)
        if source is None:
            if not stream_dir:
                raise ValueError("stream_dir or source required")
            source = FileTailStream(stream_dir)
        self._source = source
        # A streaming job can still run watermark-triggered eval rounds
        # over a finite --validation_data shard table; those tasks are
        # not stream-tagged and read through the batch reader.
        self._fallback = fallback

    @property
    def source(self) -> StreamSource:
        return self._source

    def read_records(self, task) -> Iterator[bytes]:
        extended = getattr(task, "extended_config", None) or {}
        if not extended.get("stream"):
            if self._fallback is None:
                raise ValueError(
                    f"non-stream task {task.shard_name!r} but no "
                    "fallback reader (pass --validation_data on the "
                    "worker too)"
                )
            yield from self._fallback.read_records(task)
            return
        for payload in self._source.read(
            task.shard_name, task.start, task.end
        ):
            yield payload

    def create_shards(self) -> Dict[str, Tuple[int, int]]:
        return {}

    @property
    def metadata(self) -> Metadata:
        return Metadata(stream=True)
