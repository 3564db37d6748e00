"""Cold tier: spilled embedding rows in CRC-framed disk segments (port
of elasticdl_tpu/storage/cold_store.py; the same files, byte for byte).

The disk half of the tiered row store (``storage/tiered.py``). Rows
demoted from the hot arena append to bounded **segment files**; an
**in-memory index** maps id → (segment, offset);
reads batch by segment so a pull that faults N cold rows pays one
open + N seeks, not N opens. Overwrites append a fresh record and
leave the old one as garbage; segments whose live fraction drops
under a threshold are **compacted** (live rows re-appended to the
tail, the segment deleted) on a background thread.

On-disk record (all records of one store are the same size):

    u32le frame_len | frame_shard_blob(id int64le + row float32[dim])

— the same ``EDLC1`` magic + CRC32 framing as checkpoint shard files
(``checkpoint/state_io.py``), length-prefixed like the master
journal's records, so torn tails truncate instead of poisoning reads
and bit rot is caught by checksum before a row ever reaches training.

Durability: the cold store is a **spill cache, not a durability
tier** — checkpoints own durability (a fresh process wipes the cold
dir and repopulates through checkpoint restore). Writes flush but
never fsync (reads of the live tail come from an in-RAM copy);
crash-consistency of the *table* is the checkpoint chain's job,
crash-consistency of the *files* falls out of the append-only
framing (``elasticdl_tpu_torch.tools.check_store`` is the fsck).
"""

import json
import mmap
import os
import re
import shutil
import struct
import threading
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.checkpoint.state_io import (
    CorruptCheckpointError,
    SHARD_MAGIC,
    frame_shard_blob,
    unframe_shard_blob,
)
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("cold_store")

MANIFEST_FILE = "MANIFEST.json"
INDEX_SNAPSHOT_FILE = "index.json"
SEGMENT_RE = re.compile(r"^segment-(\d{6})\.seg$")
_LEN_BYTES = 4
_FRAME_HEADER = len(SHARD_MAGIC) + 4  # magic + crc32


class ColdStoreError(RuntimeError):
    """A cold-tier segment cannot be read back (CRC mismatch, index
    pointing past a segment, id mismatch at the indexed offset)."""


# ---- chaos seam (its installer, the chaos plane, is not ported yet) ------
# _mid_compact_hook(seg_id): after a victim segment's live rows were
# re-appended to the tail but BEFORE the victim file is deleted — the
# window a kill-mid-compaction drill targets.
_mid_compact_hook: Optional[Callable] = None


def set_chaos_hooks(mid_compact: Optional[Callable] = None):
    global _mid_compact_hook
    _mid_compact_hook = mid_compact


def _segment_name(seg: int) -> str:
    return f"segment-{seg:06d}.seg"


def record_bytes(dim: int) -> int:
    """On-disk size of one row record for ``dim``."""
    return _LEN_BYTES + _FRAME_HEADER + 8 + 4 * int(dim)


class ColdRowStore:
    """Append-only segmented row spill with an in-memory index.

    ``fresh=True`` (the tier wrapper's default) wipes any previous
    contents: a restarted process must repopulate through checkpoint
    restore, not resurrect a dead incarnation's spill. ``fresh=False``
    rebuilds the index by scanning segments (later records win; a torn
    tail on the newest segment truncates) — the recovery path fsck and
    tests exercise to prove segments are self-describing.
    """

    def __init__(self, path: str, dim: int = 0, *,
                 segment_max_bytes: int = 8 << 20,
                 compact_live_fraction: float = 0.5,
                 background_compact: bool = True,
                 fresh: bool = True,
                 metrics_registry=None):
        self.path = path
        self._lock = threading.RLock()
        self._index: Dict[int, Tuple[int, int]] = {}
        self._seg_live: Dict[int, int] = {}
        self._seg_records: Dict[int, int] = {}
        self._read_maps: Dict[int, mmap.mmap] = {}
        # In-RAM copy of the (bounded) tail segment: eviction appends
        # there and a thrashed row faults back soon after — serving
        # those reads from memory avoids re-mapping a growing file
        # and paying its page faults every pull. Sealed segments are
        # mmap-read (paged in once).
        self._tail_buf = bytearray()
        self._tail_f = None
        self._closed = False
        self.compact_live_fraction = float(compact_live_fraction)
        if fresh:
            if os.path.isdir(path):
                shutil.rmtree(path)
            os.makedirs(path, exist_ok=True)
            if not dim:
                raise ValueError("fresh ColdRowStore needs dim > 0")
            self.dim = int(dim)
            self.segment_max_bytes = int(segment_max_bytes)
            with open(os.path.join(path, MANIFEST_FILE), "w") as f:
                json.dump({
                    "dim": self.dim,
                    "segment_max_bytes": self.segment_max_bytes,
                    "record_bytes": record_bytes(self.dim),
                }, f)
            self._tail = 0
            self._tail_size = 0
        else:
            manifest = self.read_manifest(path)
            self.dim = int(manifest["dim"])
            self.segment_max_bytes = int(manifest["segment_max_bytes"])
            self._recover()
        # A snapshot is only meaningful for a CLOSED store; a live one
        # diverges immediately, and fsck would flag the stale file.
        snap = os.path.join(path, INDEX_SNAPSHOT_FILE)
        if os.path.exists(snap):
            os.unlink(snap)
        self._rec_len = record_bytes(self.dim)
        from elasticdl_tpu_torch.observability import default_registry

        registry = metrics_registry or default_registry()
        self._m_compactions = registry.counter(
            "row_tier_compactions_total",
            "Cold-tier segments compacted (live rows re-appended, "
            "segment deleted)",
        )
        self._compact_event = threading.Event()
        self._compact_thread = None
        self._compacting = False
        self._background = bool(background_compact)

    # ---- manifest / recovery -------------------------------------------

    @staticmethod
    def read_manifest(path: str) -> dict:
        with open(os.path.join(path, MANIFEST_FILE)) as f:
            return json.load(f)

    @staticmethod
    def list_segments(path: str) -> List[int]:
        out = []
        for entry in os.listdir(path):
            m = SEGMENT_RE.match(entry)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    @staticmethod
    def scan_segment(path: str, seg: int, rec_len: int,
                     allow_torn_tail: bool):
        """Walk one segment file: yields ``(row_id, offset)`` per
        intact record. A short/garbled record raises ColdStoreError
        unless ``allow_torn_tail`` (the newest segment of a crashed
        process), where it TRUNCATES — everything before the tear is
        intact by CRC. Returns the list plus the torn flag via a
        ``(records, torn)`` tuple."""
        records, torn = [], False
        fname = os.path.join(path, _segment_name(seg))
        with open(fname, "rb") as f:
            data = f.read()
        offset = 0
        while offset < len(data):
            tear = None
            if offset + _LEN_BYTES > len(data):
                tear = "short length prefix"
            else:
                (flen,) = struct.unpack_from("<I", data, offset)
                if flen != rec_len - _LEN_BYTES:
                    tear = f"record length {flen} != {rec_len - _LEN_BYTES}"
                elif offset + _LEN_BYTES + flen > len(data):
                    tear = "record past end of file"
            if tear is None:
                frame = data[offset + _LEN_BYTES:offset + rec_len]
                try:
                    blob = unframe_shard_blob(
                        frame, f"{fname}@{offset}"
                    )
                    if not frame.startswith(SHARD_MAGIC):
                        tear = "record lacks frame magic"
                except CorruptCheckpointError as exc:
                    tear = str(exc)
            if tear is not None:
                if not allow_torn_tail:
                    raise ColdStoreError(
                        f"{fname}@{offset}: {tear}"
                    )
                torn = True
                break
            (row_id,) = struct.unpack_from("<q", blob, 0)
            records.append((row_id, offset))
            offset += rec_len
        return records, torn

    def _recover(self):
        rec_len = record_bytes(self.dim)
        segs = self.list_segments(self.path)
        self._tail = segs[-1] if segs else 0
        self._tail_size = 0
        for seg in segs:
            records, torn = self.scan_segment(
                self.path, seg, rec_len, allow_torn_tail=seg == segs[-1]
            )
            if torn:
                # Drop the tear so appends resume on a clean boundary.
                keep = len(records) * rec_len
                fname = os.path.join(self.path, _segment_name(seg))
                with open(fname, "rb+") as f:
                    f.truncate(keep)
                logger.warning(
                    "cold store %s: truncated torn tail of segment "
                    "%d at %d records", self.path, seg, len(records),
                )
            self._seg_records[seg] = len(records)
            self._seg_live[seg] = 0
            for row_id, offset in records:
                old = self._index.get(row_id)
                if old is not None:
                    self._seg_live[old[0]] -= 1
                self._index[row_id] = (seg, offset)
                self._seg_live[seg] += 1
            if seg == self._tail:
                self._tail_size = len(records) * rec_len
                fname = os.path.join(
                    self.path, _segment_name(seg)
                )
                with open(fname, "rb") as f:
                    self._tail_buf = bytearray(
                        f.read(self._tail_size)
                    )
        # A clean close's index snapshot is authoritative for DROPS:
        # drop_rows only unindexes (no tombstone record), so a
        # replayed id absent from the snapshot is a dropped row —
        # garbage, not live. No snapshot = crash, where drops since
        # the last clean close are forgotten (the spill-cache
        # contract: a stale record either gets re-dropped or shadowed
        # by the checkpoint restore that owns durability).
        snap_path = os.path.join(self.path, INDEX_SNAPSHOT_FILE)
        if os.path.exists(snap_path):
            try:
                with open(snap_path) as f:
                    snap_ids = {int(k) for k in json.load(f)["index"]}
            except (OSError, ValueError, KeyError) as exc:
                logger.warning(
                    "cold store %s: unreadable index snapshot (%s); "
                    "keeping the segment-replay view", self.path, exc,
                )
                return
            for row_id in [i for i in self._index
                           if i not in snap_ids]:
                seg, _offset = self._index.pop(row_id)
                self._seg_live[seg] -= 1

    # ---- write path ----------------------------------------------------

    def _tail_file(self):
        if self._tail_f is None:
            self._tail_f = open(
                os.path.join(self.path, _segment_name(self._tail)), "ab"
            )
        return self._tail_f

    def _rotate(self):
        if self._tail_f is not None:
            self._tail_f.flush()
            self._tail_f.close()
            self._tail_f = None
        self._tail += 1
        self._tail_size = 0
        self._tail_buf = bytearray()

    def put_rows(self, ids, rows) -> None:
        """Append (or overwrite) rows; replaced records become garbage
        in their old segments. One contiguous write per filled
        segment."""
        ids = np.ascontiguousarray(np.asarray(ids, np.int64))
        rows = np.ascontiguousarray(np.asarray(rows, np.float32))
        if rows.shape != (ids.size, self.dim):
            raise ValueError(
                f"rows shape {rows.shape} != ({ids.size}, {self.dim})"
            )
        with self._lock:
            if self._closed:
                raise RuntimeError("cold store is closed")
            pos = 0
            while pos < ids.size:
                room = (
                    self.segment_max_bytes - self._tail_size
                ) // self._rec_len
                if room < 1:
                    self._rotate()
                    continue
                chunk = slice(pos, min(ids.size, pos + room))
                offset = self._tail_size
                n = chunk.stop - chunk.start
                # Vectorized encode — one (n, rec_len) byte matrix,
                # byte-identical to per-row frame_shard_blob framing
                # (the CRC loop is the only per-record Python, and
                # zlib runs at C speed).
                hdr = _LEN_BYTES + _FRAME_HEADER
                recs = np.empty((n, self._rec_len), np.uint8)
                recs[:, :_LEN_BYTES] = np.frombuffer(
                    struct.pack("<I", self._rec_len - _LEN_BYTES),
                    np.uint8,
                )
                recs[:, _LEN_BYTES:_LEN_BYTES + len(SHARD_MAGIC)] = (
                    np.frombuffer(SHARD_MAGIC, np.uint8)
                )
                recs[:, hdr:hdr + 8] = (
                    ids[chunk].astype("<i8", copy=False)
                    .view(np.uint8).reshape(n, 8)
                )
                recs[:, hdr + 8:] = (
                    rows[chunk].view(np.uint8).reshape(n, 4 * self.dim)
                )
                crcs = np.empty((n,), "<u4")
                for k in range(n):
                    crcs[k] = zlib.crc32(recs[k, hdr:]) & 0xFFFFFFFF
                recs[:, hdr - 4:hdr] = crcs.view(np.uint8).reshape(n, 4)
                data = recs.tobytes()
                f = self._tail_file()
                f.write(data)
                f.flush()
                self._tail_buf += data
                seg = self._tail
                self._seg_records[seg] = (
                    self._seg_records.get(seg, 0)
                    + (chunk.stop - chunk.start)
                )
                self._seg_live.setdefault(seg, 0)
                for i in range(chunk.start, chunk.stop):
                    row_id = int(ids[i])
                    old = self._index.get(row_id)
                    if old is not None:
                        self._seg_live[old[0]] -= 1
                    self._index[row_id] = (seg, offset)
                    self._seg_live[seg] += 1
                    offset += self._rec_len
                self._tail_size = offset
                pos = chunk.stop
        self._maybe_compact()

    def drop_rows(self, ids) -> int:
        """Forget rows (their records become garbage). Used when a
        promoted row is rewritten hot-side and the caller chooses to
        unshadow rather than leave a stale record. No tombstone is
        written: drops are durable only through a clean close (the
        index snapshot), which is all the spill-cache contract
        needs — a crashed store is wiped and rebuilt from checkpoint
        in production."""
        dropped = 0
        with self._lock:
            for row_id in np.asarray(ids, np.int64).ravel():
                old = self._index.pop(int(row_id), None)
                if old is not None:
                    self._seg_live[old[0]] -= 1
                    dropped += 1
        if dropped:
            self._maybe_compact()
        return dropped

    # ---- read path -----------------------------------------------------

    def _read_map(self, seg: int, need: int) -> mmap.mmap:
        """Read-only mmap of a segment, (re)mapped when the cached
        view is shorter than ``need`` (the tail grows under appends).
        Scattered faults gather straight out of the page cache — no
        per-span syscall."""
        mm = self._read_maps.get(seg)
        if mm is None or len(mm) < need:
            if mm is not None:
                mm.close()
            fd = os.open(
                os.path.join(self.path, _segment_name(seg)),
                os.O_RDONLY,
            )
            try:
                mm = mmap.mmap(fd, 0, access=mmap.ACCESS_READ)
            finally:
                os.close(fd)
            self._read_maps[seg] = mm
            if len(mm) < need:
                raise ColdStoreError(
                    f"segment {seg}: file is {len(mm)} bytes, index "
                    f"points to {need}"
                )
        return mm

    def get_rows(self, ids) -> np.ndarray:
        """Batched read: ids grouped by segment, each segment's
        records gathered in ONE vectorized pass over its mmap (decode
        is a numpy fancy-index plus per-record C-speed CRC — a fault
        that pulls back an evicted batch pays page-cache memcpy, not a
        syscall per row). Raises KeyError on an unindexed id,
        ColdStoreError on CRC/id mismatch (bit rot)."""
        ids = np.asarray(ids, np.int64).ravel()
        out = np.empty((ids.size, self.dim), np.float32)
        rec_len = self._rec_len
        hdr = _LEN_BYTES + _FRAME_HEADER
        magic = np.frombuffer(SHARD_MAGIC, np.uint8)
        with self._lock:
            index = self._index
            by_seg: Dict[int, List[Tuple[int, int, int]]] = {}
            for pos, row_id in enumerate(ids.tolist()):
                seg, offset = index[row_id]  # KeyError = absent
                by_seg.setdefault(seg, []).append((offset, pos, row_id))
            for seg, entries in by_seg.items():
                entries.sort()
                offs = np.array([e[0] for e in entries], np.int64)
                if seg == self._tail:
                    # The growing tail reads from its RAM copy.
                    if int(offs[-1]) + rec_len > len(self._tail_buf):
                        raise ColdStoreError(
                            f"segment {seg}: tail is "
                            f"{len(self._tail_buf)} bytes, index "
                            f"points to {int(offs[-1]) + rec_len}"
                        )
                    base = np.frombuffer(self._tail_buf, np.uint8,
                                         len(self._tail_buf))
                else:
                    mm = self._read_map(seg, int(offs[-1]) + rec_len)
                    base = np.frombuffer(mm, np.uint8, len(mm))
                recs = base[offs[:, None] + np.arange(rec_len)]
                if not (
                    recs[:, _LEN_BYTES:_LEN_BYTES + magic.size]
                    == magic
                ).all():
                    raise ColdStoreError(
                        f"segment {seg}: record lacks frame magic"
                    )
                want = recs[:, hdr - 4:hdr].copy().view("<u4").ravel()
                for k in range(recs.shape[0]):
                    got = zlib.crc32(recs[k, hdr:]) & 0xFFFFFFFF
                    if got != int(want[k]):
                        raise ColdStoreError(
                            f"segment {seg}@{entries[k][0]}: crc32 "
                            f"mismatch (want {int(want[k]):#010x}, "
                            f"got {got:#010x})"
                        )
                got_ids = (
                    recs[:, hdr:hdr + 8].copy().view("<i8").ravel()
                )
                exp_ids = np.array([e[2] for e in entries], np.int64)
                if not np.array_equal(got_ids, exp_ids):
                    k = int(np.nonzero(got_ids != exp_ids)[0][0])
                    raise ColdStoreError(
                        f"segment {seg}@{entries[k][0]}: holds id "
                        f"{int(got_ids[k])}, index says "
                        f"{int(exp_ids[k])}"
                    )
                rows = (
                    recs[:, hdr + 8:].copy().view("<f4")
                    .reshape(-1, self.dim)
                )
                out[np.array([e[1] for e in entries], np.int64)] = rows
        return out

    def contains(self, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64).ravel()
        with self._lock:
            index = self._index
            return np.fromiter(
                (i in index for i in ids.tolist()), bool, ids.size
            )

    def intersect(self, id_set) -> np.ndarray:
        """Sorted array of the given ids that have a live cold record
        — the tier wrapper's miss-resolution primitive (set-sized
        work, no per-row numpy round trip)."""
        with self._lock:
            index = self._index
            return np.array(
                sorted(i for i in id_set if i in index), np.int64
            )

    def live_ids(self) -> np.ndarray:
        with self._lock:
            return np.array(sorted(self._index), np.int64)

    @property
    def num_rows(self) -> int:
        return len(self._index)

    def stats(self) -> dict:
        with self._lock:
            segments = {
                seg: {
                    "records": self._seg_records.get(seg, 0),
                    "live": self._seg_live.get(seg, 0),
                    "bytes": self._seg_records.get(seg, 0)
                    * self._rec_len,
                }
                for seg in sorted(self._seg_records)
            }
            garbage = sum(
                (s["records"] - s["live"]) * 1 for s in segments.values()
            )
            return {
                "live_rows": len(self._index),
                "segments": segments,
                "garbage_records": garbage,
                "garbage_bytes": garbage * self._rec_len,
                "tail_segment": self._tail,
            }

    # ---- compaction ----------------------------------------------------

    def _compact_victim(self) -> Optional[int]:
        for seg in sorted(self._seg_records):
            if seg == self._tail:
                continue  # the tail is still filling
            records = self._seg_records.get(seg, 0)
            live = self._seg_live.get(seg, 0)
            if records and (
                live <= 0
                or live / records < self.compact_live_fraction
            ):
                return seg
        return None

    # Rows moved per lock acquisition during compaction: bounds how
    # long one compaction chunk can stall a concurrent fault read.
    COMPACT_CHUNK = 512

    def compact_once(self) -> bool:
        """Compact ONE victim segment (live fraction under threshold):
        re-append its live rows to the tail, delete the file. The move
        runs in ``COMPACT_CHUNK``-row chunks with the lock dropped in
        between — a fault never waits behind a whole segment's worth
        of copying. Returns whether anything was compacted."""
        from elasticdl_tpu_torch.observability import tracing

        with self._lock:
            if self._closed or self._compacting:
                # Re-entrant trigger (compaction's own re-append calls
                # put_rows → _maybe_compact): one pass at a time.
                return False
            seg = self._compact_victim()
            if seg is None:
                return False
            self._compacting = True
            live = [
                row_id for row_id, (s, _o) in self._index.items()
                if s == seg
            ]
        try:
            with tracing.span("row_tier_compact", segment=seg,
                              live_rows=len(live)):
                live.sort()
                for lo in range(0, len(live), self.COMPACT_CHUNK):
                    chunk = live[lo:lo + self.COMPACT_CHUNK]
                    with self._lock:
                        if self._closed:
                            return False
                        # Re-resolve: a drop/overwrite racing the
                        # chunked move may have retired entries.
                        index = self._index
                        chunk = [
                            i for i in chunk
                            if index.get(i, (None, 0))[0] == seg
                        ]
                        if not chunk:
                            continue
                        arr = np.array(chunk, np.int64)
                        rows = self.get_rows(arr)
                        # Re-append THROUGH the normal write path: the
                        # tail records supersede the victim's, so a
                        # crash between append and delete leaves a
                        # recoverable (later-record-wins) state, never
                        # a lossy one.
                        self.put_rows(arr, rows)
                with self._lock:
                    if self._closed:
                        return False
                    if _mid_compact_hook is not None:
                        _mid_compact_hook(seg)
                    mm = self._read_maps.pop(seg, None)
                    if mm is not None:
                        mm.close()
                    try:
                        os.unlink(
                            os.path.join(self.path, _segment_name(seg))
                        )
                    except OSError:
                        pass
                    self._seg_records.pop(seg, None)
                    self._seg_live.pop(seg, None)
        finally:
            self._compacting = False
        self._m_compactions.inc()
        return True

    def _maybe_compact(self):
        with self._lock:
            if self._closed or self._compact_victim() is None:
                return
        if not self._background:
            while self.compact_once():
                pass
            return
        with self._lock:
            if self._compact_thread is None:
                self._compact_thread = threading.Thread(
                    target=self._compact_loop, daemon=True,
                    name="cold-compactor",
                )
                self._compact_thread.start()
        self._compact_event.set()

    def _compact_loop(self):
        while True:
            self._compact_event.wait()
            self._compact_event.clear()
            if self._closed:
                return
            try:
                while self.compact_once():
                    pass
            except Exception as exc:  # diagnosable, not fatal
                logger.error("cold compaction failed: %s", exc)

    # ---- lifecycle -----------------------------------------------------

    def close(self, write_index: bool = True):
        """Flush, stop the compactor, snapshot the index (fsck's
        index-vs-segment consistency input — only ever present for a
        cleanly closed store)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._tail_f is not None:
                self._tail_f.flush()
                self._tail_f.close()
                self._tail_f = None
            for mm in self._read_maps.values():
                mm.close()
            self._read_maps.clear()
            if write_index:
                snap = os.path.join(self.path, INDEX_SNAPSHOT_FILE)
                tmp = snap + ".tmp"
                with open(tmp, "w") as f:
                    json.dump({
                        "index": {
                            str(k): [int(s), int(o)]
                            for k, (s, o) in self._index.items()
                        },
                    }, f)
                os.replace(tmp, snap)
        self._compact_event.set()  # release a parked compactor
