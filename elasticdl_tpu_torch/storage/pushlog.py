"""Write-ahead push log: zero-RPO durability for the row plane (port of
elasticdl_tpu/storage/pushlog.py; the same records, byte for byte).

Without it, a SIGKILLed row-service shard loses every *acked* push
applied since its last checkpoint: durability is bounded by checkpoint
cadence. With it, aggregation state survives server churn
independently of that cadence, the discipline the master's
write-ahead journal gives the task plane.

Layout (one log dir per shard)::

    {dir}/MANIFEST.json               # {"format": "pushlog-v1"}
    {dir}/pushlog-000000.wal          # append-only record segments
    {dir}/pushlog-000001.wal

Each record is ``u32le frame_len | frame_shard_blob(msgpack(record))``
(the cold store's and the checkpoint shard files' framing,
``checkpoint/state_io``), so torn tails truncate instead of poisoning
reads and bit rot is caught by CRC before msgpack sees the bytes. The
msgpack body is the port's own codec (``common/tensor_utils``), which
writes ``msgpack.packb``'s bytes. A record carries everything needed to
re-apply the push through the normal handler path::

    {"v": push version after apply, "client": str, "seq": int,
     "table": str, "ids": int64[n], "grads": float32[n, dim],
     "applied_at": wall clock, "map_version": shard-map epoch}

**Group commit.** Handlers never touch the disk: they append the
record to an in-memory queue (under the service lock, so log order ==
apply order) and a single commit thread writes + fsyncs the whole
batch: one fsync per ``--push_log_group_ms`` window, however many
pushes landed in it. Ack modes trade p99 for RPO:

- ``durable`` (default): the push RPC reply waits for the fsync
  covering its record; an acked push is on disk, RPO = 0.
- ``applied``: the reply returns after the in-memory apply; the record
  is queued and lands within the group window, so RPO is bounded by
  one window instead of one checkpoint interval.

**Truncation is fenced to checkpoint publish.** A segment is GC-able
only once a *durable* checkpoint version covers its last record
(``truncate_through``: the row service calls it from the checkpoint
writer after the publish, so the WAL and the chain can never both be
missing a row). Recovery = restore the checkpoint chain, then
``replay_records`` the tail through the normal apply path
(``row_service.configure_push_log``), where the checkpointed (client,
seq) dedup map and the per-record version gate make replay idempotent
and the installed ShardMap filters ranges that migrated away.
"""

import os
import re
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.checkpoint.state_io import (
    CorruptCheckpointError,
    SHARD_MAGIC,
    frame_shard_blob,
    unframe_shard_blob,
)
from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("pushlog")

MANIFEST_FILE = "MANIFEST.json"
PUSHLOG_FORMAT = "pushlog-v1"
SEGMENT_RE = re.compile(r"^pushlog-(\d{6})\.wal$")
_LEN_BYTES = 4
ACK_MODES = ("durable", "applied")


class PushLogError(RuntimeError):
    """The log cannot accept or return records (unreadable segment
    body, write/fsync failure on the commit thread, closed log)."""


# ---- chaos seam (its installer, the chaos plane, is not ported yet) ------
# _fsync_hook("pushlog"): runs on the commit thread ahead of each group
# commit's write+fsync; a fault plan's ``fsync_stall`` sleeps here so a
# slow-WAL-disk brownout lands exactly where durable-ack waiters feel
# it (the seam the brownout drill drives).
_fsync_hook: Optional[Callable[[str], None]] = None


def set_chaos_hooks(fsync: Optional[Callable[[str], None]] = None):
    global _fsync_hook
    _fsync_hook = fsync


def _segment_name(seg: int) -> str:
    return f"pushlog-{seg:06d}.wal"


def encode_record(record: dict) -> bytes:
    """One on-disk record: length prefix + CRC frame + msgpack body."""
    framed = frame_shard_blob(tensor_utils.dumps(record))
    return len(framed).to_bytes(_LEN_BYTES, "little") + framed


def validate_record_fields(record) -> Optional[str]:
    """Structural check on one decoded record (shared with
    ``tools/check_pushlog``); returns an error string or None."""
    if not isinstance(record, dict):
        return f"record decoded as {type(record).__name__}, not dict"
    for key, kinds in (("v", int), ("seq", int), ("map_version", int)):
        if not isinstance(record.get(key), kinds):
            return f"record lacks int {key!r}"
    for key in ("client", "table"):
        if not isinstance(record.get(key), str):
            return f"record lacks str {key!r}"
    if not isinstance(record.get("applied_at"), (int, float)):
        return "record lacks numeric 'applied_at'"
    ids = record.get("ids")
    grads = record.get("grads")
    if not isinstance(ids, np.ndarray) or ids.ndim != 1:
        return "record ids is not a 1-D ndarray"
    if not isinstance(grads, np.ndarray) or grads.ndim != 2:
        return "record grads is not a 2-D ndarray"
    if grads.shape[0] != ids.size:
        return (
            f"record grads rows {grads.shape[0]} != ids {ids.size}"
        )
    return None


def scan_segment(path: str, decode: bool = True
                 ) -> Tuple[List[Tuple[int, int, Optional[dict]]],
                            Optional[str]]:
    """Walk every intact record of one segment file.

    Returns ``([(offset, end_offset, record), ...], torn_reason)``:
    a short/garbled TAIL is reported (not raised) so callers can
    truncate to the longest intact prefix — exactly the master
    journal's torn-tail discipline. Corruption *before* the tail is
    indistinguishable from a tear here (the scan stops at the first
    bad frame); the fsck flags it by comparing against the next
    segment's presence.

    ``decode=False`` verifies framing + CRC only and yields ``None``
    records — the startup scan's mode (it needs torn-tail bounds and
    first/last versions, and fully deserializing every grad block
    twice per relaunch — once here, once in ``replay_records`` —
    would double the recovery serde for nothing).
    """
    records: List[Tuple[int, int, Optional[dict]]] = []
    with open(path, "rb") as fh:
        data = fh.read()
    offset = 0
    size = len(data)
    while offset < size:
        if offset + _LEN_BYTES > size:
            return records, "short length prefix"
        flen = int.from_bytes(data[offset:offset + _LEN_BYTES],
                              "little")
        start = offset + _LEN_BYTES
        end = start + flen
        if flen <= len(SHARD_MAGIC) + 4:
            return records, f"frame length {flen} too short"
        if end > size:
            return records, "record past end of file"
        frame = data[start:end]
        if not frame.startswith(SHARD_MAGIC):
            return records, "record lacks frame magic"
        record = None
        try:
            blob = unframe_shard_blob(frame, path)  # CRC verified
            if decode:
                record = tensor_utils.loads(blob)
        except (CorruptCheckpointError, Exception) as exc:
            return records, f"record at {offset} unreadable: {exc}"
        if decode:
            err = validate_record_fields(record)
            if err:
                return records, f"record at {offset}: {err}"
        records.append((offset, end, record))
        offset = end
    return records, None


def read_record_at(path: str, offset: int, end: int) -> dict:
    """Decode ONE record by its scan offsets (the startup scan reads
    just the first/last records for version bounds)."""
    with open(path, "rb") as fh:
        fh.seek(offset + _LEN_BYTES)
        frame = fh.read(end - offset - _LEN_BYTES)
    record = tensor_utils.loads(unframe_shard_blob(frame, path))
    err = validate_record_fields(record)
    if err:
        raise PushLogError(f"{path} record at {offset}: {err}")
    return record


class _Ticket:
    """One queued record's durability handle (durable-ack waiters
    block on it until the covering fsync lands). Carries the DECODED
    record: framing/CRC/msgpack run on the commit thread — the
    handler holds the service lock while appending, and per-push
    serialization under the hottest lock in the shard would queue
    every concurrent handler behind it."""

    __slots__ = ("record", "version", "_event", "error")

    def __init__(self, record: dict, version: int):
        self.record = record
        self.version = version
        self._event = threading.Event()
        self.error: Optional[BaseException] = None

    def wait(self, timeout: Optional[float] = None) -> None:
        if not self._event.wait(timeout):
            raise PushLogError(
                "push-log fsync did not complete in time "
                "(commit thread wedged?)"
            )
        if self.error is not None:
            raise PushLogError(
                f"push-log write failed: {self.error}"
            ) from self.error


class PushLog:
    """One shard's append-only write-ahead log of applied pushes."""

    def __init__(self, log_dir: str, group_ms: float = 2.0,
                 ack: str = "durable",
                 segment_max_bytes: int = 8 << 20,
                 metrics_registry=None):
        if ack not in ACK_MODES:
            raise ValueError(
                f"--push_log_ack must be one of {ACK_MODES}, got "
                f"{ack!r}"
            )
        from elasticdl_tpu_torch.observability import default_registry

        self.log_dir = log_dir
        self.ack = ack
        self._group_secs = max(0.0, float(group_ms)) / 1000.0
        self._segment_max_bytes = int(segment_max_bytes)
        os.makedirs(log_dir, exist_ok=True)
        manifest = os.path.join(log_dir, MANIFEST_FILE)
        if not os.path.exists(manifest):
            import json

            with open(manifest, "w") as fh:
                json.dump({"format": PUSHLOG_FORMAT}, fh)
                fh.flush()
                os.fsync(fh.fileno())
        registry = metrics_registry or default_registry()
        self._m_fsync = registry.histogram(
            "row_push_log_fsync_seconds",
            "Group-commit write+fsync latency per batch (the stall "
            "durable-mode pushes wait on; the default SLO ruleset "
            "alerts on its p99)",
        )
        self._m_group = registry.histogram(
            "row_push_log_group_size",
            "Records covered by one group-commit fsync",
        )
        self._m_bytes = registry.counter(
            "row_push_log_bytes_total",
            "Record bytes appended to the push log",
        )
        self._m_truncations = registry.counter(
            "row_push_log_truncations_total",
            "Log segments reclaimed because a durable checkpoint "
            "version covers their last record",
        )
        # Segment registry: {seg id: {"path", "bytes", "first_v",
        # "last_v"}} — mutated by the commit thread (rotation) and the
        # checkpoint writer thread (truncation) under _seg_lock.
        self._seg_lock = threading.Lock()
        self._segments: Dict[int, dict] = {}
        self._scan_and_truncate_torn()
        tail = max(self._segments) if self._segments else 0
        if tail not in self._segments:
            self._segments[tail] = {
                "path": os.path.join(log_dir, _segment_name(tail)),
                "bytes": 0, "first_v": None, "last_v": None,
            }
        self._tail = tail
        self._fh = open(self._segments[tail]["path"], "ab")
        # Group-commit queue (handlers append under the SERVICE lock,
        # so queue order is apply order; the condvar wakes the single
        # commit thread).
        self._cond = threading.Condition()
        self._queue: List[_Ticket] = []
        # Newest ticket ever issued: barrier() waits on it — commits
        # are FIFO, so its completion implies every earlier record's
        # (including a batch the commit thread has already dequeued
        # but not yet fsynced, which the queue alone would miss).
        self._last_ticket: Optional[_Ticket] = None
        self._closing = False
        self._abandoned = False
        self._broken: Optional[BaseException] = None
        self._last_fsync = 0.0
        self._thread = threading.Thread(
            target=self._commit_loop, daemon=True,
            name="push-log-commit",
        )
        self._thread.start()

    # ---- startup scan ---------------------------------------------------

    def _scan_and_truncate_torn(self):
        for entry in sorted(os.listdir(self.log_dir)):
            m = SEGMENT_RE.match(entry)
            if not m:
                continue
            seg = int(m.group(1))
            path = os.path.join(self.log_dir, entry)
            # Framing/CRC walk only: the full record decode happens
            # once, in replay_records — not twice per relaunch.
            records, torn = scan_segment(path, decode=False)
            intact_end = records[-1][1] if records else 0
            if torn is not None:
                # Torn tail from a crashed incarnation: truncate to
                # the longest intact prefix. Only the NEWEST segment
                # can legitimately tear (earlier ones were sealed by
                # rotation); a mid-log tear still truncates here, and
                # the fsck reports the version gap it leaves.
                logger.warning(
                    "push log %s torn (%s); truncating to %d intact "
                    "record(s)", path, torn, len(records),
                )
                with open(path, "r+b") as fh:
                    fh.truncate(intact_end)
                    fh.flush()
                    os.fsync(fh.fileno())
            first_v = last_v = None
            if records:
                first_v = int(read_record_at(
                    path, records[0][0], records[0][1]
                )["v"])
                last_v = int(read_record_at(
                    path, records[-1][0], records[-1][1]
                )["v"])
            self._segments[seg] = {
                "path": path,
                "bytes": intact_end,
                "first_v": first_v,
                "last_v": last_v,
            }

    def replay_records(self) -> Iterator[dict]:
        """Every intact record, oldest segment first — the relaunch
        replay source. Call BEFORE the first append (the row service
        replays at configure time, ahead of serving)."""
        with self._seg_lock:
            segs = sorted(self._segments)
        for seg in segs:
            info = self._segments.get(seg)
            if info is None or not os.path.exists(info["path"]):
                continue
            records, torn = scan_segment(info["path"])
            if torn is not None:
                raise PushLogError(
                    f"segment {info['path']} unreadable mid-replay "
                    f"({torn}); startup truncation should have "
                    "handled tears"
                )
            for _off, _end, record in records:
                yield record

    # ---- append (handler side) -----------------------------------------

    def append(self, *, version: int, client: str, seq: int,
               table: str, ids, grads, applied_at: float,
               map_version: int) -> _Ticket:
        """Enqueue one applied push for the next group commit. Call
        under the service lock (queue order must match apply order);
        ``wait()`` the returned ticket OUTSIDE the lock for durable
        acks."""
        record = {
            "v": int(version),
            "client": str(client),
            "seq": int(seq),
            "table": str(table),
            # No copy here: these are the handler's decoded request
            # arrays, never mutated after the apply — the commit
            # thread serializes them (ascontiguous conversion
            # included) off the lock.
            "ids": ids,
            "grads": grads,
            "applied_at": float(applied_at),
            "map_version": int(map_version),
        }
        ticket = _Ticket(record, int(version))
        with self._cond:
            if self._closing or self._abandoned:
                raise PushLogError("push log is closed")
            if self._broken is not None:
                raise PushLogError(
                    f"push log broken: {self._broken}"
                ) from self._broken
            self._queue.append(ticket)
            self._last_ticket = ticket
            self._cond.notify()
        return ticket

    def barrier(self, timeout: float = 60.0) -> None:
        """Block until everything appended so far is durable (the
        duplicate-push ack path: a retry must not ack before its
        original record's fsync lands). Waits on the NEWEST ticket
        issued, not the queue — the original record may be in a batch
        the commit thread already dequeued but has not fsynced yet,
        and commits are FIFO so the newest ticket's completion covers
        every record before it."""
        with self._cond:
            ticket = self._last_ticket
        if ticket is not None:
            ticket.wait(timeout=timeout)
        if self._broken is not None:
            raise PushLogError(
                f"push log broken: {self._broken}"
            ) from self._broken

    # ---- group commit ---------------------------------------------------

    def _commit_loop(self):
        while True:
            with self._cond:
                while (not self._queue and not self._closing
                       and not self._abandoned):
                    self._cond.wait()
                if self._abandoned:
                    return
                if not self._queue and self._closing:
                    return
            # Group window: coalesce pushes that land while we sleep
            # off the remainder of the window since the LAST fsync —
            # a lone push on an idle log pays (at most) one fsync, a
            # storm pays one fsync per window however many pushes it
            # lands. Draining (close) skips the wait.
            if not self._closing and self._group_secs > 0:
                wait_left = self._group_secs - (
                    time.monotonic() - self._last_fsync
                )
                if wait_left > 0:
                    time.sleep(wait_left)
            with self._cond:
                if self._abandoned:
                    return
                batch, self._queue = self._queue, []
            if not batch:
                continue
            t0 = time.monotonic()
            error: Optional[BaseException] = None
            try:
                hook = _fsync_hook
                if hook is not None:
                    hook("pushlog")
                blob = b"".join(
                    encode_record(t.record) for t in batch
                )
                self._fh.write(blob)
                self._fh.flush()
                os.fsync(self._fh.fileno())
            except BaseException as exc:
                error = exc
                logger.error("push-log group commit failed: %s", exc)
            self._last_fsync = time.monotonic()
            if error is None:
                with self._seg_lock:
                    info = self._segments[self._tail]
                    info["bytes"] += len(blob)
                    if info["first_v"] is None:
                        info["first_v"] = batch[0].version
                    info["last_v"] = batch[-1].version
                    rotate = info["bytes"] >= self._segment_max_bytes
                self._m_fsync.observe(self._last_fsync - t0)
                self._m_group.observe(float(len(batch)))
                self._m_bytes.inc(len(blob))
                if rotate:
                    self._rotate()
            else:
                # A failed write/fsync voids the durability promise:
                # fail the waiters loudly and refuse further appends
                # (the shard's WAL disk is broken — a silent fallback
                # to applied-ack would lie about RPO).
                with self._cond:
                    self._broken = error
            for ticket in batch:
                ticket.error = error
                ticket._event.set()

    def _rotate(self):
        """Seal the tail segment and open a fresh one (commit thread
        only). Sealed segments become truncation candidates once a
        durable checkpoint covers their last record."""
        try:
            self._fh.close()
        except OSError:
            pass
        with self._seg_lock:
            self._tail += 1
            self._segments[self._tail] = {
                "path": os.path.join(
                    self.log_dir, _segment_name(self._tail)
                ),
                "bytes": 0, "first_v": None, "last_v": None,
            }
            path = self._segments[self._tail]["path"]
        self._fh = open(path, "ab")

    # ---- truncation (checkpoint-fenced GC) ------------------------------

    def truncate_through(self, version: int) -> int:
        """Reclaim sealed segments whose LAST record a durable
        checkpoint ``version`` covers. Called from the checkpoint
        writer's post-publish path — never ahead of it, so a crash at
        any point leaves either the chain or the log (or both) holding
        every acked row. The tail segment is never reclaimed (it is
        the open append target). Returns segments removed."""
        removed = 0
        with self._seg_lock:
            for seg in sorted(self._segments):
                if seg == self._tail:
                    continue
                info = self._segments[seg]
                if info["last_v"] is None or info["last_v"] > version:
                    continue
                try:
                    os.remove(info["path"])
                except OSError as exc:
                    logger.warning(
                        "push-log truncation of %s failed: %s",
                        info["path"], exc,
                    )
                    continue
                del self._segments[seg]
                removed += 1
        if removed:
            self._m_truncations.inc(removed)
        return removed

    # ---- lifecycle -------------------------------------------------------

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closing or self._abandoned

    def close(self):
        """Drain the group-commit queue (one final fsync covers it)
        and retire the thread — the SIGTERM-clean path: stop() must
        never lose a queued record."""
        with self._cond:
            if self._closing or self._abandoned:
                return
            self._closing = True
            self._cond.notify()
        self._thread.join(timeout=60.0)
        try:
            self._fh.flush()
            os.fsync(self._fh.fileno())
        except (OSError, ValueError):
            pass
        try:
            self._fh.close()
        except OSError:
            pass

    def abandon(self):
        """Drop queued records and stop WITHOUT the final fsync — the
        in-process stand-in for SIGKILL (tests/drill fast lanes). A
        real kill loses exactly what this loses: records not yet
        covered by a group commit. Dropped tickets fail PROMPTLY so a
        concurrent durable-ack waiter raises 'abandoned' instead of
        hanging out its 60s timeout."""
        with self._cond:
            self._abandoned = True
            dropped, self._queue = self._queue, []
            self._cond.notify()
        err = PushLogError("push log abandoned (simulated kill)")
        for ticket in dropped:
            ticket.error = err
            ticket._event.set()
        self._thread.join(timeout=10.0)
        try:
            self._fh.close()
        except OSError:
            pass

    # ---- introspection (tests / fsck) -----------------------------------

    def segment_stats(self) -> Dict[int, dict]:
        with self._seg_lock:
            return {
                seg: dict(info)
                for seg, info in sorted(self._segments.items())
            }
