"""Bounded background checkpoint writer (copy of
elasticdl_tpu/checkpoint/writer.py).

The async capture/write split: the step/push path pays only a fast
in-memory capture (buffer clones under the caller's locks) plus an
enqueue here; serialization, checksumming, and file I/O run on ONE
background thread (per-shard file writes fan out inside the saver's
own pool). Ordering is FIFO, so versions publish in save order and the
"no version published until fully durable" rule composes with the
saver's tmp+rename+fsync publish.

Backpressure is the bounded queue: an interval save that finds it full
can skip (``block=False`` — its state is covered by the next
interval), while drain paths (``checkpoint_now``/``save_final``) block
for their turn and then ``flush()``. At most ``max_pending`` captured
snapshots exist at once, so slow storage bounds memory instead of
piling up host copies.

``sync=True`` runs jobs inline on the caller's thread (errors raise
immediately) — the chaos harness uses it for deterministic schedules,
and it is the pre-PR behavior for callers that want it.
"""

import threading
import time
from collections import deque
from typing import Callable, Optional

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.observability import tracing

logger = get_logger(__name__)


class CheckpointWriter:
    def __init__(self, max_pending: int = 2, sync: bool = False,
                 metrics_registry=None):
        self._sync = bool(sync)
        self._max_pending = max(1, int(max_pending))
        self._cond = threading.Condition()
        self._queue = deque()  # (fn, label, enqueue_t)
        self._active = 0  # jobs popped but not finished
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # Deferred failure surfaced at flush(); a newer successful
        # write supersedes an older failure — the freshest durable
        # state is what restores.
        self._pending_error: Optional[BaseException] = None
        from elasticdl_tpu_torch.observability import default_registry

        registry = metrics_registry or default_registry()
        self._m_depth = registry.gauge(
            "checkpoint_writer_queue_depth",
            "Captured checkpoints awaiting the background writer",
        )
        self._m_wait = registry.histogram(
            "checkpoint_writer_queue_seconds",
            "Capture-to-write-start latency in the writer queue",
        )

    @property
    def sync(self) -> bool:
        return self._sync

    def _pending(self) -> int:
        """In-flight captured snapshots: queued + actively writing.
        Caller holds the lock."""
        return len(self._queue) + self._active

    @property
    def busy(self) -> bool:
        """At capacity — a non-blocking submit would be refused.
        Interval savers check this BEFORE capturing, so a skipped
        interval doesn't drain dirty state it then has to put back."""
        if self._sync:
            return False
        with self._cond:
            return self._pending() >= self._max_pending

    def submit(self, fn: Callable[[], None], label: str = "ckpt",
               block: bool = True) -> bool:
        """Enqueue one write job. Returns False when ``block=False``
        and the queue is at capacity (the caller skips this interval
        and re-marks any drained dirty state). Sync mode runs inline
        and raises inline."""
        if self._sync:
            fn()
            return True
        with self._cond:
            if self._closed:
                raise RuntimeError("CheckpointWriter is closed")
            while self._pending() >= self._max_pending:
                if not block:
                    return False
                self._cond.wait()
            self._queue.append((fn, label, time.monotonic()))
            self._m_depth.set(float(len(self._queue)))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="ckpt-writer"
                )
                self._thread.start()
            self._cond.notify_all()
        return True

    def _run(self):
        # Ownership check instead of a shared retire flag: flush()
        # detaches the idle thread by nulling self._thread under the
        # lock; a submit racing in right after spawns a FRESH owner,
        # and this (dethroned) thread exits without stealing its jobs.
        me = threading.current_thread()
        while True:
            with self._cond:
                while (not self._queue and self._thread is me
                       and not self._closed):
                    self._cond.wait()
                if self._thread is not me or not self._queue:
                    return  # retired by flush(), or closed idle
                fn, label, t_enq = self._queue.popleft()
                self._active += 1
                self._m_depth.set(float(len(self._queue)))
                self._cond.notify_all()
            queue_wait = time.monotonic() - t_enq
            self._m_wait.observe(queue_wait)
            try:
                # Writer-queue span on this process's trace track: the
                # wall time a checkpoint spent queued + writing, off
                # the step path.
                with tracing.span("ckpt_write", label=label,
                                  queue_wait=round(queue_wait, 6)):
                    fn()
            except BaseException as exc:
                self._pending_error = exc
                logger.error(
                    "async checkpoint write (%s) failed: %s", label, exc
                )
            else:
                self._pending_error = None
            finally:
                with self._cond:
                    self._active -= 1
                    self._cond.notify_all()

    def flush(self):
        """Barrier: wait until every submitted write has landed, then
        raise any still-unsuperseded failure. After flush() returns
        cleanly, the newest submitted version is fully durable. The
        idle writer thread is RETIRED (a later submit spawns a fresh
        one) so flush-heavy callers — save_final, SIGTERM drains,
        short-lived test clusters — never leak parked threads."""
        if not self._sync:
            with self._cond:
                while self._queue or self._active:
                    self._cond.wait()
                thread, self._thread = self._thread, None
                self._cond.notify_all()
            if thread is not None:
                thread.join(timeout=30.0)
        if self._pending_error is not None:
            exc, self._pending_error = self._pending_error, None
            raise exc

    def close(self):
        """Flush, then refuse further submits."""
        try:
            self.flush()
        finally:
            with self._cond:
                self._closed = True
                self._cond.notify_all()
