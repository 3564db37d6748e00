"""Streaming ingestion: pump a live stream tail into the task
dispatcher (copy of elasticdl_tpu/master/stream_ingest.py; the port
keeps its own, and journals the same ``stream`` records).

The batch control plane walks a finite shard table per epoch; this
module replaces that walk for online / continual learning. A
``StreamIngestor`` bridges one ``data/stream.py`` source to one
streaming-mode ``TaskDispatcher``:

- **unbounded task generation**: each ``pump()`` tails every
  partition's high-water mark and queues offset-ranged TRAINING tasks
  for the new records (``dispatcher.create_stream_tasks`` — journaled,
  so replay rebuilds the identical todo queue);
- **backpressure**: task generation pauses while the todo queue holds
  ``max_todo`` or more tasks — a lagging worker fleet bounds master
  memory instead of growing it, and the stall is metered
  (``stream_ingest_backpressure_seconds``);
- **watermark accounting**: the committed watermark per partition
  (folded from REPORT records — see ``journal.advance_stream_watermark``)
  is compared against the tail to publish
  ``stream_ingest_watermark_lag_seconds`` and
  ``stream_ingest_offsets_committed_total``; the
  ``stream-watermark-stall`` SLO rule (observability/slo.py) burns on
  the lag gauge;
- **watermark-triggered eval**: every ``eval_every_records`` committed
  records the evaluation service opens a round
  (``EvaluationService.add_watermark_eval_if_needed``) — the streaming
  replacement for epoch-end eval.

Crash/preemption resume needs NO code here: the dispatcher's stream
state (committed watermarks + the ``next`` generation cursor) rides
its journal snapshots and REPORT/STREAM records, so a recovered
master's ingestor simply continues pumping from the restored cursors —
offsets below the committed watermark are never re-tasked and never
re-acked. ``chaos/stream_drill.py`` kills a worker AND a row shard in
one window to prove it.
"""

import threading
import time
from typing import Dict, Optional

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.data.stream import StreamSource

logger = get_logger("stream_ingest")


class StreamIngestor:
    """Pump loop from one ``StreamSource`` into one streaming
    ``TaskDispatcher`` (see module docstring)."""

    def __init__(
        self,
        source: StreamSource,
        dispatcher,
        max_todo: int = 64,
        eval_service=None,
        eval_every_records: int = 0,
        model_version_fn=None,
        metrics_registry=None,
    ):
        self._source = source
        self._dispatcher = dispatcher
        self._max_todo = max(1, int(max_todo))
        self._eval_service = eval_service
        self._eval_every_records = int(eval_every_records)
        self._model_version_fn = model_version_fn
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._last_pump = None  # monotonic time of the previous pump
        self._backpressured = False
        self._backpressure_total = 0.0
        self._lag_seconds: Dict[str, float] = {}
        self._committed_seen: Dict[str, int] = {}

        from elasticdl_tpu_torch.observability import default_registry

        registry = metrics_registry or default_registry()
        self._m_lag = registry.gauge(
            "stream_ingest_watermark_lag_seconds",
            "Age of the oldest uncommitted stream record per partition",
            ["partition"],
        )
        self._m_committed = registry.counter(
            "stream_ingest_offsets_committed_total",
            "Stream offsets durably committed (watermark advances)",
            ["partition"],
        )
        self._m_backpressure = registry.counter(
            "stream_ingest_backpressure_seconds",
            "Cumulative seconds task generation was paused because "
            "the todo queue held max_todo tasks (worker fleet lagging)",
        )
        if eval_service is not None and self._eval_every_records > 0:
            # Seed the marker with the recovered committed total so a
            # master restart does not fire one round per historical
            # threshold crossing.
            eval_service.configure_watermark_eval(
                self._eval_every_records,
                start_at=self._committed_total(),
            )

    # ---- accounting ----------------------------------------------------

    def _committed_total(self) -> int:
        return sum(
            int(part["committed"])
            for part in self._dispatcher.stream_progress().values()
        )

    def _model_version(self) -> int:
        if self._model_version_fn is None:
            return -1
        return int(self._model_version_fn())

    # ---- the pump ------------------------------------------------------

    def pump(self) -> dict:
        """One ingestion pass; safe to call from a drill loop or the
        background thread. Returns a summary dict (tasks generated,
        backpressure verdict, per-partition lag)."""
        now = time.monotonic()
        with self._lock:
            elapsed = (
                now - self._last_pump
                if self._last_pump is not None else 0.0
            )
            self._last_pump = now
            if self._backpressured and elapsed > 0:
                # The PREVIOUS pass found the queue full: everything
                # since then was stall time, whether or not this pass
                # unblocks.
                self._backpressure_total += elapsed
                self._m_backpressure.inc(elapsed)

            generated = 0
            blocked = False
            progress = self._dispatcher.stream_progress()
            for partition in self._source.partitions():
                self._dispatcher.register_stream_partition(partition)
                end = int(self._source.end_offset(partition))
                cursor = int(
                    progress.get(partition, {}).get("next", 0)
                )
                if end <= cursor:
                    continue
                todo, _doing = self._dispatcher.queue_depths()
                budget = self._max_todo - todo
                if budget <= 0:
                    blocked = True
                    continue
                per_task = self._dispatcher._records_per_task
                stop = min(end, cursor + budget * per_task)
                generated += self._dispatcher.create_stream_tasks(
                    partition, cursor, stop,
                    model_version=self._model_version(),
                )
                if stop < end:
                    blocked = True
            self._backpressured = blocked

            # Watermark telemetry from the post-generation state.
            progress = self._dispatcher.stream_progress()
            wall = time.time()
            for partition, part in progress.items():
                committed = int(part["committed"])
                end = int(self._source.end_offset(partition))
                if committed < end:
                    appended = self._source.append_time(
                        partition, committed
                    )
                    lag = max(0.0, wall - appended) if appended else 0.0
                else:
                    lag = 0.0
                self._lag_seconds[partition] = lag
                self._m_lag.labels(partition).set(lag)
                seen = self._committed_seen.get(partition, 0)
                if committed > seen:
                    self._m_committed.labels(partition).inc(
                        committed - seen
                    )
                    self._committed_seen[partition] = committed

        if self._eval_service is not None \
                and self._eval_every_records > 0:
            # Outside the ingestor lock: opening a round takes the
            # eval service's lock and appends to the journal.
            self._eval_service.add_watermark_eval_if_needed(
                self._committed_total(),
                model_version=self._model_version(),
            )
        return {
            "generated": generated,
            "backpressured": blocked,
            "lag_seconds": dict(self._lag_seconds),
        }

    # ---- lifecycle -----------------------------------------------------

    def start(self, interval_secs: float = 0.5):
        """Run ``pump`` on a daemon thread every ``interval_secs``."""
        if self._thread is not None:
            return
        self._stop.clear()

        def _loop():
            while not self._stop.wait(interval_secs):
                try:
                    self.pump()
                except Exception:
                    logger.exception("stream pump failed; continuing")

        self._thread = threading.Thread(
            target=_loop, name="stream-ingest", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def close(self):
        """Retire the stream: stop pumping and let the dispatcher's
        ``finished`` fire once the queues drain."""
        self.stop()
        self._dispatcher.close_stream()

    # ---- introspection -------------------------------------------------

    @property
    def backpressure_seconds(self) -> float:
        return self._backpressure_total

    def render(self) -> dict:
        """The ``/stream`` endpoint body (master/main.py mounts it next
        to ``/sched``)."""
        progress = self._dispatcher.stream_progress()
        partitions = {}
        for partition, part in sorted(progress.items()):
            end = int(self._source.end_offset(partition))
            committed = int(part["committed"])
            partitions[partition] = {
                "end": end,
                "committed": committed,
                "next": int(part["next"]),
                "pending_ranges": len(part.get("pending") or {}),
                "lag_records": max(0, end - committed),
                "watermark_lag_seconds": float(
                    self._lag_seconds.get(partition, 0.0)
                ),
            }
        return {
            "partitions": partitions,
            "backpressure_seconds": float(self._backpressure_total),
            "backpressured": bool(self._backpressured),
            "max_todo": int(self._max_todo),
            "eval_every_records": int(self._eval_every_records),
        }
