"""Dynamic data sharding: the master's task queues.

A copy of elasticdl_tpu/master/task_dispatcher.py: the port keeps its own.

Counterpart of the reference's ``elasticdl/python/master/task_dispatcher.py``
(``_TaskDispatcher``): shards are split into tasks of
``records_per_task`` records; workers pull tasks from ``todo``, the master
tracks them in ``doing``; failed/dead-worker tasks are re-queued with a
retry cap; training tasks regenerate per epoch; when all training work is
done a deferred TRAIN_END_CALLBACK task is created (reference
task_dispatcher.py:206-241). This mechanism — not checkpoint-restart — is
what makes preemption cheap.
"""

import collections
import dataclasses
import random
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

from elasticdl_tpu_torch.common.constants import MAX_TASK_RETRIES, TaskType
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.task import Task
from elasticdl_tpu_torch.master.journal import (
    _stream_partition,
    advance_stream_watermark,
    new_stream_state,
    normalize_stream_state,
)

logger = get_logger("task_dispatcher")

# Bounded ledger of recently resolved task ids → original outcome.
# Serves two callers: at-least-once RPC retries (RpcStub re-sends a
# report whose response was lost) and post-crash re-reports from
# workers that rode out a master restart — both must get the original
# outcome back instead of the "Unknown task id" path, or accounting
# drifts. Sized to cover many report round-trips of in-flight retry
# ambiguity without growing with job length.
RESOLVED_LEDGER_SIZE = 512


class JobCounters:
    """Per-task-type record counters (reference task_dispatcher.py:40-61)."""

    def __init__(self):
        self.total_records = {}
        self.failed_records = {}

    def add_completed(self, task_type: str, n: int):
        self.total_records[task_type] = (
            self.total_records.get(task_type, 0) + n
        )

    def add_failed(self, task_type: str, n: int):
        self.failed_records[task_type] = (
            self.failed_records.get(task_type, 0) + n
        )


class TaskDispatcher:
    def __init__(
        self,
        training_shards: Dict[str, Tuple[int, int]],
        evaluation_shards: Optional[Dict[str, Tuple[int, int]]] = None,
        prediction_shards: Optional[Dict[str, Tuple[int, int]]] = None,
        records_per_task: int = 64,
        num_epochs: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        metrics_registry=None,
        streaming: bool = False,
    ):
        self._lock = threading.Lock()
        self._training_shards = dict(training_shards or {})
        self._evaluation_shards = dict(evaluation_shards or {})
        self._prediction_shards = dict(prediction_shards or {})
        self._records_per_task = records_per_task
        self._epochs_todo = num_epochs
        self._shuffle = shuffle
        self._rng = random.Random(seed)

        self._todo: List[Task] = []
        # task_id -> (task, worker_id, start_time)
        self._doing: Dict[int, Tuple[Task, int, float]] = {}
        self._task_id = 0
        # MaxStepsStopping support (reference callbacks.py:57-98): a cap on
        # dispatched TRAINING records; 0 = unlimited. Enforced at dispatch,
        # which is exact — the reference's worker-side version check is
        # best-effort across workers.
        self._max_train_records = 0
        self._train_records_dispatched = 0
        self._task_retry_count: Dict[str, int] = {}
        self._deferred_callbacks: List[Callable] = []
        self._worker_version: Dict[int, int] = {}
        # Workers being drained (elastic scale-down): fenced out of
        # dispatch so a dying pod cannot lease fresh work during its
        # SIGTERM grace — its DELETED event is deliberately ignored by
        # the instance manager, so a task leased post-drain would have
        # no death event to recover it. Volatile on purpose: not
        # journaled/exported (a fence only outlives its pod by the
        # grace window, and replay equivalence must not depend on it).
        self._fenced_workers = set()
        # Streaming-ingestion mode (master/stream_ingest.py,
        # docs/online_learning.md): tasks come from a live stream tail
        # instead of the epoch walk, so ``finished`` stays False while
        # the stream is open and per-partition watermark state rides
        # this dispatcher's snapshots. The watermark algebra is shared
        # with the journal's fold functions — one implementation for
        # live accounting, append-time mirroring, and replay.
        self._streaming = bool(streaming)
        self._stream_closed = False
        self._stream = new_stream_state()
        self.counters = JobCounters()
        # task_id -> (task, worker_id, requeued): the idempotent-report
        # ledger (see RESOLVED_LEDGER_SIZE above). OrderedDict as a
        # FIFO ring.
        self._resolved = collections.OrderedDict()
        # Write-ahead journal (master/journal.py); attached AFTER
        # construction (attach_journal) so the constructor's initial
        # create_tasks is part of the deterministic base state, not a
        # journaled event — replay rebuilds it from the same config.
        self._journal = None

        # Telemetry: queue health as pull-time gauges (evaluated per
        # scrape; reading a list length needs no lock) + dispatch
        # outcome counters. Families are idempotent on the shared
        # registry; set_function re-binds to the newest dispatcher.
        from elasticdl_tpu_torch.observability import default_registry, tracing

        registry = metrics_registry or default_registry()
        # Dispatch spans join the pulling task's trace (the RPC server
        # span — or, in-process, the worker's own task span — is the
        # ambient parent); free with no recorder installed.
        self._trace = tracing.Tracer("master")
        # weakref: the registry is process-global and outlives
        # dispatchers; a strong closure would pin a drained job's task
        # lists and shard metadata for the process lifetime.
        self_ref = weakref.ref(self)
        registry.gauge(
            "master_task_queue_depth", "Tasks waiting in the todo queue"
        ).set_function(
            lambda: len(d._todo) if (d := self_ref()) is not None else 0.0
        )
        registry.gauge(
            "master_tasks_doing", "Tasks currently leased to workers"
        ).set_function(
            lambda: len(d._doing) if (d := self_ref()) is not None else 0.0
        )
        self._m_dispatched = registry.counter(
            "master_tasks_dispatched_total",
            "Tasks handed to workers", ["type"],
        )
        self._m_completed = registry.counter(
            "master_tasks_completed_total",
            "Tasks reported successful", ["type"],
        )
        self._m_failed = registry.counter(
            "master_tasks_failed_total",
            "Tasks failed permanently (retry cap exhausted)", ["type"],
        )
        self._m_requeued = registry.counter(
            "master_task_requeues_total",
            "Failed/preempted tasks re-queued for another worker",
        )

        if self._training_shards:
            self.create_tasks(TaskType.TRAINING)
            self._epochs_todo -= 1
        elif self._evaluation_shards and not self._streaming:
            # Streaming jobs hold their eval shards for
            # watermark-triggered rounds (master/stream_ingest.py) —
            # auto-queuing them here would run an eval round before
            # the stream committed anything.
            self.create_tasks(TaskType.EVALUATION)
        elif self._prediction_shards:
            self.create_tasks(TaskType.PREDICTION)

    # ---- task creation -------------------------------------------------

    def _shards_for(self, task_type: str) -> Dict[str, Tuple[int, int]]:
        return {
            TaskType.TRAINING: self._training_shards,
            TaskType.EVALUATION: self._evaluation_shards,
            TaskType.PREDICTION: self._prediction_shards,
        }[task_type]

    def _build_tasks(self, task_type: str,
                     model_version: int = -1) -> List[Task]:
        """Split shards into records_per_task-sized tasks (pure; shared by
        initial creation and per-epoch regeneration)."""
        tasks = []
        for shard_name, (start, count) in self._shards_for(
            task_type
        ).items():
            for begin in range(start, start + count,
                               self._records_per_task):
                end = min(begin + self._records_per_task, start + count)
                tasks.append(
                    Task(
                        shard_name=shard_name,
                        start=begin,
                        end=end,
                        type=task_type,
                        model_version=model_version,
                    )
                )
        if self._shuffle and task_type == TaskType.TRAINING:
            self._rng.shuffle(tasks)
        return tasks

    def create_tasks(self, task_type: str, model_version: int = -1):
        """Split shards into tasks and queue them
        (reference task_dispatcher.py:134-204)."""
        with self._lock:
            tasks = self._build_tasks(task_type, model_version)
            if task_type == TaskType.EVALUATION:
                # Eval tasks jump the queue so they run close to the version
                # that triggered them (reference prepends eval tasks).
                self._todo = tasks + self._todo
            else:
                self._todo.extend(tasks)
            if self._journal is not None:
                self._journal.append(
                    "create_tasks", task_type=str(task_type),
                    model_version=int(model_version),
                )
            logger.info("Created %d %s tasks", len(tasks), task_type)

    def add_deferred_callback(self, callback: Callable):
        with self._lock:
            self._deferred_callbacks.append(callback)

    def create_train_end_callback_task(self):
        """One final task so a worker can run callbacks_list.on_train_end
        (reference task_dispatcher.py:206-241)."""
        with self._lock:
            if not self._training_shards:
                return
            name = next(iter(self._training_shards))
            self._todo.append(
                Task(shard_name=name, start=0, end=0,
                     type=TaskType.TRAIN_END_CALLBACK)
            )

    # ---- streaming mode (master/stream_ingest.py) ----------------------

    @property
    def is_streaming(self) -> bool:
        return self._streaming

    def register_stream_partition(self, partition: str):
        """Introduce a stream partition (idempotent). Journaled so a
        recovered master knows the partition set even before its first
        task lands."""
        partition = str(partition)
        with self._lock:
            self._streaming = True
            if partition in self._stream["partitions"]:
                return
            _stream_partition(self._stream, partition)
            if self._journal is not None:
                self._journal.append(
                    "stream", event="register", partition=partition
                )

    def create_stream_tasks(self, partition: str, start: int, end: int,
                            model_version: int = -1) -> int:
        """Queue offset-ranged TRAINING tasks covering ``[start, end)``
        of ``partition``, split at ``records_per_task``. One STREAM
        journal event covers the whole range: stream tasks come from
        the live tail (not CREATE_TASKS' epoch walk), so replay
        re-enqueues them from this record and the subsequent DISPATCH
        records must find the identical todo queue — the split is
        deterministic in (start, end, records_per_task). Ranges at or
        below the partition's ``next`` cursor are clipped (idempotent
        for an ingestor retrying after a lost ack). Returns the number
        of tasks queued."""
        partition = str(partition)
        with self._lock:
            self._streaming = True
            part = _stream_partition(self._stream, partition)
            start = max(int(start), int(part["next"]))
            end = int(end)
            if end <= start:
                return 0
            tasks = []
            for begin in range(start, end, self._records_per_task):
                tasks.append(Task(
                    shard_name=partition,
                    start=begin,
                    end=min(begin + self._records_per_task, end),
                    type=TaskType.TRAINING,
                    model_version=int(model_version),
                    extended_config={"stream": True},
                ))
            self._todo.extend(tasks)
            part["next"] = end
            if self._journal is not None:
                self._journal.append(
                    "stream", event="tasks", partition=partition,
                    start=int(start), end=int(end),
                    model_version=int(model_version),
                )
            return len(tasks)

    def close_stream(self):
        """No more stream tasks will be generated: ``finished`` may
        fire once the queues drain (a drill's clean shutdown, or an
        operator retiring the streaming job — the gang scheduler's
        completion sweep then marks the job done)."""
        with self._lock:
            self._stream_closed = True

    def stream_progress(self) -> Dict[str, dict]:
        """Per-partition {committed, next, pending} — ``committed`` is
        the exclusive watermark: every offset below it resolved
        successfully AND its REPORT record is fsynced. The ingestor's
        resume point and the ``/stream`` endpoint's body."""
        with self._lock:
            return {
                p: {
                    "committed": int(s["committed"]),
                    "next": int(s["next"]),
                    "pending": dict(s["pending"]),
                }
                for p, s in self._stream["partitions"].items()
            }

    # ---- worker-facing -------------------------------------------------

    def set_max_steps(self, max_steps: int, minibatch_size: int):
        """Bound total dispatched training records to
        ``max_steps × minibatch_size``."""
        with self._lock:
            self._max_train_records = (
                max_steps * minibatch_size if max_steps > 0 else 0
            )

    def _train_cap_reached_locked(self) -> bool:
        return bool(self._max_train_records) and (
            self._train_records_dispatched >= self._max_train_records
        )

    def _epochs_pending_locked(self) -> bool:
        return (
            self._epochs_todo > 0
            and bool(self._training_shards)
            and not self._train_cap_reached_locked()
        )

    def get(self, worker_id: int) -> Optional[Task]:
        """Pop a task for a worker; None when nothing is available
        (the servicer converts None into a WAIT task while unfinished)."""
        with self._trace.span("dispatch", worker=int(worker_id)) as sp:
            task = self._get(worker_id)
            if task is not None:
                sp.set(task_id=int(task.task_id), type=str(task.type))
            else:
                # WAIT / drained polls would drown the dispatch stats.
                sp.discard()
            return task

    def fence_worker(self, worker_id: int):
        """Stop dispatching to ``worker_id`` (drain_worker calls this
        BEFORE deleting the pod). Its get_task polls see WAIT until the
        pod dies."""
        with self._lock:
            self._fenced_workers.add(int(worker_id))

    def _get(self, worker_id: int) -> Optional[Task]:
        callbacks = []
        task = None
        with self._lock:
            if worker_id in self._fenced_workers:
                return None
            while True:
                if not self._todo and self._epochs_pending_locked():
                    self._create_training_tasks_locked()
                    self._epochs_todo -= 1
                if not self._todo:
                    break
                candidate = self._todo.pop(0)
                if (
                    candidate.type == TaskType.TRAINING
                    and self._max_train_records
                ):
                    remaining = (
                        self._max_train_records
                        - self._train_records_dispatched
                    )
                    if remaining <= 0:
                        continue  # drop: max_steps reached
                    if candidate.num_records > remaining:
                        # Trim the final task so the bound is exact at
                        # record (= step) granularity, not task
                        # granularity.
                        candidate.end = candidate.start + remaining
                task = candidate
                break
            if task is not None:
                if task.type == TaskType.TRAINING:
                    self._train_records_dispatched += task.num_records
                self._task_id += 1
                task.task_id = self._task_id
                self._doing[task.task_id] = (task, worker_id, time.time())
                self._m_dispatched.labels(task.type).inc()
                if self._journal is not None:
                    # Inside the lock, so the journal's event order
                    # matches the state-mutation order exactly —
                    # replay re-runs these ops through this same state
                    # machine and must see the same interleaving.
                    self._journal.append(
                        "dispatch", task_id=int(task.task_id),
                        worker_id=int(worker_id),
                        generation=int(self._journal.generation),
                        task=task.to_dict(),
                    )
            elif (
                not self._doing
                and not self._epochs_pending_locked()
                and self._deferred_callbacks
            ):
                # Dropping capped tasks can drain the queue outside
                # report(); fire deferred callbacks here too so the
                # train-end task still gets created.
                callbacks, self._deferred_callbacks = (
                    self._deferred_callbacks, []
                )
        for cb in callbacks:
            cb()
        if callbacks:
            return self._get(worker_id)
        return task

    def _create_training_tasks_locked(self):
        tasks = self._build_tasks(TaskType.TRAINING)
        self._todo.extend(tasks)
        logger.info("Created %d training tasks (new epoch)", len(tasks))

    def report(self, task_id: int, success: bool,
               err_reason: str = "") -> Tuple[Optional[Task], int, bool]:
        """Worker reports task completion (reference :286-350). Failed tasks
        re-queue at the front, up to MAX_TASK_RETRIES per shard range.
        Returns (task, worker_id, requeued)."""
        task, worker_id, requeued, _duplicate = self.apply_report(
            task_id, success, err_reason
        )
        return task, worker_id, requeued

    def apply_report(
        self, task_id: int, success: bool, err_reason: str = ""
    ) -> Tuple[Optional[Task], int, bool, bool]:
        """``report`` plus a ``duplicate`` flag, decided atomically
        under the lock: True iff the outcome came from the resolved
        ledger rather than a first application. The servicer needs
        the distinction to run report side effects (eval
        complete_task) exactly once even when at-least-once RPC
        retries race each other."""
        callbacks = []
        requeued = False
        with self._lock:
            entry = self._doing.pop(task_id, None)
            if entry is None:
                resolved = self._resolved.get(task_id)
                if resolved is not None:
                    # At-least-once RPC (or a re-report across a master
                    # restart): the first application already counted
                    # this task; hand back the original outcome instead
                    # of re-applying or warning.
                    logger.info(
                        "Task %d already resolved; returning original "
                        "outcome (duplicate report)", task_id,
                    )
                    return (*resolved, True)
                logger.warning("Unknown task id %d reported", task_id)
                return None, -1, False, False
            task, worker_id, _start = entry
            if success:
                self.counters.add_completed(task.type, task.num_records)
                self._m_completed.labels(task.type).inc()
                # Clear the shard's burned retries: the map otherwise
                # grows without bound across epochs, and next epoch's
                # identical shard key would inherit this epoch's
                # failures against its retry budget.
                self._task_retry_count.pop(
                    f"{task.shard_name}:{task.start}:{task.end}", None
                )
            else:
                key = f"{task.shard_name}:{task.start}:{task.end}"
                # Graceful preemption hand-backs (SIGTERM before the
                # pod dies) are not task failures: no records were
                # consumed and no real error occurred, so they must not
                # burn the shard's retry budget — repeatedly-preempted
                # shards would otherwise be dropped from training.
                preempted = err_reason.startswith("preempted")
                retries = self._task_retry_count.get(key, 0) + (
                    0 if preempted else 1
                )
                self._task_retry_count[key] = retries
                if retries <= MAX_TASK_RETRIES:
                    logger.info(
                        "Task %d failed (%s), re-queueing (retry %d)",
                        task_id, err_reason, retries,
                    )
                    # Fresh copy: the popped object is still referenced by
                    # the reporting worker; re-dispatch must not mutate it.
                    self._todo.insert(0, dataclasses.replace(task))
                    requeued = True
                    self._m_requeued.inc()
                    if task.type == TaskType.TRAINING:
                        # Re-queued records will be re-dispatched; release
                        # them from the max-steps budget.
                        self._train_records_dispatched -= task.num_records
                else:
                    self.counters.add_failed(task.type, task.num_records)
                    self._m_failed.labels(task.type).inc()
                    logger.error(
                        "Task %d failed permanently after %d retries (%s)",
                        task_id, MAX_TASK_RETRIES, err_reason,
                    )
            self._resolved[task_id] = (task, worker_id, requeued)
            while len(self._resolved) > RESOLVED_LEDGER_SIZE:
                self._resolved.popitem(last=False)
            stream_fields = {}
            if (task.extended_config or {}).get("stream"):
                # Offset commit is atomic with the resolution: the
                # stream fields ride the same REPORT record (see
                # journal.apply_stream_report_record), and the live
                # watermark advances only on success — a requeued or
                # failed range stays uncommitted until its retry
                # resolves, so recovery never re-acks.
                if success:
                    advance_stream_watermark(
                        _stream_partition(
                            self._stream, task.shard_name
                        ),
                        task.start, task.end,
                    )
                stream_fields = {
                    "stream_partition": str(task.shard_name),
                    "stream_start": int(task.start),
                    "stream_end": int(task.end),
                }
            if self._journal is not None:
                # Appended after the mutation completes (still inside
                # the lock): a snapshot triggered by this append must
                # capture the post-report state, and replay re-derives
                # the requeue decision from the same inputs. The
                # task's type/version and the requeue verdict ride
                # along so the eval plane's round progress is ATOMIC
                # with the resolution (journal.apply_eval_report_record
                # — a separate append would leave a crash window that
                # wedges the round).
                self._journal.append(
                    "report", task_id=int(task_id),
                    success=bool(success), err_reason=str(err_reason),
                    task_type=str(task.type),
                    model_version=int(task.model_version),
                    requeued=bool(requeued),
                    **stream_fields,
                )
            todo_undroppable = [
                t for t in self._todo
                if not (
                    t.type == TaskType.TRAINING
                    and self._train_cap_reached_locked()
                )
            ]
            if (
                not todo_undroppable
                and not self._doing
                and not self._epochs_pending_locked()
                and self._deferred_callbacks
            ):
                callbacks, self._deferred_callbacks = (
                    self._deferred_callbacks, []
                )
        # Fired outside the lock: callbacks typically append new tasks
        # (e.g. create_train_end_callback_task re-acquires the lock).
        for cb in callbacks:
            cb()
        return task, worker_id, requeued, False

    def recover_tasks(self, worker_id: int):
        """Re-queue all doing tasks of a dead worker
        (reference task_dispatcher.py:352-364)."""
        with self._lock:
            ids = [
                tid for tid, (_t, wid, _s) in self._doing.items()
                if wid == worker_id
            ]
        for tid in ids:
            self.report(tid, False, err_reason="worker_dead")

    def preempt_leases(self, reason: str = "preempted: gang released"
                       ) -> int:
        """Hand every leased task back to the front of the queue —
        the gang scheduler evicting this job (master/scheduler.py).
        Rides the graceful-preemption path of ``apply_report`` (the
        ``preempted`` err_reason prefix), so retry budgets are NOT
        burned and the resolved ledger keeps late duplicate reports
        from the evicted workers idempotent. Returns the number of
        leases handed back."""
        if not reason.startswith("preempted"):
            raise ValueError(
                "preempt reason must start with 'preempted'"
            )
        with self._lock:
            ids = list(self._doing.keys())
        for tid in ids:
            self.report(tid, False, err_reason=reason)
        return len(ids)

    # ---- status --------------------------------------------------------

    def finished(self) -> bool:
        with self._lock:
            if self._streaming and not self._stream_closed:
                # An open stream is never done — the completion sweep
                # (gang scheduler) and the servicer's finished RPC must
                # keep the job live even when the tail is momentarily
                # drained (todo and doing both empty).
                return False
            remaining = [
                t for t in self._todo
                if not (
                    t.type == TaskType.TRAINING
                    and self._train_cap_reached_locked()
                )
            ]
            return (
                not remaining
                and not self._doing
                and not self._epochs_pending_locked()
            )

    def count_tasks(self, task_type: str) -> int:
        """Tasks of ``task_type`` currently queued or leased (the
        eval plane's recovery sanity check)."""
        with self._lock:
            n = sum(1 for t in self._todo if t.type == task_type)
            n += sum(
                1 for t, _wid, _s in self._doing.values()
                if t.type == task_type
            )
            return n

    def queue_depths(self) -> Tuple[int, int]:
        """(todo, doing) sizes for queue-health consumers (the
        autoscaler's signals) — lock-free ``len`` reads, same pattern
        as the ``master_task_queue_depth`` gauges above."""
        return len(self._todo), len(self._doing)

    def doing_tasks_of(self, worker_id: int) -> List[int]:
        with self._lock:
            return [
                tid for tid, (_t, wid, _s) in self._doing.items()
                if wid == worker_id
            ]

    def doing_start_times(self) -> Dict[int, Tuple[int, float]]:
        """task_id -> (worker_id, start_time) for timeout detection."""
        with self._lock:
            return {
                tid: (wid, start)
                for tid, (_t, wid, start) in self._doing.items()
            }

    def record_worker_version(self, worker_id: int, version: int):
        with self._lock:
            self._worker_version[worker_id] = version

    # ---- journal (master/journal.py) -----------------------------------

    def attach_journal(self, journal):
        """Write dispatch/report/create_tasks through ``journal`` from
        now on; wires the snapshot provider to the locked exporter
        (appends run inside this dispatcher's critical sections)."""
        with self._lock:
            self._journal = journal
        journal.set_snapshot_provider(self._export_state_locked)

    def detach_journal(self):
        with self._lock:
            self._journal = None

    def export_state(self) -> dict:
        """Full serializable dispatcher state (journal snapshots and
        the chaos master-restart equivalence audit)."""
        with self._lock:
            return self._export_state_locked()

    def _export_state_locked(self) -> dict:
        version, internal, gauss = self._rng.getstate()
        return {
            "todo": [t.to_dict() for t in self._todo],
            "doing": [
                [int(tid), t.to_dict(), int(wid)]
                for tid, (t, wid, _s) in self._doing.items()
            ],
            "task_id": int(self._task_id),
            "epochs_todo": int(self._epochs_todo),
            "max_train_records": int(self._max_train_records),
            "train_records_dispatched": int(
                self._train_records_dispatched
            ),
            "retry": dict(self._task_retry_count),
            "completed": dict(self.counters.total_records),
            "failed": dict(self.counters.failed_records),
            "worker_version": {
                str(k): int(v) for k, v in self._worker_version.items()
            },
            "resolved": [
                [int(tid), t.to_dict() if t is not None else None,
                 int(wid), bool(rq)]
                for tid, (t, wid, rq) in self._resolved.items()
            ],
            # Epoch-regeneration shuffle must continue the same
            # sequence after recovery, or the replayed run diverges
            # from a never-crashed one under shuffle=True.
            "rng": [int(version), [int(x) for x in internal], gauss],
            "deferred_pending": len(self._deferred_callbacks),
            # Stream-plane state rides the dispatcher snapshot so
            # compaction keeps the committed watermarks (the resume
            # point) without a separate journal mirror lifecycle.
            "streaming": bool(self._streaming),
            "stream_closed": bool(self._stream_closed),
            "stream": self._stream,
        }

    def restore_state(self, state: dict):
        """Install a journal snapshot. Leased (doing) tasks stay
        leased — the workers holding them survive the master crash and
        re-report; their start clocks reset to now so the straggler
        deadline counts from recovery."""
        now = time.time()
        with self._lock:
            self._todo = [Task.from_dict(d) for d in state["todo"]]
            self._doing = {
                int(tid): (Task.from_dict(d), int(wid), now)
                for tid, d, wid in state["doing"]
            }
            self._task_id = int(state["task_id"])
            self._epochs_todo = int(state["epochs_todo"])
            self._max_train_records = int(state["max_train_records"])
            self._train_records_dispatched = int(
                state["train_records_dispatched"]
            )
            self._task_retry_count = dict(state["retry"])
            self.counters.total_records = dict(state["completed"])
            self.counters.failed_records = dict(state["failed"])
            self._worker_version = {
                int(k): int(v)
                for k, v in state.get("worker_version", {}).items()
            }
            self._resolved = collections.OrderedDict(
                (int(tid),
                 (Task.from_dict(d) if d is not None else None,
                  int(wid), bool(rq)))
                for tid, d, wid, rq in state.get("resolved", [])
            )
            rng = state.get("rng")
            if rng:
                self._rng.setstate((rng[0], tuple(rng[1]), rng[2]))
            self._streaming = bool(
                state.get("streaming", self._streaming)
            )
            self._stream_closed = bool(state.get("stream_closed", False))
            self._stream = normalize_stream_state(state.get("stream"))
            if state.get("deferred_pending", 0) == 0:
                # The pre-crash dispatcher had already fired its
                # deferred callbacks (train-end task created); firing
                # the re-registered ones again would duplicate it.
                self._deferred_callbacks = []
