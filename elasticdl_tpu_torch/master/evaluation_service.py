"""Master-side evaluation: triggers + metric accumulation.

A copy of elasticdl_tpu/master/evaluation_service.py, but for one
thing: numpy has no bfloat16, so a bf16 output arrives as its bits and
folds as the float32 it widens to (``_from_bf16_bits``).

Counterpart of the reference's ``master/evaluation_service.py``:
- step-based trigger: every ``eval_steps`` model versions (reported by the
  training plane via ``report_version``) a batch of EVALUATION tasks is
  queued (reference :171-186),
- time-based trigger: a thread queues eval jobs every ``throttle_secs``
  after ``start_delay_secs`` (reference ``_EvaluationTrigger`` :52-85),
- workers report *raw model outputs and labels*; metrics are computed on
  the master (reference evaluation_utils.py:50-97) in chunks.

Crash survival (master/journal.py): with a journal attached, round
state is event-sourced — ``eval_round`` open/task_done/close events
plus per-task ``eval_fold`` records carrying the raw outputs/labels
(ndarrays ride the journal's msgpack serde the same way they ride
checkpoints). A recovered (or hot-standby) master rebuilds the OPEN
round — accumulated outputs, completed count, folded task ids,
``_last_eval_version`` — via ``restore_recovered``, so a master death
mid-round costs nothing: the surviving eval tasks re-report against
the restored round and it closes with the same metrics a never-killed
master would have produced. Fold records cost one journal fsync per
eval task report — eval-task granularity, not step granularity.
"""

import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from elasticdl_tpu_torch.common.constants import TaskType
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("evaluation_service")

# Metric update chunk size (reference evaluation_utils.py:83-97 uses 500 to
# bound per-call memory).
_CHUNK = 500


def _from_bf16_bits(arr: np.ndarray) -> np.ndarray:
    """A bf16 array arrives as its bits (the codec's "bfloat16": numpy
    has no bfloat16) and is folded as the float32 it widens to
    exactly."""
    if arr.dtype.names != ("bfloat16",):
        return arr
    bits = arr.view(np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32)


class EvaluationMetrics:
    """Accumulates raw outputs/labels and computes metric fns lazily."""

    def __init__(self, metrics_fns: Dict[str, Callable]):
        self._metrics_fns = metrics_fns
        self._outputs = []
        self._labels = []

    def update(self, outputs, labels):
        outputs = _from_bf16_bits(np.asarray(outputs))
        labels = np.asarray(labels)
        for i in range(0, outputs.shape[0], _CHUNK):
            self._outputs.append(outputs[i:i + _CHUNK])
            self._labels.append(labels[i:i + _CHUNK])

    def result(self) -> Dict[str, float]:
        if not self._outputs:
            return {}
        outputs = np.concatenate(self._outputs, axis=0)
        labels = np.concatenate(self._labels, axis=0)
        return {
            name: float(fn(labels, outputs))
            for name, fn in self._metrics_fns.items()
        }


class EvaluationJob:
    """One evaluation round at one model version (reference :11-49)."""

    def __init__(self, metrics_fns: Dict[str, Callable], model_version: int,
                 total_tasks: int = -1):
        self.model_version = model_version
        self._total_tasks = total_tasks
        self._completed_tasks = 0
        self.evaluation_metrics = EvaluationMetrics(metrics_fns)
        # Task ids whose raw outputs already folded: the fold is a
        # plain accumulate, so an at-least-once re-send (RpcStub
        # retries DEADLINE_EXCEEDED; the worker's master-outage
        # ride-out retries harder) must not count the same samples
        # twice.
        self._folded_tasks = set()

    def complete_task(self):
        self._completed_tasks += 1

    def finished(self) -> bool:
        return (
            self._total_tasks >= 0
            and self._completed_tasks >= self._total_tasks
        )

    def report_evaluation_metrics(self, outputs, labels,
                                  task_id: int = -1) -> bool:
        """Fold one task's raw outputs; False iff this task id already
        folded (at-least-once re-send — callers must not journal or
        re-count it)."""
        if task_id >= 0:
            if task_id in self._folded_tasks:
                logger.info(
                    "eval task %d outputs already folded; ignoring "
                    "duplicate report", task_id,
                )
                return False
            self._folded_tasks.add(task_id)
        self.evaluation_metrics.update(outputs, labels)
        return True


class EvaluationService:
    def __init__(
        self,
        task_dispatcher,
        metrics_fns: Dict[str, Callable],
        eval_steps: int = 0,
        start_delay_secs: int = 0,
        throttle_secs: int = 0,
        eval_only: bool = False,
        summary_writer=None,
    ):
        self._task_d = task_dispatcher
        self._metrics_fns = metrics_fns or {}
        self._eval_steps = eval_steps
        self._start_delay_secs = start_delay_secs
        self._throttle_secs = throttle_secs
        self._eval_only = eval_only
        self._summary_writer = summary_writer
        self._lock = threading.Lock()
        self._eval_job: Optional[EvaluationJob] = None
        self._last_eval_version = -1
        # Watermark-based trigger (streaming ingestion,
        # docs/online_learning.md): rounds open every N committed
        # stream records instead of every N model versions — a stream
        # has no epochs, so epoch-end eval never fires there.
        self._eval_watermark_records = 0
        self._last_eval_watermark = 0
        self.completed_results: Dict[int, Dict[str, float]] = {}
        self._trigger_thread = None
        self._stop = threading.Event()
        # Write-ahead journal (master/journal.py): round open/fold/
        # task_done/close events write through so an open round
        # survives a master crash. Attached AFTER construction (and
        # after restore_recovered on a recovery path), mirroring
        # TaskDispatcher.attach_journal.
        self._journal = None
        if eval_only:
            # Evaluation-only jobs: the dispatcher queued the EVALUATION
            # tasks at construction; open the job that will collect their
            # results (reference evaluation_service.py init_eval_only path).
            self._eval_job = EvaluationJob(
                self._metrics_fns, model_version=-1,
                total_tasks=self._count_eval_tasks(),
            )

    # ---- journal (master/journal.py) -----------------------------------

    def attach_journal(self, journal):
        """Write round events through ``journal`` from now on. On a
        recovery path, call ``restore_recovered`` FIRST — the restore
        must not re-append the events it is replaying."""
        with self._lock:
            self._journal = journal

    def restore_recovered(self, state: Optional[dict]):
        """Install the journal's replayed eval carry (see
        ``journal.new_eval_state``): the open round — completed count,
        folded task ids, re-folded raw outputs — plus
        ``_last_eval_version`` and the completed-results history. The
        journal must not be attached yet."""
        if not state:
            return
        with self._lock:
            if self._journal is not None:
                raise RuntimeError(
                    "detach the journal before restore_recovered"
                )
            self._last_eval_version = int(
                state.get("last_eval_version", self._last_eval_version)
            )
            for version, metrics in (state.get("results") or {}).items():
                self.completed_results[int(version)] = dict(metrics)
            open_round = state.get("open")
            if open_round is None:
                return
            job = self._eval_job
            if job is None:
                # total_tasks -1 only happens for eval-only rounds,
                # whose job is rebuilt at construction (the branch
                # below); a journaled open round always recorded it.
                job = EvaluationJob(
                    self._metrics_fns,
                    model_version=int(open_round.get("model_version",
                                                     -1)),
                    total_tasks=int(open_round.get("total_tasks", -1)),
                )
                self._eval_job = job
            # Eval-only jobs keep the constructed job (same config by
            # construction) and replay progress onto it.
            job._completed_tasks = max(
                job._completed_tasks,
                int(open_round.get("completed", 0)),
            )
            for task_id, outputs, labels in open_round.get("folds", []):
                job.report_evaluation_metrics(
                    outputs, labels, task_id=int(task_id)
                )
            if job.finished():
                # Crash window between the final task's REPORT record
                # and the round's close record: replay counted the
                # round complete, so close it HERE — no completion
                # will ever arrive again (the reports all resolved).
                results = job.evaluation_metrics.result()
                self.completed_results[job.model_version] = results
                self._eval_job = None
                logger.info(
                    "closed recovered eval round @version %d: %s",
                    job.model_version, results,
                )
                if self._summary_writer is not None:
                    self._summary_writer.write_eval_metrics(
                        job.model_version, results
                    )
                return
            remaining = self._task_d.count_tasks(TaskType.EVALUATION)
            if job._completed_tasks + remaining < job._total_tasks:
                # Crash window between the round's open record and its
                # create_tasks record: the journal opened a round whose
                # tasks never existed — unfinishable. Drop it (the
                # round is lost, not wedged; the next version report
                # re-triggers) rather than block evaluation forever.
                logger.warning(
                    "dropping recovered eval round @version %d: only "
                    "%d task(s) outstanding + %d complete of %d (the "
                    "crash preceded its task creation)",
                    job.model_version, remaining,
                    job._completed_tasks, job._total_tasks,
                )
                self._eval_job = None
                return
        logger.info(
            "restored open eval round @version %d: %d/%s task(s) "
            "complete, %d fold(s) re-applied",
            job.model_version, job._completed_tasks,
            job._total_tasks, len(open_round.get("folds", [])),
        )

    # ---- triggers ------------------------------------------------------

    def start_time_trigger(self):
        """Time-based eval trigger thread (reference _EvaluationTrigger)."""
        if self._throttle_secs <= 0:
            return

        def _loop():
            time.sleep(self._start_delay_secs)
            while not self._stop.is_set():
                self.try_to_create_new_job(model_version=-1)
                if self._stop.wait(self._throttle_secs):
                    return

        self._trigger_thread = threading.Thread(target=_loop, daemon=True)
        self._trigger_thread.start()

    def stop(self):
        self._stop.set()

    def add_evaluation_task_if_needed(self, model_version: int):
        """Step-based trigger, called on report_version
        (reference evaluation_service.py:171-186)."""
        if self._eval_steps <= 0:
            return False
        # Elapsed-steps check rather than exact modulo: workers may report
        # versions at a coarser granularity than every step.
        if model_version - max(self._last_eval_version, 0) >= self._eval_steps:
            return self.try_to_create_new_job(model_version)
        return False

    def configure_watermark_eval(self, every_records: int,
                                 start_at: int = 0):
        """Arm the watermark trigger: one eval round per
        ``every_records`` committed stream records. ``start_at`` seeds
        the marker (the ingestor passes the recovered committed total
        so a master restart does not fire a spurious burst)."""
        with self._lock:
            self._eval_watermark_records = int(every_records)
            self._last_eval_watermark = max(
                self._last_eval_watermark, int(start_at)
            )

    def add_watermark_eval_if_needed(self, committed_records: int,
                                     model_version: int = -1) -> bool:
        """Watermark trigger, called by the stream ingestor's pump as
        committed watermarks advance (the streaming replacement for
        epoch-end / step-based triggering). The marker only advances
        when a round actually opens, so progress made while a previous
        round is still running re-triggers as soon as it closes."""
        if self._eval_watermark_records <= 0:
            return False
        if (committed_records - self._last_eval_watermark
                < self._eval_watermark_records):
            return False
        if self.try_to_create_new_job(model_version):
            with self._lock:
                self._last_eval_watermark = int(committed_records)
            return True
        return False

    def try_to_create_new_job(self, model_version: int) -> bool:
        with self._lock:
            if self._eval_job is not None and not self._eval_job.finished():
                return False  # previous round still running
            num_tasks = self._count_eval_tasks()
            if num_tasks == 0:
                return False
            self._eval_job = EvaluationJob(
                self._metrics_fns, model_version, total_tasks=num_tasks
            )
            self._last_eval_version = model_version
            if self._journal is not None:
                # Inside the lock and BEFORE create_tasks below, so
                # the journal's order (open, then create_tasks)
                # matches the state-mutation order replay re-runs.
                self._journal.append(
                    "eval_round", event="open",
                    model_version=int(model_version),
                    total_tasks=int(num_tasks),
                    last_eval_version=int(model_version),
                )
        self._task_d.create_tasks(TaskType.EVALUATION, model_version)
        return True

    def _count_eval_tasks(self) -> int:
        shards = self._task_d._shards_for(TaskType.EVALUATION)
        per_task = self._task_d._records_per_task
        count = 0
        for _name, (_start, n) in shards.items():
            count += (n + per_task - 1) // per_task
        return count

    # ---- worker reports ------------------------------------------------

    def report_evaluation_metrics(self, outputs, labels,
                                  task_id: int = -1) -> bool:
        with self._lock:
            if self._eval_job is None:
                return False
            folded = self._eval_job.report_evaluation_metrics(
                outputs, labels, task_id=task_id
            )
            if folded and self._journal is not None:
                # First applications only: a duplicate fold was
                # ignored above and must not re-fold on replay either.
                self._journal.append(
                    "eval_fold", task_id=int(task_id),
                    outputs=np.asarray(outputs),
                    labels=np.asarray(labels),
                )
            return True

    def complete_task(
        self, model_version: int = -1
    ) -> Optional[Dict[str, float]]:
        """Count one finished eval task toward the current round.
        ``model_version`` is the completed TASK's version: a completion
        from a different round — e.g. a version-V task still draining
        after a master restart opened a fresh round at V' — must not
        count toward this one, or the round closes early on partial
        data. -1 counts unconditionally (eval-only jobs and callers
        predating versioned tasks)."""
        with self._lock:
            if self._eval_job is None:
                return None
            if (model_version >= 0
                    and self._eval_job.model_version >= 0
                    and model_version != self._eval_job.model_version):
                logger.warning(
                    "eval task @version %d completed but the current "
                    "round is @version %d; not counting it",
                    model_version, self._eval_job.model_version,
                )
                return None
            # No journal append for the count itself: round progress
            # rides the dispatcher's REPORT record (task_type/
            # model_version/requeued fields), so the resolution and
            # the completion are ONE fsynced record — a crash cannot
            # separate them and wedge the round.
            self._eval_job.complete_task()
            if not self._eval_job.finished():
                return None
            results = self._eval_job.evaluation_metrics.result()
            version = self._eval_job.model_version
            self.completed_results[version] = results
            self._eval_job = None
            if self._journal is not None:
                # Close supersedes the round's folds/task_done records
                # — a recovered master keeps the results, not the
                # round (journal-side state folds it the same way).
                self._journal.append(
                    "eval_round", event="close",
                    model_version=int(version),
                    results={str(k): float(v)
                             for k, v in results.items()},
                )
        logger.info("Eval @version %d: %s", version, results)
        if self._summary_writer is not None:
            self._summary_writer.write_eval_metrics(version, results)
        return results
