"""Task → batch stream with completion bookkeeping.

A copy of elasticdl_tpu/worker/task_data_service.py, over the port's
``data/batcher.py`` and ``data/prefetch.py``.

Counterpart of the reference's ``worker/task_data_service.py``: turns the
master's task stream into model-ready batches and reports each task's
result exactly when its records have been consumed.

Design difference from the reference (which streams records across task
boundaries through a tf.data generator): here batching is *per task* —
``records_per_task`` is normally ``minibatch_size × num_minibatches_per_task``
so a task is a whole number of batches, and task completion is atomic with
its batches. The cost is at most one padded partial batch per task; the
gain is that a preempted worker never half-consumes a task (simpler
elastic re-queue semantics, no pending-task bookkeeping).
"""

import contextlib
import sys
import time
from typing import Iterator, Optional, Tuple

from elasticdl_tpu_torch.common.constants import Mode, TaskType
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.data.batcher import batch_records
from elasticdl_tpu_torch.data.prefetch import prefetch

logger = get_logger("task_data_service")

_TASK_TYPE_TO_MODE = {
    TaskType.TRAINING: Mode.TRAINING,
    TaskType.EVALUATION: Mode.EVALUATION,
    TaskType.PREDICTION: Mode.PREDICTION,
}


class TaskDataService:
    def __init__(self, master_client, data_reader, dataset_fn,
                 minibatch_size: int, wait_sleep_secs: float = 2.0,
                 prefetch_depth: int = 2, on_wait=None, metrics_fn=None,
                 on_metrics_delivered=None, tracer=None,
                 master_reattach_grace: float = 60.0):
        from elasticdl_tpu_torch.observability import tracing

        self._master = master_client
        # Root-span factory for the task timeline (the worker passes
        # its own so spans land on the right worker track).
        self._tracer = tracer or tracing.Tracer("worker")
        # Called after a get_task that CARRIED a snapshot succeeds —
        # the worker commits its span-ring cursor there, so spans
        # offered on a failed RPC are re-offered instead of lost.
        self._on_metrics_delivered = on_metrics_delivered
        # Zero-arg callable returning a (rate-limited) registry snapshot
        # to piggyback on get_task, or None. Without it an idle worker —
        # polling WAIT tasks between epochs — makes no reporting RPC and
        # would age out of the master's cluster metrics view while
        # perfectly alive.
        self._metrics_fn = metrics_fn
        self._reader = data_reader
        self._dataset_fn = dataset_fn
        self._minibatch_size = minibatch_size
        self._wait_sleep_secs = wait_sleep_secs
        # Background decode of batch N+1 while the device runs step N
        # (reference tf.data .prefetch(1), worker.py:1022-1027); 0 = off.
        self._prefetch_depth = prefetch_depth
        # Called (with the configured wait interval) instead of sleeping
        # while WAITing for tasks; multi-host workers use it to keep
        # participating in barrier ticks (a sleeping process would
        # strand its peers in a collective).
        self._on_wait = on_wait
        # How long to ride out master unavailability before giving up
        # (--master_reattach_grace): long enough to cover a master
        # reschedule + journal replay, finite so a torn-down job lets
        # workers exit. With a journaled master (master/journal.py)
        # the recovered incarnation keeps our leases, so surviving the
        # window means re-attaching with no work lost.
        self._reattach_grace = max(float(master_reattach_grace), 0.1)

    def _wait(self, secs: float = None):
        secs = self._wait_sleep_secs if secs is None else secs
        if self._on_wait is not None:
            self._on_wait(secs)
        else:
            time.sleep(secs)

    def task_stream(self) -> Iterator[Tuple[object, Optional[Iterator]]]:
        """Yield ``(task, batch_iter)`` pairs until the job is finished.

        ``batch_iter`` is None for control tasks (WAIT handled internally,
        TRAIN_END_CALLBACK yielded for the worker to run callbacks). The
        caller must consume ``batch_iter`` fully, then report the task.
        """
        from elasticdl_tpu_torch.comm.rpc import RpcError, decorrelated_jitter

        rpc_failures = 0
        retry_delay = 0.0
        outage_deadline = None
        last_generation = getattr(self._master, "last_generation", None)
        while True:
            # One root span per task cycle — opened BEFORE get_task so
            # the master's dispatch spans join the task's tree; cycles
            # that turn out to be WAIT polls or failures are discarded
            # (recording them would drown the latency stats). The span
            # stays open across the yield: the worker consumes the
            # batches on this same thread, so its step-phase spans nest
            # under the task.
            span = self._tracer.span("task")
            span.__enter__()
            try:
                try:
                    metrics = (
                        self._metrics_fn() if self._metrics_fn else None
                    )
                    task, finished = self._master.get_task(
                        metrics=metrics
                    )
                    if metrics and self._on_metrics_delivered:
                        self._on_metrics_delivered()
                except RpcError as exc:
                    span.discard()
                    now = time.monotonic()
                    if outage_deadline is None:
                        # Time-based grace (not attempt-counted): the
                        # jittered backoff below makes attempt counts
                        # an unreliable clock.
                        outage_deadline = now + self._reattach_grace
                    rpc_failures += 1
                    logger.warning(
                        "get_task RPC failed (%d, %.0fs of grace "
                        "left): %s",
                        rpc_failures, max(0.0, outage_deadline - now),
                        exc,
                    )
                    if now >= outage_deadline:
                        logger.warning(
                            "master unreachable for the full reattach "
                            "grace (%.0fs); treating job as finished",
                            self._reattach_grace,
                        )
                        return
                    # Decorrelated-jitter backoff (comm/rpc.py): a
                    # master failover fails the WHOLE fleet at the
                    # same instant, and a fixed retry interval would
                    # hammer the promoted standby in lockstep forever
                    # (thundering herd). _wait (not sleep): multi-host
                    # workers must keep ticking the barrier during the
                    # backoff or they strand peers mid-collective.
                    retry_delay = decorrelated_jitter(
                        retry_delay,
                        base=min(0.2, self._wait_sleep_secs),
                        cap=2.0 * self._wait_sleep_secs,
                    )
                    # Retry budget (comm/overload.py): the poll loop
                    # must SURVIVE the full reattach grace — a denied
                    # spend stretches this round's wait (rate-capping
                    # the fleet-wide storm on the promoted standby)
                    # instead of abandoning the ride-out.
                    from elasticdl_tpu_torch.comm import overload

                    if overload.controls_enabled():
                        budget = overload.retry_budget_for(
                            "Master:rideout"
                        )
                        if not budget.try_spend():
                            retry_delay = max(retry_delay, 1.0)
                    self._wait(retry_delay)
                    # Fresh channel per retry (MasterClient.reconnect):
                    # a channel whose reconnects were refused for a few
                    # seconds can wedge permanently; re-attaching to a
                    # RELAUNCHED (or failed-over: the rebuild rotates
                    # the re-resolve address list) master needs a
                    # rebuild.
                    reconnect = getattr(self._master, "reconnect", None)
                    if reconnect is not None:
                        reconnect()
                    continue
                generation = getattr(
                    self._master, "last_generation", None
                )
                if (generation is not None
                        and last_generation is not None
                        and generation > last_generation
                        and last_generation >= 0):
                    # The master restarted while we held our state:
                    # the journaled incarnation kept our leases, so
                    # this is a re-attach, not a fresh job.
                    logger.warning(
                        "re-attached to restarted master (generation "
                        "%d -> %d) after %d failed poll(s)",
                        last_generation, generation, rpc_failures,
                    )
                last_generation = generation
                if rpc_failures:
                    # A recovered poll refunds a sliver of retry
                    # budget — sustained health restores the fleet's
                    # headroom for the next outage.
                    from elasticdl_tpu_torch.comm import overload

                    if overload.controls_enabled():
                        overload.retry_budget_for(
                            "Master:rideout"
                        ).on_success()
                rpc_failures = 0
                retry_delay = 0.0
                outage_deadline = None
                if task is None:
                    if finished:
                        span.discard()
                        return
                    span.discard()
                    self._wait()
                    continue
                if task.type == TaskType.WAIT:
                    span.discard()
                    self._wait()
                    continue
                span.set(task_id=int(task.task_id), type=str(task.type))
                if task.type == TaskType.TRAIN_END_CALLBACK:
                    yield task, None
                    continue
                mode = _TASK_TYPE_TO_MODE.get(task.type)
                if mode is None:
                    logger.warning(
                        "Unknown task type %s; skipping", task.type
                    )
                    self._master.report_task_result(
                        task.task_id,
                        err_reason=f"unknown type {task.type}",
                    )
                    continue
                batches = batch_records(
                    self._reader.read_records(task),
                    self._minibatch_size,
                    self._dataset_fn,
                    mode,
                    self._reader.metadata,
                )
                ctx = (
                    prefetch(batches, self._prefetch_depth)
                    if self._prefetch_depth > 0
                    else contextlib.nullcontext(batches)
                )
                with ctx as batches:
                    yield task, batches
            finally:
                # Real exc_info (not Nones): an exception escaping the
                # loop body must tag the task span with its error attr,
                # or a crashed task reads as a fast successful one in
                # /traces and skews the critical-path stats.
                span.__exit__(*sys.exc_info())
