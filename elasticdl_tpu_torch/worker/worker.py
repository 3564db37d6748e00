"""Worker: the training engine (port of elasticdl_tpu/worker/worker.py).

The worker pulls tasks from the master and runs each task's minibatches
through the port's steps and runners on its device (CUDA unless the
caller built the model on the CPU). What it keeps of the reference's
protocol:

- task pull loop against the master (get_task / report_task_result),
- version reporting (report_version) driving master-side eval triggers,
- eval tasks: forward pass + raw outputs/labels to the master,
- predict tasks: forward pass + user outputs processor,
- TRAIN_END_CALLBACK: run user callbacks,
- SSP ``get_model_steps`` as ``version_report_steps``: the master only
  observes (and eval-triggers on) every N-th version.

Where the JAX worker differs by its platform:

- A failed minibatch is not retried (the JAX worker retries a
  ``JaxRuntimeError``). A CUDA fault (an illegal address, a failed
  launch) leaves the context unusable, so a retry would only repeat it
  or hide a kernel fault; and the sparse step updates its rows in place,
  so re-running a step that failed after its row update would apply
  those rows twice. A failed step fails its task, which the master
  re-queues.
- Nothing reads back from the card per step: ``state.step`` is a Python
  int, an eval task's outputs stay on the card until the task ends and
  are copied once, and the final loss is read once, at the end.
- A resize directive (the master's barrier) is applied at a task
  boundary through the runner's ``resize`` (``parallel/reshard``): a
  mesh-aware model is rebuilt for the new mesh and takes the trained
  parameters (torch modules hold their parameters, where the JAX worker
  only re-binds ``apply_fn``). The profiler (item 8) is not ported.

Multi-host sync: when the runner's mesh spans worker processes
(``parallel/multihost.py``), every process must run the same steps the
same number of times (their collectives span the processes), while
each pulls its own tasks. Per tick every process announces a step code
(train, forward, idle, done) over the CPU group; the max wins and a
process with nothing of that kind feeds a zero-mask dummy through the
winning step (``_await_turn``). An idle worker keeps ticking while it
waits for tasks, and at the end every process drains the barrier until
all are done (``_drain_multihost``). Under sync, task fusion and the
host tier's pull-ahead are off, a resize directive is acked as a
no-op (multi-host jobs resize by a gang restart from a checkpoint,
ROADMAP item 8), and a failed step is fatal: a process that left the
tick would hang its peers inside a collective.
"""

import itertools
import sys
import time
import traceback
from typing import Optional

import numpy as np
import torch

from elasticdl_tpu_torch.common import dtypes
from elasticdl_tpu_torch.common.constants import TaskType
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.timing import Timing
from elasticdl_tpu_torch.core.step import (
    build_eval_step,
    build_multi_step,
    build_train_step,
    stack_batches,
)
from elasticdl_tpu_torch.core.train_state import init_train_state
from elasticdl_tpu_torch.worker.task_data_service import TaskDataService

logger = get_logger("worker")


class WorkerStopped(Exception):
    """Raised internally when a graceful stop (SIGTERM) was requested."""


def _host_outputs(preds: torch.Tensor) -> np.ndarray:
    """A task's outputs on the host in their own dtype: a bf16 tensor as
    its bits (``dtypes.BFLOAT16_BITS``, which the codec writes as
    "bfloat16", as the JAX worker's bf16 outputs travel)."""
    preds = preds.detach().cpu()
    if preds.dtype == torch.bfloat16:
        return dtypes.bf16_to_numpy(preds)
    return preds.numpy()


def _nbytes(tree) -> int:
    """Bytes of the arrays in a batch's nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return getattr(tree, "nbytes", 0)


class Worker:
    def __init__(
        self,
        worker_id: int,
        master_client,
        model_spec,
        data_reader,
        minibatch_size: int,
        step_runner=None,
        version_report_steps: int = 1,
        prediction_outputs_processor=None,
        callbacks=None,
        timing: Optional[Timing] = None,
        checkpoint_hook=None,
        checkpoint_dir_for_init: str = "",
        checkpoint_init_required: bool = True,
        fuse_task_steps: bool = False,
        prefetch_depth: int = 2,
        host_prefetch_depth: int = 2,
        metrics_report_secs: float = 15.0,
        master_reattach_grace: float = 60.0,
        random_seed: int = 0,
    ):
        self._id = worker_id
        self._master = master_client
        self._spec = model_spec
        self._reader = data_reader
        self._minibatch_size = minibatch_size
        self._version_report_steps = version_report_steps
        self._processor = prediction_outputs_processor
        self._callbacks = callbacks or []
        self._timing = timing or Timing(False)
        # step_runner: the zoo module's sparse or host runner, or a
        # MeshRunner; None = the plain steps on the model's device.
        self._step_runner = step_runner
        # The state's seed (its generator, a sparse model's tables), as
        # the Local executor's --random_seed.
        self._seed = int(random_seed)
        self.state = None
        self.last_batch = None
        self._train_step = None
        self._eval_step = build_eval_step()
        # Tracing (observability/tracing.py): step-phase spans into the
        # process flight recorder when one is installed; free otherwise
        # (Tracer.span is one module-global read). Recorded spans ride
        # the same piggybacked snapshots as metrics, incrementally via
        # the ring cursor.
        from elasticdl_tpu_torch.observability import tracing

        self._tracer = tracing.Tracer("worker", str(worker_id))
        # Ring cursor of the last spans CONFIRMED delivered to the
        # master, plus the cursor offered on the in-flight snapshot —
        # committed only when the carrying RPC succeeds, so a failed
        # report re-offers its spans on the next one (the collector
        # dedups by span id, so an ambiguous failure resends harmlessly).
        self._trace_cursor = 0
        self._trace_cursor_offered = 0
        self._task_data = TaskDataService(
            master_client, data_reader, model_spec.dataset_fn,
            minibatch_size, prefetch_depth=prefetch_depth,
            on_wait=self._wait_tick,
            # Keep an idle worker alive in the master's cluster metrics
            # view: snapshots ride get_task too, not just the report
            # RPCs (rate-limited inside _metrics_snapshot).
            metrics_fn=self._metrics_snapshot,
            on_metrics_delivered=self._metrics_delivered,
            tracer=self._tracer,
            master_reattach_grace=master_reattach_grace,
        )
        self.last_metrics = None
        # Periodic checkpoint: the job passes a hook only to one worker
        # (worker 0); None = no checkpoints.
        from elasticdl_tpu_torch.checkpoint import CheckpointHook

        self._checkpoint = checkpoint_hook or CheckpointHook()
        self._checkpoint_dir_for_init = checkpoint_dir_for_init
        # Fused task execution: all of a task's minibatches in one call
        # (core/step.build_multi_step, the runner's train_multi_step).
        # Version reporting/checkpointing then happen at task
        # granularity.
        self._fuse_task_steps = fuse_task_steps
        self._multi_step = None
        # Host-tier row pull-ahead depth (--host_prefetch_depth): how
        # far iter_prepared runs ahead of the device step. Validated
        # >= 1 (0 would disable the pull-ahead the runner's pull_ahead
        # property promised).
        self._host_prefetch_depth = max(1, int(host_prefetch_depth))
        # Multi-host step-alignment barrier (see the module docstring);
        # set at init from the runner's mesh.
        self._multihost_sync = False
        # Graceful preemption (k8s SIGTERM before the KILL): a stop
        # request checkpoints the freshest state and hands the current
        # task back before the pod dies (worker/main.py installs the
        # signal handler).
        self._stop_requested = False
        self._checkpoint_init_required = checkpoint_init_required
        # Telemetry (observability/): the step loop feeds the process
        # registry; snapshots piggyback on report_task_result /
        # report_version every metrics_report_secs (0 = every report,
        # for tests) so the master's cluster view stays fresh without a
        # dedicated RPC.
        from elasticdl_tpu_torch.observability import default_registry

        # Reporting RPCs ride out master unavailability for the same
        # grace window the task stream uses (_master_call below).
        self._master_reattach_grace = max(
            float(master_reattach_grace), 0.1
        )
        self._metrics = default_registry()
        self._metrics_report_secs = float(metrics_report_secs)
        self._last_metrics_report = 0.0
        self._m_step = self._metrics.histogram(
            "worker_step_seconds",
            "Device step latency (host-observed)", ["kind"],
        )
        # Saturation signal for an autoscaler: step seconds / wall
        # seconds over each report window. The step is timed on the host
        # and not synchronised, so on the card it reads issue time.
        self._m_step_util = self._metrics.gauge(
            "worker_step_utilization",
            "Device-step seconds / wall seconds over the report window",
        )
        self._util_step_secs = 0.0
        self._util_window_t0 = time.monotonic()
        # Live-resize barrier: the master piggybacks a directive on
        # get_task; it is handled at a TASK boundary and acked via
        # report_resize. Idempotent by id.
        self._applied_resize_id = -1
        self._in_task = False
        self._resizing = False
        self._m_resize = self._metrics.histogram(
            "worker_resize_seconds",
            "Live reshard latency: gather + re-place + step rebuild",
        )
        self._m_examples = self._metrics.counter(
            "worker_examples_total",
            "Examples processed", ["task_type"],
        )
        self._m_h2d_bytes = self._metrics.counter(
            "worker_h2d_bytes_total",
            "Host batch bytes shipped to the device step",
        )
        self._m_compiles = self._metrics.counter(
            "worker_compiles_total",
            "Step-program builds (each first call triggers XLA compile)",
        )
        self._m_tasks = self._metrics.counter(
            "worker_tasks_total",
            "Tasks processed", ["type", "result"],
        )
        # Phase accumulators feed the registry too.
        self._timing.publish(self._metrics)

    # ---- state init ----------------------------------------------------

    def _maybe_init(self, batch):
        if self.state is not None:
            return
        self._m_compiles.inc()
        from elasticdl_tpu_torch.callbacks import apply_callbacks_to_optimizer

        make_optimizer = apply_callbacks_to_optimizer(
            self._spec.make_optimizer(), self._callbacks
        )
        if self._step_runner is not None:
            mesh = getattr(self._step_runner, "mesh", None)
            self._multihost_sync = bool(getattr(mesh, "spans_processes",
                                                False))
            if self._multihost_sync and self._fuse_task_steps:
                logger.warning(
                    "fuse_task_steps disabled under multi-host sync "
                    "(unequal task sizes would desync step counts)"
                )
                self._fuse_task_steps = False
            self.state = self._step_runner.init_state(
                self._spec.model, make_optimizer, batch, seed=self._seed
            )
            self._train_step = self._step_runner.train_step(self._spec.loss)
            self._eval_step = self._step_runner.eval_step()
            if self._fuse_task_steps and getattr(
                self._step_runner, "accum_steps", 1
            ) == 1:
                if hasattr(self._step_runner, "train_multi_step"):
                    self._multi_step = self._step_runner.train_multi_step(
                        self._spec.loss
                    )
                else:
                    # e.g. HostStepRunner: host-side work per batch can't
                    # fuse into one call; fall back to per-step.
                    logger.warning(
                        "fuse_task_steps ignored: %s has no "
                        "train_multi_step",
                        type(self._step_runner).__name__,
                    )
        else:
            self.state = init_train_state(
                self._spec.model, make_optimizer, seed=self._seed
            )
            self._train_step = build_train_step(self._spec.loss)
            if self._fuse_task_steps:
                self._multi_step = build_multi_step(self._spec.loss)
        if self._checkpoint_dir_for_init:
            from elasticdl_tpu_torch.checkpoint import restore_from_dir

            # In place: the restored leaves are copied into the live
            # tensors (a placed leaf split into its shards).
            self.state = restore_from_dir(
                self.state, self._checkpoint_dir_for_init,
                required=self._checkpoint_init_required,
                host_tables=getattr(
                    self._step_runner, "host_tables", None
                ),
            )
            # The runner re-places what a restore may land whole (as
            # the JAX worker re-places its host arrays).
            if hasattr(self._step_runner, "place_state"):
                self.state = self._step_runner.place_state(self.state)
            # The restored version is the save baseline — without this,
            # interval-crossing counts pre-restore steps and writes a
            # spurious checkpoint on the first post-restore step.
            self._checkpoint.note_version(int(self.state.step))

    # ---- telemetry ------------------------------------------------------

    def _observe_step(self, kind: str, seconds: float):
        """Step-latency histogram + the utilization accumulator the
        report-window gauge derives from."""
        self._m_step.labels(kind).observe(seconds)
        self._util_step_secs += seconds

    def _metrics_snapshot(self) -> Optional[dict]:
        """Registry snapshot for piggybacking, rate-limited to one per
        metrics_report_secs; None between reports. When a flight
        recorder is installed, the spans recorded since the last
        CONFIRMED delivery ride along under a ``spans`` key (the
        master's MetricsPlane pops them into its TraceCollector); the
        cursor commits in _metrics_delivered, so spans offered on an
        RPC that failed are re-offered on the next report instead of
        being lost with the outage they describe."""
        from elasticdl_tpu_torch.observability import tracing

        now = time.monotonic()
        if now - self._last_metrics_report < self._metrics_report_secs:
            return None
        self._last_metrics_report = now
        # Step utilization over the window just closing. Sub-50ms
        # windows (back-to-back RPCs) don't close: a degenerate window
        # would zero the gauge; keep accumulating.
        window = now - self._util_window_t0
        if window >= 0.05:
            self._m_step_util.set(
                min(1.0, self._util_step_secs / window)
            )
            self._util_step_secs = 0.0
            self._util_window_t0 = now
        snapshot = self._metrics.snapshot()
        spans, self._trace_cursor_offered = tracing.spans_since(
            self._trace_cursor
        )
        if spans:
            snapshot["spans"] = spans
        return snapshot

    def _metrics_delivered(self):
        """The RPC carrying the last snapshot succeeded — its spans
        reached the master; advance the cursor past them."""
        self._trace_cursor = self._trace_cursor_offered

    def _master_call(self, fn, description: str):
        """Run a master RPC, riding out transient unavailability up to
        the reattach grace — the reporting-side mirror of the task
        stream's get_task ride-out (task_data_service.py). The stub's
        bounded retry absorbs blips; this absorbs a master restart. A
        non-retryable code or an exhausted grace re-raises (the task
        loop's error handling takes over)."""
        from elasticdl_tpu_torch.comm.rpc import (
            RETRYABLE_CODES,
            RpcError,
            decorrelated_jitter,
        )

        deadline = time.monotonic() + self._master_reattach_grace
        retry_delay = 0.0
        while True:
            try:
                return fn()
            except RpcError as exc:
                if (exc.code not in RETRYABLE_CODES
                        or time.monotonic() >= deadline):
                    raise
                logger.warning(
                    "%s failed (%s); retrying while the master "
                    "recovers", description, exc,
                )
                # Decorrelated jitter (comm/rpc.py): a failover fails
                # every worker's report at once; fixed intervals would
                # stampede the new master in lockstep.
                retry_delay = decorrelated_jitter(
                    retry_delay, base=0.2, cap=2.0
                )
                # Retry budget (comm/overload.py): the ride-out must
                # SURVIVE the grace window, so a denied spend
                # stretches the wait instead of abandoning.
                from elasticdl_tpu_torch.comm import overload

                if overload.controls_enabled():
                    if not overload.retry_budget_for(
                        "Master:rideout"
                    ).try_spend():
                        retry_delay = max(retry_delay, 1.0)
                # (If a stop was requested, WorkerStopped propagates and
                # _run's handler exits the task loop — a stopping worker
                # gives up reporting through an outage.)
                self._wait_tick(retry_delay)
                # Fresh channel per retry: a channel refused for a few
                # seconds can wedge; reconnecting is what actually
                # re-attaches to the relaunched master.
                reconnect = getattr(self._master, "reconnect", None)
                if reconnect is not None:
                    reconnect()

    def _report_task(self, task_id: int, err_reason: str = ""):
        """report_task_result with the metrics/span piggyback and the
        span-cursor delivery commit."""
        snap = self._metrics_snapshot()
        accepted = self._master_call(
            lambda: self._master.report_task_result(
                task_id, err_reason=err_reason, metrics=snap
            ),
            f"report_task_result({task_id})",
        )
        if snap is not None:
            self._metrics_delivered()
        return accepted

    def _report_version(self, version: int):
        with self._timing.record("report_version"):
            snap = self._metrics_snapshot()
            self._master_call(
                lambda: self._master.report_version(version, metrics=snap),
                f"report_version({version})",
            )
            if snap is not None:
                self._metrics_delivered()

    def _traced_batches(self, batches):
        """Yield from ``batches`` with each blocking ``next()`` under a
        ``fetch`` span — the input-wait phase of the step timeline
        (decode / prefetch / row pull-ahead latency the device sits
        idle for)."""
        it = iter(batches)
        sentinel = object()
        while True:
            with self._tracer.span("fetch"):
                batch = next(it, sentinel)
            if batch is sentinel:
                return
            yield batch

    def _batch_examples(self, batch) -> int:
        mask = batch.get("mask") if isinstance(batch, dict) else None
        if mask is not None:
            return int(np.sum(np.asarray(mask) > 0))
        return self._minibatch_size

    # ---- live resize ----------------------------------------------------

    def _maybe_apply_resize(self):
        """Handle a pending resize directive, if any. Called only at
        safe points — between tasks and while WAITing."""
        directive = getattr(self._master, "pending_resize", None)
        ack = getattr(self._master, "report_resize", None)
        if not directive or ack is None or self._resizing:
            return
        # Reentrancy guard: the ack rides _master_call, whose ride-out
        # ticks _wait_tick — which checks for pending resizes.
        self._resizing = True
        try:
            self._apply_resize(directive, ack)
        finally:
            self._resizing = False

    def _apply_resize(self, directive, ack):
        resize_id = int(directive.get("resize_id", -1))

        def send_ack(status):
            self._master_call(
                lambda: ack(resize_id, status),
                f"report_resize({resize_id})",
            )

        if resize_id == self._applied_resize_id:
            # Re-offered (a recovered master's acks are volatile): the
            # local apply already happened; re-join the barrier.
            send_ack("applied")
            return
        runner = self._step_runner
        if (runner is None or not hasattr(runner, "resize")
                or self._multihost_sync):
            # Nothing mesh-resident to reshard: the plain steps and the
            # host-tier runner keep their state on one device; a
            # multi-host job resizes by a gang restart. Join the barrier
            # as a no-op so it cannot hang on us.
            self._applied_resize_id = resize_id
            send_ack("noop")
            return
        from elasticdl_tpu_torch.parallel import reshard as reshard_lib

        t0 = time.monotonic()
        try:
            with self._tracer.span("resize", resize_id=resize_id):
                # The new mesh's entries all name this worker's device.
                mesh = getattr(runner, "mesh", None)
                device = (mesh.device if mesh is not None
                          else self.state.device if self.state is not None
                          else self._spec.device)
                new_mesh = reshard_lib.mesh_from_spec(directive["spec"],
                                                      device=device)
                # A mesh-aware model is built for its mesh: rebuild it
                # (from the run's seed, as worker/main.py builds it); the
                # runner moves the trained values into it.
                new_model, kwargs = None, {}
                if self._spec.mesh_aware:
                    with torch.random.fork_rng(devices=[]):
                        torch.manual_seed(self._seed)
                        new_model = self._spec.make_model(new_mesh)
                    if self.state is not None:
                        kwargs["model"] = new_model
                state = runner.resize(new_mesh, self.state, **kwargs)
                if new_model is not None:
                    self._spec.model = new_model
                if state is not None:
                    self.state = state
                    self._m_compiles.inc()
                    self._train_step = runner.train_step(self._spec.loss)
                    self._eval_step = runner.eval_step()
                    if self._multi_step is not None and hasattr(
                        runner, "train_multi_step"
                    ):
                        self._multi_step = runner.train_multi_step(
                            self._spec.loss
                        )
        except Exception as exc:
            # A failed apply must not wedge the fleet's barrier: ack
            # "failed" and keep training on the old mesh. The id is
            # deliberately NOT recorded, so a re-offered directive is
            # tried again instead of short-circuiting with "applied".
            logger.error(
                "resize %d failed; staying on the current mesh: %s\n%s",
                resize_id, exc, traceback.format_exc(),
            )
            send_ack("failed")
            return
        elapsed = time.monotonic() - t0
        self._m_resize.observe(elapsed)
        self._applied_resize_id = resize_id
        logger.info(
            "live reshard %d applied in %.3fs (mesh %s, state %s)",
            resize_id, elapsed, directive["spec"],
            "resharded" if self.state is not None else "pre-init",
        )
        send_ack("applied")

    # ---- task processing ----------------------------------------------

    def _wait_tick(self, wait_secs: float = 2.0):
        """While WAITing for tasks (queue empty, job unfinished). Under
        multi-host sync an idle worker keeps joining barrier ticks as
        IDLE (a process that only slept would strand its peers inside a
        collective), for up to half a second of its peers' steps before
        it returns to get_task."""
        if self._stop_requested:
            # Idle worker: nothing to hand back; exit the task loop
            # (the post-loop path checkpoints whatever was trained).
            raise WorkerStopped()
        if not self._in_task and not self._resizing:
            # An idle worker must still join a resize barrier (WAIT
            # responses carry the directive).
            self._maybe_apply_resize()
        if (self._multihost_sync and self.state is not None
                and self.last_batch is not None):
            from elasticdl_tpu_torch.parallel import multihost

            deadline = time.monotonic() + min(wait_secs, 0.5)
            while True:
                won = multihost.exchange_code(self._step_runner.mesh,
                                              multihost.STEP_IDLE)
                if won > multihost.STEP_IDLE:
                    self._feed_dummy(won)
                    if time.monotonic() < deadline:
                        continue  # keep ticking before re-polling
                    return
                time.sleep(0.05)
                return
        time.sleep(wait_secs)

    def _await_turn(self, code):
        """Barrier protocol: announce the step we want; while a
        higher-priority step wins the tick, take part in it with a
        zero-mask dummy, then retry. Returns when it is our turn."""
        from elasticdl_tpu_torch.parallel import multihost

        mesh = self._step_runner.mesh
        while True:
            won = multihost.exchange_code(mesh, code)
            if won == code:
                return
            self._feed_dummy(won)

    def _feed_dummy(self, code):
        """Take part in another process's step with zero loss weight."""
        from elasticdl_tpu_torch.parallel import multihost

        dummy = multihost.zero_mask_like(self.last_batch)
        if code == multihost.STEP_TRAIN:
            self.state, _ = self._train_step(self.state, dummy)
            # Every process saves at the same versions: a multi-host
            # checkpoint is written by all of them together.
            self._checkpoint.maybe_save(self.state)
        elif code == multihost.STEP_FORWARD:
            self._eval_step(self.state, dummy)

    def _process_train_batch(self, batch):
        # One attempt: see the module docstring for why a failed step
        # is not retried here.
        if self._multihost_sync:
            from elasticdl_tpu_torch.parallel import multihost

            self._await_turn(multihost.STEP_TRAIN)
        self.state, metrics = self._train_step(self.state, batch)
        self.last_metrics = metrics

    def request_stop(self):
        """Ask the worker to stop at the next TASK boundary, saving a
        checkpoint first (SIGTERM grace-period path). Task granularity
        keeps the exactly-once invariant: a handed-back task has
        consumed none of its records, so nothing trains twice — the
        checkpoint reflects completed tasks only."""
        self._stop_requested = True

    def _process_train_task(self, task, batches) -> int:
        if self._fuse_task_steps:
            batch_list = list(batches)
            if not batch_list:
                return 0
            self._maybe_init(batch_list[0])
            if self._multi_step is not None and len(batch_list) > 1:
                return self._process_train_task_fused(batch_list)
            batches = iter(batch_list)
        # Host-tier runners: pull rows for upcoming minibatches on a
        # prefetch thread while the current one trains. Init needs a raw
        # first batch, so peek it before wrapping.
        batches = iter(batches)
        prepared_iter = None
        prepared_type = ()  # isinstance() no-match sentinel
        if (
            self._step_runner is not None
            and getattr(self._step_runner, "pull_ahead", False)
            and not self._multihost_sync
        ):
            first = next(batches, None)
            if first is None:
                return 0
            self._maybe_init(first)
            from elasticdl_tpu_torch.embedding.host_engine import (
                PreparedBatch,
            )

            prepared_type = PreparedBatch
            prepared_iter = self._step_runner.iter_prepared(
                itertools.chain([first], batches),
                depth=self._host_prefetch_depth,
            )
            batches = prepared_iter
        count = 0
        try:
            for batch in self._traced_batches(batches):
                raw = batch.raw if isinstance(batch, prepared_type) else batch
                self._maybe_init(raw)
                self.last_batch = raw
                step_t0 = time.monotonic()
                with self._tracer.span("device_step", kind="train"):
                    with self._timing.record("batch_process"):
                        self._process_train_batch(batch)
                self._observe_step("train", time.monotonic() - step_t0)
                self._m_examples.labels(task.type).inc(
                    self._batch_examples(raw)
                )
                self._m_h2d_bytes.inc(_nbytes(raw))
                count += 1
                # A Python int: no read from the card.
                version = int(self.state.step)
                if version % self._version_report_steps == 0:
                    self._report_version(version)
                with self._tracer.span("checkpoint"):
                    with self._timing.record("checkpoint"):
                        self._checkpoint.maybe_save(self.state)
        finally:
            if prepared_iter is not None:
                prepared_iter.close()
            # Drain the runner's async row applier at task granularity:
            # an apply failure must fail THIS task (and a task-complete
            # report must cover its last step's applies — nothing may
            # ride a daemon thread past process exit).
            flush = getattr(self._step_runner, "flush", None)
            if flush is not None:
                # Snapshot whether an exception is already propagating
                # BEFORE calling flush — inside an except block
                # exc_info() would report the flush's own error and the
                # re-raise would be unreachable.
                unwinding = sys.exc_info()[0] is not None
                try:
                    flush()
                except Exception:
                    if not unwinding:
                        raise
                    # Don't mask the in-flight exception with the
                    # flush's own.
                    logger.warning(
                        "row applier flush failed during task "
                        "unwind:\n%s", traceback.format_exc(),
                    )
        return count

    def _process_train_task_fused(self, batch_list) -> int:
        """The task's minibatches in one multi-step call; version
        reporting and checkpointing at task granularity."""
        self.last_batch = batch_list[-1]
        stacked = stack_batches(batch_list)
        step_t0 = time.monotonic()
        with self._tracer.span(
            "device_step", kind="train_fused", batches=len(batch_list)
        ):
            with self._timing.record("batch_process"):
                # One attempt, as in _process_train_batch.
                self.state, metrics = self._multi_step(self.state, stacked)
        self.last_metrics = {"loss": metrics["loss"][-1]}
        self._observe_step("train_fused", time.monotonic() - step_t0)
        self._m_examples.labels(TaskType.TRAINING).inc(
            sum(self._batch_examples(b) for b in batch_list)
        )
        self._m_h2d_bytes.inc(sum(_nbytes(b) for b in batch_list))
        version = int(self.state.step)
        # Same SSP gating as the per-step path, at task granularity:
        # report iff a version_report_steps boundary was crossed.
        prev = version - len(batch_list)
        if (
            version // self._version_report_steps
            > prev // self._version_report_steps
        ):
            self._report_version(version)
        with self._timing.record("checkpoint"):
            self._checkpoint.maybe_save(self.state)
        return len(batch_list)

    def _forward_batches(self, task, batches, kind: str):
        """Yield (batch, outputs on the device, real rows) for each batch
        of an eval or predict task."""
        for batch in batches:
            self._maybe_init(batch)
            self.last_batch = batch
            if self._multihost_sync:
                from elasticdl_tpu_torch.parallel import multihost

                self._await_turn(multihost.STEP_FORWARD)
            step_t0 = time.monotonic()
            with self._tracer.span("device_step", kind=kind):
                preds = self._local_rows(self._eval_step(self.state, batch))
            self._observe_step(kind, time.monotonic() - step_t0)
            real = int(np.sum(batch["mask"]))
            self._m_examples.labels(task.type).inc(real)
            self._m_h2d_bytes.inc(_nbytes(batch))
            yield batch, preds, real

    def _local_rows(self, preds):
        """This process's rows of the step's outputs (its rows of the
        global batch under multi-host sync)."""
        if self._multihost_sync:
            from elasticdl_tpu_torch.parallel import multihost

            return multihost.host_local_slice(preds)
        return preds

    def _process_eval_task(self, task, batches):
        outputs_acc, labels_acc = [], []
        for batch, preds, real in self._forward_batches(task, batches,
                                                        "eval"):
            # Kept on the card; the task's outputs cross once, below.
            outputs_acc.append(preds[:real])
            labels_acc.append(np.asarray(batch["labels"])[:real])
        if outputs_acc:
            outputs = _host_outputs(torch.cat(outputs_acc))
            labels = np.concatenate(labels_acc, axis=0)
            self._master_call(
                # task_id keys the master-side dedup: the fold is an
                # accumulate, and this call retries through outages.
                lambda: self._master.report_evaluation_metrics(
                    outputs, labels, task_id=int(task.task_id)
                ),
                "report_evaluation_metrics",
            )

    def _process_predict_task(self, task, batches):
        for _batch, preds, real in self._forward_batches(task, batches,
                                                         "predict"):
            if self._processor is not None:
                # The processor takes host arrays, as in the port's
                # predict job (api/eval_predict_executor.py).
                self._processor.process(
                    preds[:real].float().cpu().numpy(), self._id
                )

    def _run_train_end_callbacks(self):
        for cb in self._callbacks:
            on_end = getattr(cb, "on_train_end", None)
            if on_end is not None:
                on_end(self)

    # ---- main loop -----------------------------------------------------

    def run(self) -> dict:
        """The task pull loop (reference Worker.run →
        _train_and_evaluate)."""
        try:
            return self._run()
        finally:
            try:
                # Land any in-flight async checkpoint write — a dying
                # worker's freshest checkpoint must hit disk before the
                # replacement looks for it.
                self._checkpoint.flush()
            except Exception as exc:
                logger.error("checkpoint flush on exit failed: %s", exc)

    def _run(self) -> dict:
        trained_batches = 0
        try:
            trained_batches = self._task_loop()
        except WorkerStopped:
            logger.info("stop requested while idle; exiting task loop")
        if not self._stop_requested:
            # A directive that arrived WITH the finished response would
            # otherwise never be acked (the task loop is over).
            self._maybe_apply_resize()
        # Under multi-host sync every process took part in every step
        # (its own or a peer's) and writes the final version with the
        # others, whatever it trained itself.
        if self.state is not None and (trained_batches
                                       or self._multihost_sync):
            self._checkpoint.save_final(self.state)
        self._timing.report_timing()
        return {
            "worker_id": self._id,
            "trained_batches": trained_batches,
            "final_version": (
                int(self.state.step) if self.state is not None else 0
            ),
            # The one read of the loss from the card.
            "final_loss": (
                float(self.last_metrics["loss"])
                if self.last_metrics is not None else None
            ),
        }

    def _task_loop(self) -> int:
        trained_batches = 0
        for task, batches in self._task_data.task_stream():
            # Task boundary: the safe point to handle a pending resize
            # directive.
            self._maybe_apply_resize()
            if task.type == TaskType.TRAIN_END_CALLBACK:
                # Count the callback outcome once: a task whose report
                # RPC fails after the callback succeeded must not land
                # in both the ok and error series.
                callbacks_ok = False
                try:
                    self._run_train_end_callbacks()
                    callbacks_ok = True
                    self._m_tasks.labels(task.type, "ok").inc()
                    self._report_task(task.task_id)
                except Exception as exc:
                    if not callbacks_ok:
                        self._m_tasks.labels(task.type, "error").inc()
                    self._report_task(
                        task.task_id,
                        err_reason=f"callback: {type(exc).__name__}: {exc}",
                    )
                continue
            if self._stop_requested:
                # Graceful preemption, checked at the task boundary (the
                # pulled task has consumed nothing): checkpoint the
                # freshest state, hand the task back untouched (it
                # re-queues immediately, without burning its retry
                # budget), and exit.
                logger.info(
                    "stop requested: checkpointing at version %s and "
                    "returning task %d",
                    int(self.state.step) if self.state is not None
                    else "-", task.task_id,
                )
                try:
                    if self.state is not None:
                        self._checkpoint.save_final(self.state)
                except Exception as exc:
                    # A deferred write failure must not skip the task
                    # hand-back below (the master would wait on the
                    # pod-death timeout otherwise).
                    logger.error(
                        "final checkpoint on preemption failed: %s", exc
                    )
                self._m_tasks.labels(task.type, "preempted").inc()
                self._report_task(
                    task.task_id, err_reason="preempted (SIGTERM)"
                )
                break
            # Counts the processing outcome, not the report RPC's: a
            # task that trained fine but whose report raised stays an
            # "ok" task (the except below re-reports it, and without
            # the flag it would land in both series).
            processed_ok = False
            self._in_task = True
            try:
                with self._timing.record("task_process"):
                    if task.type == TaskType.TRAINING:
                        trained_batches += self._process_train_task(
                            task, batches
                        )
                    elif task.type == TaskType.EVALUATION:
                        self._process_eval_task(task, batches)
                    elif task.type == TaskType.PREDICTION:
                        self._process_predict_task(task, batches)
                processed_ok = True
                self._in_task = False
                self._m_tasks.labels(task.type, "ok").inc()
                self._report_task(task.task_id)
            except Exception as exc:
                self._in_task = False
                if self._multihost_sync:
                    # A failed step after winning a barrier tick leaves
                    # peers inside a collective this process never
                    # joined: report-and-continue would desync the tick
                    # count and hang the job. Die; the master re-queues
                    # the task when the worker is gone.
                    logger.error(
                        "Fatal under multi-host sync: task %d: %s",
                        task.task_id, exc,
                    )
                    raise
                logger.error(
                    "Task %d failed: %s\n%s",
                    task.task_id, exc, traceback.format_exc(),
                )
                # type name prefix guarantees a non-empty reason (an empty
                # err_reason would read as success at the master).
                if not processed_ok:
                    self._m_tasks.labels(task.type, "error").inc()
                self._report_task(
                    task.task_id,
                    err_reason=f"{type(exc).__name__}: {exc}",
                )
        if not self._stop_requested:
            # A stopping worker must not drain: the barrier drains only
            # when every process is done.
            self._drain_multihost()
        return trained_batches

    def _drain_multihost(self):
        """Drain barrier: keep taking part in other processes' steps
        (train or forward) until every process reports done, so no one
        is left blocking in a collective."""
        if (not self._multihost_sync or self.state is None
                or self.last_batch is None):
            return
        from elasticdl_tpu_torch.parallel import multihost

        while True:
            won = multihost.exchange_code(self._step_runner.mesh,
                                          multihost.STEP_DONE)
            if won == multihost.STEP_DONE:
                return
            if won == multihost.STEP_IDLE:
                # A peer is idle but its master link still lives: keep
                # ticking (it may yet pick up a requeued task).
                time.sleep(0.05)
                continue
            self._feed_dummy(won)
