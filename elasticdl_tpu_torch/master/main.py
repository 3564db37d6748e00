"""Master process entry point (port of elasticdl_tpu/master/main.py).

``python -m elasticdl_tpu_torch.master.main <flags>`` builds the control
plane: model-spec load → reader shards → TaskDispatcher →
EvaluationService (+ TensorBoard) → MasterServicer → gRPC RpcServer —
then the run loop sleeps until the dispatcher drains, checking
straggler timeouts each tick (reference master.py:218-238, :487-509).
Workers are started by hand (``python -m elasticdl_tpu_torch.worker.main
--master_addr ...``).

``Master`` is also constructible in-process for tests. The master runs
no model: it imports the zoo module for its dataset shards, callbacks
and metric functions, and builds the module's model on the CPU.

``--journal_dir D`` writes every dispatch, report, eval-round and
version event through the master's write-ahead journal
(``master/journal.py``); a master started on a journal that holds state
replays it before it serves (cold crash recovery), under the next
generation. ``--standby --journal_dir D --primary_addr A`` runs a hot
standby (``run_standby``): it tails D into a warm dispatcher, pings the
primary at A, and after ``--standby_miss_threshold`` missed beats fences
the primary's generation and promotes into a ``Master`` that adopts the
warm dispatcher, serving on its own ``--master_addr``.

``--row_reshard --row_service_addr a,b`` hosts the row plane's
shard-map authority (``master/row_reshard.py``): it bootstraps (or
resumes) the map over the listed shards and ticks its policy (range
moves off load imbalance, hot-row read replicas, the retirement of
merged-away shards) every run tick. Its state file is
``--row_reshard_state``, or ``<journal_dir>/shard_map.json``; under a
journal its epochs are journaled too.

Not ported yet, and raising when asked for: the gang scheduler
(``--sched``), streaming ingestion (``--stream_dir``) and the prober
(``--probes``), ROADMAP Queue 1 item 8d-ii; the k8s instance manager
(``--image_name``), the autoscaler (``--autoscale``) and row-service
pods grown and drained with the splits (``--row_pod_autoscale``), item
8d-iii. Row-service pods are not launched by the port's master either:
start ``python -m elasticdl_tpu_torch.embedding.row_service`` by hand
(one a shard, and one more before a split onto it) and give the workers
``--row_service_addr``.
"""

import os
import sys
import time

from elasticdl_tpu_torch.common.args import parse_master_args
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.core.model_spec import get_model_spec
from elasticdl_tpu_torch.data.factory import (
    create_data_reader,
    parse_data_reader_params,
)
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.servicer import SERVICE_NAME, MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher

logger = get_logger("master")

# Flag -> (what it asks for, the ROADMAP item that holds it), for the
# parts of the JAX master that are not ported yet.
_NOT_PORTED = {
    "image_name": ("the k8s instance manager (worker pods)", "8d-iii"),
    "autoscale": ("the autoscaler", "8d-iii"),
    "row_pod_autoscale": (
        "row-service pods grown and drained with splits", "8d-iii"),
    "sched": ("the gang scheduler", "8d-ii"),
    "stream_dir": ("streaming ingestion", "8d-ii"),
    "probes": ("the synthetic prober", "8d-ii"),
}


def _refuse_unported(args):
    for flag, (what, item) in _NOT_PORTED.items():
        if getattr(args, flag, None):
            raise NotImplementedError(
                f"--{flag}: {what} is not ported yet (ROADMAP Queue 1, "
                f"item {item})"
            )


def build_dispatcher(args, spec) -> TaskDispatcher:
    """The job's TaskDispatcher from its parsed args + model spec —
    shards, sizing, deferred train-end callback, max-steps bounds."""
    reader_params = parse_data_reader_params(
        getattr(args, "data_reader_params", "")
    )
    reader_of = lambda origin: create_data_reader(  # noqa: E731
        data_origin=origin,
        custom_reader=spec.custom_data_reader,
        **reader_params,
    )
    training_data = getattr(args, "training_data", "")
    validation_data = getattr(args, "validation_data", "")
    prediction_data = getattr(args, "prediction_data", "")
    dispatcher = TaskDispatcher(
        training_shards=(
            reader_of(training_data).create_shards()
            if training_data else {}
        ),
        evaluation_shards=(
            reader_of(validation_data).create_shards()
            if validation_data else {}
        ),
        prediction_shards=(
            reader_of(prediction_data).create_shards()
            if prediction_data else {}
        ),
        records_per_task=(
            args.minibatch_size * args.num_minibatches_per_task
        ),
        num_epochs=getattr(args, "num_epochs", 1),
    )
    if training_data:
        # Queue the train-end callback task when the job drains so a
        # worker runs on_train_end (SavedModelExporter etc. — reference
        # task_dispatcher.py:206-241).
        dispatcher.add_deferred_callback(
            dispatcher.create_train_end_callback_task
        )
    if getattr(args, "max_steps", 0):
        dispatcher.set_max_steps(args.max_steps, args.minibatch_size)
    # MaxStepsStopping callback also bounds dispatch
    # (reference callbacks.py:57-98).
    from elasticdl_tpu_torch.callbacks import MaxStepsStopping, find_callback

    cbs = spec.callbacks_fn() if spec.callbacks_fn else []
    ms = find_callback(cbs, MaxStepsStopping)
    # CLI --max_steps wins over the callback (same precedence as
    # LocalExecutor).
    if ms is not None and not getattr(args, "max_steps", 0):
        dispatcher.set_max_steps(ms.max_steps, args.minibatch_size)
    return dispatcher


class Master:
    def __init__(self, args, warm_state=None):
        """``warm_state`` (the ``--standby`` promotion handover):
        ``{"dispatcher": a continuously-replayed TaskDispatcher,
        "stats": its replay carry}``. With it, construction SKIPS the
        cold journal replay — the standby already folded every record
        into the dispatcher it hands over, and published the fence —
        and only opens the new generation and re-arms around the warm
        state. Without it: a fresh dispatcher, and a full recovery
        replay when the journal has state."""
        _refuse_unported(args)
        self._args = args
        # The master trains nothing: the zoo's model is built on the CPU.
        self._spec = get_model_spec(
            model_zoo=args.model_zoo,
            model_def=args.model_def,
            dataset_fn=args.dataset_fn,
            loss=args.loss,
            optimizer=args.optimizer,
            eval_metrics_fn=args.eval_metrics_fn,
            callbacks=args.callbacks,
            custom_data_reader=args.custom_data_reader,
            device="cpu",
        )
        validation_data = getattr(args, "validation_data", "")
        training_data = getattr(args, "training_data", "")
        if warm_state is not None:
            self.task_dispatcher = warm_state["dispatcher"]
        else:
            self.task_dispatcher = build_dispatcher(args, self._spec)

        # Crash recovery (master/journal.py): with --journal_dir the
        # dispatcher writes every dispatch/report through the journal;
        # a restarted master replays snapshot + tail here, AFTER the
        # deferred callback and max-steps config above, which replay
        # depends on, and BEFORE the servicer exists, so it is born
        # with the recovered state.
        from elasticdl_tpu_torch.master.journal import (
            MasterJournal,
            recover_master_state,
        )

        self._journal = None
        self._recovery_stats = None
        journal_dir = getattr(args, "journal_dir", "")
        if warm_state is not None and not journal_dir:
            raise ValueError(
                "warm_state handover requires --journal_dir (the "
                "standby replays FROM it)"
            )
        if journal_dir:
            self._journal = MasterJournal(journal_dir)
            if warm_state is not None:
                # Warm promotion: no replay — the handed-over
                # dispatcher IS the replayed state (tail included; the
                # caller drained it after publishing the fence). Open
                # our generation above the fence, stamp the fence
                # record, and re-attach write-through.
                stats = dict(warm_state["stats"])
                stats["known_workers"] = sorted(stats["known_workers"])
                generation = self._journal.open_generation()
                self._journal.append("fence", generation=generation)
                self.task_dispatcher.attach_journal(self._journal)
                stats["generation"] = generation
                self._recovery_stats = stats
            elif self._journal.has_state():
                self._recovery_stats = recover_master_state(
                    self._journal, self.task_dispatcher
                )
            else:
                self._journal.open_generation()
                self.task_dispatcher.attach_journal(self._journal)
        tb_service = None
        if getattr(args, "tensorboard_log_dir", ""):
            from elasticdl_tpu_torch.master.tensorboard_service import (
                TensorboardService,
            )

            tb_service = TensorboardService(args.tensorboard_log_dir)
        self.tb_service = tb_service
        metrics_fns = (
            self._spec.eval_metrics_fn()
            if self._spec.eval_metrics_fn else {}
        )
        self.evaluation_service = EvaluationService(
            self.task_dispatcher,
            metrics_fns,
            eval_steps=getattr(args, "evaluation_steps", 0),
            start_delay_secs=getattr(
                args, "evaluation_start_delay_secs", 0
            ),
            throttle_secs=getattr(args, "evaluation_throttle_secs", 0),
            eval_only=bool(validation_data and not training_data),
            summary_writer=tb_service,
        )
        if self._journal is not None:
            # Round state is event-sourced onto the same journal:
            # restore the replayed open round FIRST (a recovered master
            # resumes it instead of dropping the metrics), then attach
            # for write-through.
            if self._recovery_stats is not None:
                self.evaluation_service.restore_recovered(
                    self._recovery_stats.get("eval")
                )
            self.evaluation_service.attach_journal(self._journal)
        # Telemetry plane: master-local registry (dispatcher gauges,
        # straggler counter) + worker snapshot aggregation + /metrics;
        # selected aggregates mirror into TensorBoard each run tick.
        from elasticdl_tpu_torch.observability import MetricsPlane

        metrics_ttl = getattr(args, "metrics_ttl_secs", None)
        if metrics_ttl is None:
            # Documented default: 2x the straggler deadline, so a worker
            # that is merely slow (silent for one whole task) is never
            # aged out of the cluster view.
            metrics_ttl = 2.0 * getattr(args, "task_timeout_secs", 300.0)
        self.metrics_plane = MetricsPlane(
            ttl_secs=metrics_ttl,
            summary_writer=tb_service,
        )
        # Workload attribution (observability/principal.py): the
        # master's own outbound RPCs are control-plane by definition.
        from elasticdl_tpu_torch.observability import principal as _principal

        _principal.set_process_principal(
            job=str(getattr(args, "job_name", "") or ""),
            component="master", purpose="control",
        )
        # Distributed tracing (observability/tracing.py): with a
        # recorder installed, dispatch spans + collected worker spans
        # serve on /traces next to /metrics.
        recorder_spans = int(getattr(args, "flight_recorder", 0) or 0)
        if recorder_spans > 0:
            from elasticdl_tpu_torch.observability import tracing

            tracing.set_process_role("master")
            tracing.install_recorder(
                tracing.FlightRecorder(recorder_spans)
            )
        # Usage-plane tenant cap (observability/usage.py).
        from elasticdl_tpu_torch.observability import usage as _usage

        _usage.set_max_jobs(
            int(getattr(args, "usage_max_jobs", 0) or 0) or None
        )
        self.servicer = MasterServicer(
            self.task_dispatcher,
            self.evaluation_service,
            task_timeout_secs=getattr(args, "task_timeout_secs", 300.0),
            metrics_plane=self.metrics_plane,
            journal=self._journal,
            generation=(
                self._journal.generation if self._journal else 0
            ),
        )
        if self._recovery_stats is not None:
            # Re-arm the servicer with the recovered high-water marks:
            # eval triggering continues from the journaled model
            # version, and surviving leases get fresh straggler clocks.
            self.servicer.model_version = self._recovery_stats[
                "model_version"
            ]
            self.servicer.seed_task_start_times(
                list(self.task_dispatcher.doing_start_times())
            )
            if self._recovery_stats.get("resize"):
                # Crash mid-resize: re-offer the pending directive.
                self.servicer.rearm_resize(
                    self._recovery_stats["resize"]
                )
        self._server = None
        # SIGTERM grace path (main() installs the handler): the run
        # loop exits at the next poll tick and stop() tears the job
        # down in order.
        self._stop_requested = False
        # The row plane's shard-map authority (--row_reshard), built in
        # prepare() as the JAX master builds it.
        self.row_reshard = None

    def _build_row_reshard(self):
        """Row-plane elasticity: the master hosts the shard-map authority
        over the --row_service_addr fleet and ticks its policy in the
        run loop. Its state file is ``--row_reshard_state``, else
        ``<journal_dir>/shard_map.json``; its epochs ride the journal
        as ``shard_map`` records."""
        from elasticdl_tpu_torch.master.row_reshard import (
            ReshardPolicy,
            ShardMapController,
        )

        args = self._args
        addrs = [
            a.strip()
            for a in getattr(args, "row_service_addr", "").split(",")
            if a.strip()
        ]
        if not addrs:
            raise ValueError("--row_reshard needs --row_service_addr")
        state_path = getattr(args, "row_reshard_state", "")
        if not state_path:
            journal_dir = getattr(args, "journal_dir", "")
            if not journal_dir:
                raise ValueError(
                    "--row_reshard needs --row_reshard_state (or a "
                    "--journal_dir to default into)")
            state_path = os.path.join(journal_dir, "shard_map.json")
        self.row_reshard = ShardMapController(
            state_path,
            journal=self._journal,
            policy=ReshardPolicy(
                replica_top_k=int(getattr(args, "row_replica_top_k", 64)),
                replica_count=int(getattr(args, "row_replica_count", 2)),
                cooldown_secs=float(
                    getattr(args, "row_reshard_cooldown_secs", 30.0)
                ),
            ),
        )
        if self.row_reshard.map is None:
            self.row_reshard.bootstrap(addrs)
        else:
            # A restarted authority finishes any migration in flight and
            # distributes the persisted epoch again.
            self.row_reshard.resume()

    # ---- assembly -------------------------------------------------------

    def _master_port(self) -> int:
        addr = getattr(self._args, "master_addr", "") or ":50001"
        try:
            return int(addr.rsplit(":", 1)[1])
        except (IndexError, ValueError):
            return 50001

    def prepare(self):
        """Start services: eval trigger, RPC server (reference
        Master.prepare, master.py:184-216)."""
        from elasticdl_tpu_torch.comm.rpc import RpcServer

        self.evaluation_service.start_time_trigger()
        admission = None
        admission_limit = int(getattr(
            self._args, "master_admission_limit", 0
        ))
        if admission_limit > 0:
            from elasticdl_tpu_torch.comm import overload

            # One gate for every master handler: the thing being
            # protected (the servicer lock, the worker pool) is
            # per-server.
            admission = overload.AdmissionController(
                admission_limit, tag="master",
            )
        self._server = RpcServer(
            f"[::]:{self._master_port()}",
            {SERVICE_NAME: self.servicer.handlers()},
            admission=admission,
        ).start()
        logger.info("Master RPC serving on port %d", self._server.port)
        metrics_port = int(getattr(self._args, "metrics_port", -1))
        if metrics_port >= 0:
            self.metrics_plane.serve(port=metrics_port)
        if self.tb_service is not None:
            self.tb_service.start()
        if getattr(self._args, "row_reshard", False):
            self._build_row_reshard()

    def request_stop(self):
        """Ask the run loop to exit at the next tick (SIGTERM path).
        Signal-handler safe: sets a flag, no locks, no teardown here."""
        self._stop_requested = True

    def run(self, poll_secs: float = 5.0):
        """Sleep until the dispatcher drains (reference master.py:218-238);
        each tick, recover stragglers' tasks (3× mean task time,
        :487-509)."""
        try:
            while not self.task_dispatcher.finished():
                if self._stop_requested:
                    logger.warning(
                        "stop requested (SIGTERM); tearing the job "
                        "down gracefully with tasks still pending"
                    )
                    break
                time.sleep(poll_secs)
                for task_id, worker_id in self.servicer.find_timeout_tasks():
                    logger.warning(
                        "Task %d on worker %d timed out; recovering",
                        task_id, worker_id,
                    )
                    self.task_dispatcher.recover_tasks(worker_id)
                    # A relaunch comes back under a NEW worker id —
                    # drop the dead id's series now, not at the TTL.
                    self.servicer.remove_worker_metrics(worker_id)
                # Resize-barrier upkeep: refresh membership from the
                # live fleet so a worker that died mid-barrier cannot
                # wedge it.
                if self.servicer.resize_status() is not None:
                    self.servicer.maybe_complete_resize(
                        list(self.servicer.worker_liveness())
                    )
                if self.row_reshard is not None:
                    # Rebalance ranges, refresh hot-row replicas; tick()
                    # contains its own failures (a flaky shard must not
                    # take the master loop down).
                    self.row_reshard.tick()
                self.metrics_plane.publish_tensorboard(
                    self.servicer.model_version
                )
        finally:
            # The last tasks finish during the final poll sleep; flush
            # that interval's aggregates to TensorBoard before stop()
            # tears down the plane, or the tfevents tail under-counts.
            self.metrics_plane.publish_tensorboard(
                self.servicer.model_version
            )
            self.stop()
        return 0

    def stop(self):
        if self.row_reshard is not None:
            self.row_reshard.close()
        self.metrics_plane.stop()
        self.evaluation_service.stop()
        if self._server is not None:
            self._server.stop(grace=2.0)
        # After the server: an in-flight report draining through the
        # grace period still writes through the journal; closing first
        # would turn it into an INTERNAL error at the worker.
        if self._journal is not None:
            self._journal.close()

    @property
    def port(self):
        return self._server.port if self._server else None


def run_standby(args) -> int:
    """``--standby`` role: keep a WARM continuously-replayed dispatcher
    by tailing the primary's journal, heartbeat the primary, and on
    missed heartbeats FENCE the old incarnation and promote into a full
    ``Master`` that ADOPTS the warm dispatcher.

    The standby pays the cold start (interpreter, imports, model-spec
    load) up front and amortizes the journal replay over its lifetime:
    each poll folds only the appended tail into the warm dispatcher
    (``StandbyMaster.poll_journal``), so promotion replays nothing but
    the last partial poll, and ``Master(args, warm_state=...)`` skips
    ``recover_master_state``. The JAX standby also reports into the
    primary's cluster view for the SLO absence rule; the port has no
    component reporter yet (ROADMAP item 8f)."""
    from elasticdl_tpu_torch.master.standby import StandbyMaster
    from elasticdl_tpu_torch.observability import default_registry

    journal_dir = getattr(args, "journal_dir", "")
    if not journal_dir:
        logger.error("--standby requires --journal_dir (shared with "
                     "the primary)")
        return 2
    # Before the wait, not at promotion: a standby of a job the port
    # cannot run must fail at its start.
    _refuse_unported(args)
    primary = getattr(args, "primary_addr", "") or args.master_addr
    heartbeat_secs = float(getattr(args, "standby_heartbeat_secs", 1.0))
    miss_threshold = int(getattr(args, "standby_miss_threshold", 3))
    m_failover = default_registry().histogram(
        "master_failover_seconds",
        "Hot-standby takeover latency: primary declared dead -> "
        "promoted master serving",
    )
    # Pre-warm the expensive import path (model zoo + spec); the spec
    # also feeds the warm dispatcher factory below — the standby MUST
    # build dispatchers from the identical job config the primary used,
    # or its replay diverges. Bounded retries: a transient zoo read
    # error at start must not one-shot the process and silently strip
    # the job's failover protection.
    spec = None
    for attempt in range(5):
        try:
            spec = get_model_spec(
                model_zoo=args.model_zoo, model_def=args.model_def,
                dataset_fn=args.dataset_fn, loss=args.loss,
                optimizer=args.optimizer,
                eval_metrics_fn=args.eval_metrics_fn,
                callbacks=args.callbacks,
                custom_data_reader=args.custom_data_reader,
                device="cpu",
            )
            break
        except Exception as exc:
            logger.warning(
                "standby spec load failed (attempt %d/5): %s",
                attempt + 1, exc,
            )
            time.sleep(2.0)
    if spec is None:
        logger.error(
            "standby cannot load the model spec; exiting (the spec "
            "builds the warm dispatcher — without it promotion would "
            "diverge from the primary's replay)"
        )
        return 2
    # The warm tail: StandbyMaster's poll/heartbeat halves only — the
    # promotion itself goes through Master(warm_state=) below, so the
    # CLI role keeps the whole assembly.
    standby = StandbyMaster(
        journal_dir,
        dispatcher_factory=lambda: build_dispatcher(args, spec),
        assemble=None,
        primary_addr=primary,
        serve_addr="",
        heartbeat_secs=heartbeat_secs,
        miss_threshold=miss_threshold,
    )
    logger.info(
        "standby: heartbeating %s every %.2fs (takeover after %d "
        "misses), warm-tailing %s", primary, heartbeat_secs,
        miss_threshold, standby._journal.path,
    )
    while True:
        standby.heartbeat()
        standby.poll_journal()
        if standby._misses >= miss_threshold:
            break
        time.sleep(heartbeat_secs)
    t_detect = time.monotonic()
    standby.stop()
    # Fence FIRST (a partitioned-but-alive primary must be locked out
    # of the journal before the promoted master trusts its replay),
    # drain the race, release the journal — StandbyMaster.hand_over
    # keeps this ordering in ONE place with the embedded take_over.
    warm = standby.hand_over()
    logger.warning(
        "standby taking over: fence generation %d published; "
        "promoting the WARM dispatcher into a full master "
        "(%d record(s) were warm-replayed over this standby's "
        "lifetime)", warm["fence_generation"],
        warm["stats"]["replayed"],
    )
    master = Master(args, warm_state=warm)
    master.prepare()
    m_failover.observe(time.monotonic() - t_detect)
    return master.run()


def main(argv=None):
    args = parse_master_args(argv)
    if getattr(args, "standby", False):
        return run_standby(args)
    master = Master(args)
    master.prepare()
    # Graceful eviction: with a handler, run() exits at the next tick
    # and stop() tears the job down inside the grace period.
    import signal

    try:
        signal.signal(
            signal.SIGTERM, lambda *_: master.request_stop()
        )
    except ValueError:
        pass  # not the main thread (embedded use)
    code = master.run()
    if master.tb_service is not None:
        # The post-training TensorBoard keep-alive must not outlive a
        # SIGTERM: the handler swallows further signals, so looping
        # here would burn the whole grace period and end in SIGKILL.
        while (not master._stop_requested
               and master.tb_service.keep_running()):
            time.sleep(10)
        master.tb_service.close()
    return code


if __name__ == "__main__":
    sys.exit(main())
