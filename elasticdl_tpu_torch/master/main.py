"""Master process entry point (port of elasticdl_tpu/master/main.py).

``python -m elasticdl_tpu_torch.master.main <flags>`` builds the control
plane: model-spec load → reader shards → TaskDispatcher →
EvaluationService (+ TensorBoard) → MasterServicer → gRPC RpcServer —
then the run loop sleeps until the dispatcher drains, checking
straggler timeouts each tick (reference master.py:218-238, :487-509).
Without a k8s client the workers are started by hand (``python -m
elasticdl_tpu_torch.worker.main --master_addr ...``).

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

``--sched`` makes the master a multi-job arbiter
(``master/scheduler.py``): the CLI's own job enters the gang scheduler's
table at construction (or is re-bound to its restored entry after
recovery), more jobs arrive over the ``submit_job`` RPC, and in this
mode leases come only from ``GangScheduler.lease_for``. The table is
event-sourced onto the journal as ``sched`` records and served on
``/sched``; each run tick arbitrates (completion, gang allocation,
priority preemption, resume), and the run loop exits once every job is
terminal, lingering two poll intervals so workers learn ``finished``.

``--stream_dir S`` trains online from ``S``'s append-only partitions
(``data/stream.py``): the dispatcher starts empty in streaming mode and
a ``StreamIngestor`` (``master/stream_ingest.py``) pumps the tail into
offset-ranged tasks every ``--stream_poll_secs``, pausing at
``--stream_max_todo`` queued tasks; committed watermarks ride the
journal, ``--stream_eval_every_records`` opens an eval round over
``--validation_data`` each time that many records commit, and
``/stream`` renders the partitions. Such a job ends when its stream is
closed (``close_stream``), never by draining.

``--probes`` runs the synthetic canary prober
(``observability/prober.py``) once the RPC port is known: the dispatch
round trip against the master's own port, and with
``--row_service_addr`` the row tier's read-your-writes and fresh-client
convergence, with ``--probe_serving_addr`` serving freshness, with
``--stream_dir`` the canary partition's watermark. ``/probes`` renders
them, ``/healthz`` answers their verdict (503 once one is red), and under
``--sched`` the prober is a low-priority tenant (``__prober__``); a red
probe captures an incident bundle through the SLO plane's recorder.

``--timeseries_secs`` (default 5.0; 0 turns it off) samples the cluster
view into the time-series store (``observability/timeseries.py``) each
run tick and evaluates the SLO rules on it (``observability/slo.py``:
the default rules, or ``--slo_rules`` FILE); ``/timeseries`` and
``/alerts`` serve beside ``/metrics``, and with ``--incident_dir`` a
firing rule writes a black-box bundle (spans, the series window, the
critical path, the journal's tail, the profile windows). ``--profile_hz``
runs the sampling profiler (``observability/profiler.py``); the master
serves its own and its reporters' windows on ``/profile``.

``--image_name IMG`` (with a ``kubernetes`` client, or any object with
its methods, given as ``Master(args, k8s_client=...)``; ``main`` builds
one and runs master-only when the package is missing) launches the job's
pods through the instance manager (``master/instance_manager.py``):
``--num_workers`` worker pods running ``python -m
elasticdl_tpu_torch.worker.main`` against the master's Service, one
row-service pod and Service a shard (``--num_row_service_shards``) for a
host-tier model whose zoo module defines ``make_row_service``. A worker
pod that is DELETED or fails with exit 137 has its tasks re-queued and
is relaunched under a new id; a multi-process job
(``--num_jax_processes`` > 1) restarts as a gang with its original ids
under a new pod-name generation, each process resuming from the rolling
checkpoint; a row-service pod is relaunched under its next generation.
Gang and row-service generations are journaled, so a recovered master
adopts the pods under their true names. ``--autoscale`` grows and
drains worker pods from the queue depth and the workers' step
utilization (``master/autoscaler.py``), and ``--row_pod_autoscale``
(with ``--row_reshard``) lets ``RowServicePodScaler`` spawn a row-service
pod before a split onto it and drain one after its merge retires.
``--autoscale_from_timeseries`` reads the workers' utilization as a mean
over the time-series window instead of the last snapshot.
"""

import os
import sys
import time

from elasticdl_tpu_torch.common.args import (
    build_arguments_from_parsed_result,
    parse_envs,
    parse_master_args,
)
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
    if getattr(args, "stream_dir", ""):
        # Streaming mode (master/stream_ingest.py): no finite training
        # shard table — tasks are generated from the stream tail by the
        # StreamIngestor, so the dispatcher starts empty and never
        # finishes until the stream closes. Eval shards still come from
        # --validation_data; rounds open on watermark progress instead
        # of epoch end.
        return TaskDispatcher(
            training_shards={},
            evaluation_shards=(
                reader_of(validation_data).create_shards()
                if validation_data else {}
            ),
            records_per_task=(
                args.minibatch_size * args.num_minibatches_per_task
            ),
            streaming=True,
        )
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


class _ProberTenantDispatcher:
    """Dispatcher stand-in for the synthetic-prober tenant
    (observability/prober.py PROBER_TENANT): the prober consumes no
    worker leases and never drains — it registers with the gang
    scheduler only so preemption/resume of the canary plane is
    arbitrated and observable like any real job. ``finished()`` is
    always False; _job_finished() cancels the tenant once it is the
    only job keeping the scheduler busy, so it cannot wedge master
    exit. Must be passed explicitly at submit() — a dispatcher-less
    job would be rebuilt from ``default_dispatcher_factory`` at admit
    time and cancelled as unloadable."""

    def finished(self) -> bool:
        return False

    def queue_depths(self):
        return (0, 0)

    def preempt_leases(self, reason: str = "") -> int:
        return 0

    def get(self, worker_id):
        return None

    def apply_report(self, task_id, success, err_reason=""):
        return None, -1, False, True


class Master:
    def __init__(self, args, k8s_client=None, warm_state=None):
        """``warm_state`` (the ``--standby`` promotion handover):
        ``{"dispatcher": a continuously-replayed TaskDispatcher,
        "stats": its replay carry}``. With it, construction SKIPS the
        cold journal replay — the standby already folded every record
        into the dispatcher it hands over, and published the fence —
        and only opens the new generation and re-arms around the warm
        state. Without it: a fresh dispatcher, and a full recovery
        replay when the journal has state."""
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
            # A streaming job trains without --training_data, and its
            # dispatcher holds the eval shards back for the watermark
            # trigger — eval_only would open a round whose tasks were
            # never queued and wedge every later trigger behind it.
            eval_only=bool(
                validation_data and not training_data
                and not getattr(args, "stream_dir", "")
            ),
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
        # SLO engine (observability/timeseries.py + slo.py): the run
        # loop samples the cluster view into a bounded time-series
        # store and evaluates burn-rate / threshold / absence rules on
        # it; /timeseries and /alerts serve next to /metrics, and with
        # --incident_dir a firing rule captures a black-box bundle.
        ts_secs = float(getattr(args, "timeseries_secs", 5.0) or 0.0)
        if ts_secs > 0:
            from elasticdl_tpu_torch.observability import slo as slo_mod

            self.metrics_plane.enable_timeseries(cadence_secs=ts_secs)
            rules_path = getattr(args, "slo_rules", "")
            rules = (
                slo_mod.load_rules(rules_path) if rules_path else None
            )
            recorder = None
            incident_dir = getattr(args, "incident_dir", "")
            if incident_dir:
                if not int(getattr(args, "flight_recorder", 0) or 0):
                    logger.warning(
                        "--incident_dir without --flight_recorder: "
                        "incident bundles will carry an empty trace "
                        "timeline (series window, attribution, and "
                        "journal tail are still captured)"
                    )
                recorder = slo_mod.IncidentRecorder(
                    incident_dir,
                    metrics_plane=self.metrics_plane,
                    store=self.metrics_plane.timeseries,
                    journal_tail_fn=(
                        self._journal.tail if self._journal else None
                    ),
                )
            self.metrics_plane.enable_slo(
                rules=rules, incident_recorder=recorder
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
        # Continuous profiling (observability/profiler.py): flame-table
        # windows from this process land on /profile next to the
        # piggybacked worker/component profiles.
        from elasticdl_tpu_torch.observability import profiler as _profiler

        _profiler.maybe_start_from_args(args, "master")
        # Usage-plane tenant cap (observability/usage.py).
        from elasticdl_tpu_torch.observability import usage as _usage

        _usage.set_max_jobs(
            int(getattr(args, "usage_max_jobs", 0) or 0) or None
        )
        # Multi-job control plane (master/scheduler.py, --sched): the
        # gang scheduler's job table event-sources onto the same
        # journal; cold recovery and the warm-standby handover both
        # restore it from the replay carry below.
        self.scheduler = None
        if getattr(args, "sched", False):
            self._build_scheduler()
        self.servicer = MasterServicer(
            self.task_dispatcher,
            self.evaluation_service,
            task_timeout_secs=getattr(args, "task_timeout_secs", 300.0),
            metrics_plane=self.metrics_plane,
            journal=self._journal,
            generation=(
                self._journal.generation if self._journal else 0
            ),
            scheduler=self.scheduler,
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
        # Streaming ingestion (master/stream_ingest.py): tail the
        # --stream_dir partitions into the streaming dispatcher. Built
        # AFTER the servicer so watermark-triggered eval rounds carry
        # the live model version, and after recovery so the ingestor's
        # eval marker seeds from the RESTORED committed watermark (a
        # relaunch resumes pumping from the journaled cursors — offsets
        # below the watermark are never re-tasked).
        self.stream_ingestor = None
        if getattr(args, "stream_dir", ""):
            from elasticdl_tpu_torch.data.stream import FileTailStream
            from elasticdl_tpu_torch.master.stream_ingest import (
                StreamIngestor,
            )

            self.stream_ingestor = StreamIngestor(
                FileTailStream(args.stream_dir),
                self.task_dispatcher,
                max_todo=int(getattr(args, "stream_max_todo", 64)),
                eval_service=self.evaluation_service,
                eval_every_records=int(
                    getattr(args, "stream_eval_every_records", 0)
                ),
                model_version_fn=lambda: self.servicer.model_version,
                metrics_registry=self.metrics_plane.registry,
            )
            self.metrics_plane.add_json_route(
                "/stream",
                lambda params: self.stream_ingestor.render(),
            )
        # Synthetic canary plane (observability/prober.py, --probes):
        # built in prepare() once the RPC server's port is known — the
        # probes go through the PUBLIC wire surfaces, including the
        # master's own.
        self.prober = None
        self._server = None
        # The pod plane (--image_name with a k8s client), the autoscaler,
        # the row plane's shard-map authority (--row_reshard) and its pod
        # scaler (--row_pod_autoscale), built in prepare() as the JAX
        # master builds them.
        self.instance_manager = None
        self.autoscaler = None
        self.row_reshard = None
        self.row_pod_scaler = None
        self._k8s_client = k8s_client
        # SIGTERM grace path (main() installs the handler): the run
        # loop exits at the next poll tick and stop() tears the job
        # down in order — workers get THEIR SIGTERMs (pod deletion) and
        # checkpoint + hand tasks back inside their own grace windows.
        self._stop_requested = False

    def _build_scheduler(self):
        """The gang scheduler over this master's journal and usage plane,
        its table restored from the recovery carry, and the CLI's own
        job submitted into it (or re-bound to its restored entry)."""
        from elasticdl_tpu_torch.master.scheduler import GangScheduler

        args = self._args

        def sched_slots():
            # getattr: render()/this closure can run during __init__
            # (primary-job adoption below), before the servicer exists.
            servicer = getattr(self, "servicer", None)
            live = len(servicer.worker_liveness()) if servicer else 0
            return live or int(getattr(args, "num_workers", 1))

        self.scheduler = GangScheduler(
            sched_slots,
            journal=self._journal,
            usage_fn=self.metrics_plane.usage,
            registry=self.metrics_plane.registry,
        )
        if self._recovery_stats is not None:
            self.scheduler.restore(self._recovery_stats.get("sched"))
        # The CLI's own job enters the table like any tenant — in
        # --sched mode leases come exclusively from the arbiter, so an
        # unsubmitted primary job would never dispatch. A fresh start
        # submits it (journaled); after recovery the entry is already
        # in the restored table and only the volatile half (the
        # recovered dispatcher) needs re-binding.
        primary_job = getattr(args, "job_name", "") or "default"
        if not self.task_dispatcher.finished():
            try:
                self.scheduler.submit(
                    primary_job,
                    gang_size=max(1, int(
                        getattr(args, "num_workers", 1) or 1
                    )),
                    dispatcher=self.task_dispatcher,
                )
            except ValueError:
                # Already in the restored table (recovery path):
                # re-bind the volatile half only.
                self.scheduler.bind_job(
                    primary_job, dispatcher=self.task_dispatcher
                )
        self.metrics_plane.add_json_route(
            "/sched", lambda params: self.scheduler.render()
        )

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

    def _worker_command(self, worker_id: int):
        """Re-serialize parsed args into the worker CLI
        (reference master.py:365-485 + build_arguments_from_parsed_result)."""
        passthrough = build_arguments_from_parsed_result(
            self._args,
            # jax_process_id filtered: the master's own value (-1) must
            # not override the per-worker flag set below.
            filter_args=["worker_id", "force", "master_addr",
                         "jax_process_id", "row_service_addr"],
        )
        # The user's --checkpoint_dir_for_init (warm start) passes through
        # untouched; elastic relaunch resume comes from the worker itself
        # preferring the rolling --checkpoint_dir when it holds a valid
        # version (worker/main.py resolve_init_checkpoint).
        cmd = [sys.executable, "-m", "elasticdl_tpu_torch.worker.main",
               "--worker_id", str(worker_id),
               "--master_addr", self._master_addr_for_workers()]
        if self._uses_row_service():
            cmd += ["--row_service_addr", self._row_service_addr()]
        if getattr(self._args, "num_jax_processes", 1) > 1:
            # Stable process id across gang restarts (multi-process
            # workers always relaunch with original ids).
            cmd += ["--jax_process_id", str(worker_id)]
        return (
            cmd
            + passthrough
        )

    def _uses_row_service(self) -> bool:
        """Host-tier models whose zoo module defines make_row_service get
        a service pod (the reference always ran PS pods for the PS
        strategy; modules wanting process-local tables simply don't
        define the factory)."""
        return (
            self._spec.make_host_runner is not None
            and getattr(self._spec.module, "make_row_service", None)
            is not None
        )

    def _num_row_service_shards(self) -> int:
        n = max(
            1, int(getattr(self._args, "num_row_service_shards", 1) or 1)
        )
        if n > 16:
            # `clean` sweeps per-shard Services over a fixed 0..15
            # range (k8s_client.delete_job) — more shards would leak
            # Services on cleanup.
            raise ValueError(
                f"--num_row_service_shards={n} exceeds the supported "
                "maximum of 16"
            )
        return n

    def _row_service_addr(self) -> str:
        """Comma list of per-shard addresses: the workers scatter rows
        by id % N client-side (the reference's N PS pods,
        worker.py:404-414)."""
        from elasticdl_tpu_torch.platform.k8s_client import (
            ROW_SERVICE_PORT,
            get_row_service_service_name,
        )

        return ",".join(
            "%s:%d" % (
                get_row_service_service_name(
                    self._args.job_name, shard
                ),
                ROW_SERVICE_PORT,
            )
            for shard in range(self._num_row_service_shards())
        )

    def _row_service_command(self, shard: int = 0):
        from elasticdl_tpu_torch.platform.k8s_client import ROW_SERVICE_PORT

        cmd = [sys.executable, "-m",
               "elasticdl_tpu_torch.embedding.row_service",
               "--model_zoo", self._args.model_zoo,
               "--model_def", self._args.model_def,
               "--addr", f"[::]:{ROW_SERVICE_PORT}"]
        ckpt = getattr(self._args, "checkpoint_dir", "")
        if ckpt:
            # Its own subdir: the service's row payload is keyed by push
            # count, the workers' by model version. checkpoint_steps is
            # in model versions; the service counts gradient pushes
            # (~num_workers per version), so scale unless the user set
            # the push-unit knob explicitly.
            steps = int(getattr(
                self._args, "row_service_checkpoint_steps", 0
            ) or 0)
            if not steps:
                steps = int(getattr(self._args, "checkpoint_steps", 0)) * max(
                    1, int(getattr(self._args, "num_workers", 1))
                )
            # Per-shard subdir: each shard owns exactly its id%N rows
            # (client-side scatter), so checkpoints must not collide.
            # Shard 0 keeps the legacy path (single-shard jobs resume
            # pre-shard checkpoints unchanged).
            subdir = (
                "row_service" if shard == 0 else f"row_service/s{shard}"
            )
            cmd += ["--checkpoint_dir", f"{ckpt}/{subdir}",
                    "--checkpoint_steps", str(steps),
                    "--keep_checkpoint_max",
                    str(getattr(self._args, "keep_checkpoint_max", 3))]
            push_log = str(getattr(
                self._args, "row_service_push_log", "durable"
            ))
            if push_log != "off":
                # Zero-RPO by default wherever durability is configured
                # at all: the write-ahead push log rides next to the
                # checkpoint chain, so a SIGKILLed shard pod loses no
                # acked push. --row_service_push_log applied|off
                # tunes/disables it (slow-fsync media).
                cmd += ["--push_log_dir", f"{ckpt}/{subdir}_pushlog",
                        "--push_log_ack", push_log,
                        "--push_log_group_ms",
                        str(getattr(
                            self._args,
                            "row_service_push_log_group_ms", 2.0,
                        ))]
            cmd += [
                    # Layout guard: a relaunch with a different
                    # --num_row_service_shards must fail loudly, not
                    # silently lose the rows whose id%N home moved.
                    "--shard_id", str(shard),
                    "--num_shards",
                    str(self._num_row_service_shards())]
        admission = int(getattr(
            self._args, "row_service_admission_limit", 0
        ))
        if admission > 0:
            cmd += ["--admission_limit", str(admission)]
        durable_wait = float(getattr(
            self._args, "row_service_push_durable_wait_secs", 60.0
        ))
        if durable_wait != 60.0:
            cmd += ["--push_durable_wait_secs", str(durable_wait)]
        return cmd

    def _master_addr_for_workers(self) -> str:
        from elasticdl_tpu_torch.platform.k8s_client import (
            get_master_service_name,
        )

        return "%s:%d" % (
            get_master_service_name(self._args.job_name),
            self._master_port(),
        )

    def prepare(self):
        """Start services: eval trigger, RPC server, worker pods
        (reference Master.prepare, master.py:184-216)."""
        from elasticdl_tpu_torch.comm.rpc import RpcServer

        self.evaluation_service.start_time_trigger()
        if self.stream_ingestor is not None:
            self.stream_ingestor.start(
                interval_secs=float(
                    getattr(self._args, "stream_poll_secs", 0.5)
                )
            )
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
        self._setup_prober()
        metrics_port = int(getattr(self._args, "metrics_port", -1))
        if metrics_port >= 0:
            self.metrics_plane.serve(port=metrics_port)
        if self.tb_service is not None:
            self.tb_service.start()
        if self._k8s_client is not None:
            self._start_instance_manager()
        if getattr(self._args, "autoscale", False):
            self._build_autoscaler()
        if getattr(self._args, "row_reshard", False):
            self._build_row_reshard()
        if (
            getattr(self._args, "row_pod_autoscale", False)
            and self.row_reshard is not None
            and self.instance_manager is not None
        ):
            # Pod-closing autoscaling (master/autoscaler.py
            # RowServicePodScaler): split/merge decisions can spawn and
            # drain row-service pods instead of being confined to the
            # launch-time fleet.
            from elasticdl_tpu_torch.master.autoscaler import (
                RowServicePodScaler,
            )
            from elasticdl_tpu_torch.platform.k8s_client import (
                ROW_SERVICE_PORT,
                get_row_service_service_name,
            )

            job_name = self._args.job_name

            def rs_addr(shard: int) -> str:
                name = get_row_service_service_name(job_name,
                                                    shard=shard)
                return f"{name}:{ROW_SERVICE_PORT}"

            self.row_pod_scaler = RowServicePodScaler(
                self.row_reshard, self.instance_manager, rs_addr,
                metrics_registry=self.metrics_plane.registry,
            )

    def _start_instance_manager(self):
        """The pod plane: the instance manager over the k8s client, its
        watch, and either adoption of the running pods (a recovered
        master) or the row-service pods then the worker pods."""
        from elasticdl_tpu_torch.master.instance_manager import (
            InstanceManager,
        )
        from elasticdl_tpu_torch.platform.k8s_client import (
            get_master_pod_name,
        )

        # Owner reference master→workers so deleting the master pod
        # garbage-collects the whole job (reference
        # k8s_client.py:329-344). Absent when not running as a pod.
        owner = None
        try:
            me = self._k8s_client.get_pod(
                get_master_pod_name(self._args.job_name)
            )
            if me is not None:
                owner = {
                    "name": me.metadata.name,
                    "uid": me.metadata.uid,
                }
        except Exception as exc:
            logger.warning("No master pod owner reference: %s", exc)

        self.instance_manager = InstanceManager(
            self.task_dispatcher,
            self._k8s_client,
            job_name=self._args.job_name,
            image_name=self._args.image_name,
            worker_command=self._worker_command,
            num_workers=self._args.num_workers,
            namespace=self._args.namespace,
            worker_resource_request=self._args.worker_resource_request,
            worker_resource_limit=self._args.worker_resource_limit,
            volume=self._args.volume,
            envs=parse_envs(self._args.envs),
            restart_policy=self._args.restart_policy,
            owner=owner,
            multihost=getattr(self._args, "num_jax_processes", 1) > 1,
            row_service_command=(
                self._row_service_command
                if self._uses_row_service() else None
            ),
            row_service_resource_request=getattr(
                self._args, "row_service_resource_request",
                "cpu=1,memory=4096Mi",
            ),
            row_service_resource_limit=getattr(
                self._args, "row_service_resource_limit", ""
            ),
            num_row_service_shards=self._num_row_service_shards(),
            journal=self._journal,
        )
        self.instance_manager.start_watch()
        if self._recovery_stats is not None:
            # Recovered master: the job's pods are still running and
            # their workers are riding out the outage on their reattach
            # grace — re-creating them would 409 AND strand the
            # survivors. Adopt the ids the journal saw; pods that died
            # during the outage surface as watch events / straggler
            # timeouts and recover through the normal paths.
            relaunch = self._recovery_stats.get("relaunch") or {}
            self.instance_manager.adopt_workers(
                self._recovery_stats["known_workers"]
                or list(range(self._args.num_workers)),
                gang_generation=int(relaunch.get("gang", 0)),
            )
            self.instance_manager.adopt_row_service(
                relaunch.get("row_service")
            )
        else:
            # Row service first (reference Master.prepare starts PS pods
            # before workers, master.py:202-205); workers retry until it
            # answers.
            self.instance_manager.start_row_service()
            self.instance_manager.start_workers()

    def _build_autoscaler(self):
        """Closed-loop autoscaling (master/autoscaler.py): pod scaling
        through the InstanceManager when one exists; without k8s the
        loop still runs (decision telemetry, barrier upkeep) but both
        actions are no-ops."""
        from elasticdl_tpu_torch.master.autoscaler import (
            Autoscaler,
            AutoscalePolicy,
            master_signals,
        )

        args = self._args
        max_workers = int(
            getattr(args, "autoscale_max_workers", 0)
            or getattr(args, "num_workers", 1)
        )
        policy = AutoscalePolicy(
            min_workers=int(getattr(args, "autoscale_min_workers", 1)),
            max_workers=max_workers,
            scale_up_backlog_factor=float(
                getattr(args, "autoscale_up_backlog_factor", 2.0)
            ),
            scale_up_utilization=float(
                getattr(args, "autoscale_up_utilization", 0.7)
            ),
            scale_down_utilization=float(
                getattr(args, "autoscale_down_utilization", 0.3)
            ),
            hysteresis_ticks=int(
                getattr(args, "autoscale_hysteresis_ticks", 3)
            ),
            cooldown_secs=float(
                getattr(args, "autoscale_cooldown_secs", 60.0)
            ),
        )
        manager = self.instance_manager

        def live_count():
            if manager is not None:
                return len(manager.live_workers)
            return max(1, len(self.servicer.worker_liveness()))

        def scale_up(_signals):
            if manager is not None:
                manager.scale_up(1)

        def scale_down(_signals):
            if manager is None:
                return
            live = manager.live_workers
            if live:
                # Drain the youngest worker (highest id): oldest workers
                # hold the warmest caches.
                victim = max(live)
                manager.drain_worker(victim)
                self.servicer.remove_worker_metrics(victim)

        # Opt-in trend signal: utilization as the mean over the
        # time-series window instead of the instantaneous snapshot
        # (the old path stays the default; see master_signals).
        timeseries = None
        if getattr(args, "autoscale_from_timeseries", False):
            timeseries = self.metrics_plane.timeseries
            if timeseries is None:
                logger.warning(
                    "--autoscale_from_timeseries needs "
                    "--timeseries_secs > 0; falling back to the "
                    "snapshot utilization signal"
                )
        self.autoscaler = Autoscaler(
            policy,
            master_signals(
                self.task_dispatcher, self.servicer,
                self.metrics_plane, live_count,
                timeseries=timeseries,
                trend_window_secs=float(getattr(
                    args, "autoscale_trend_window_secs", 120.0
                )),
            ),
            scale_up, scale_down,
        )

    def _setup_prober(self):
        """Synthetic canary plane (--probes; observability/prober.py):
        black-box probes on intervals against the reserved canary
        keyspace, every run tagged with the ``canary`` principal
        purpose. Wired in prepare() because the dispatch probe targets
        the master's OWN public RPC port. Mounts ``/probes`` and the
        aggregated ``/healthz`` verdict, and — in --sched mode —
        registers the prober as a low-priority tenant so it survives
        and observes preemption."""
        args = self._args
        if not getattr(args, "probes", False):
            return
        from elasticdl_tpu_torch.observability import prober as prober_mod

        interval = float(
            getattr(args, "probe_interval_secs", 15.0) or 15.0
        )
        recorder = (
            self.metrics_plane.slo.incident_recorder
            if self.metrics_plane.slo is not None else None
        )
        sched = prober_mod.ProbeScheduler(
            registry=self.metrics_plane.registry,
            incident_recorder=recorder,
        )
        # Dispatch plane: through the wire, like a worker would.
        # worker_id -1 records no liveness; a leased task hands
        # straight back under the graceful "preempted:" reason (no
        # retry budget burned).
        sched.register(
            "dispatch_roundtrip",
            prober_mod.make_dispatch_roundtrip_probe(
                f"localhost:{self._server.port}"
            ),
            interval_secs=interval,
            description="get_task/report_task_result roundtrip "
                        "against the master's dispatch plane",
        )
        # Row tier: read-your-writes + fresh-client reshard
        # convergence whenever a row-service fleet is addressable.
        row_addr = getattr(args, "row_service_addr", "")
        if row_addr:
            canary_client = prober_mod.RowCanaryClient(row_addr)
            sched.register(
                "row_ryw",
                prober_mod.make_row_ryw_probe(canary_client),
                interval_secs=interval,
                description="durable canary push -> immediate pull "
                            "against the row tier (read-your-writes, "
                            "RPO=0 from outside)",
            )
            sched.register(
                "reshard_convergence",
                prober_mod.make_reshard_convergence_probe(row_addr),
                interval_secs=interval,
                description="fresh client (no cached map) rides "
                            "REDIRECTs to a converged canary pull",
            )
            serving_addr = getattr(args, "probe_serving_addr", "")
            if serving_addr:
                feature_key = (
                    getattr(args, "probe_serving_feature_key", "")
                    or "ids"
                )
                canary = prober_mod.canary_id(1)
                predict = prober_mod.make_router_predictor(
                    serving_addr, feature_key, [canary]
                )

                def push_canary(sign, _client=canary_client,
                                _id=canary):
                    import numpy as np

                    dim = _client.dim()
                    _client.push(
                        np.array([_id], np.int64),
                        np.full((1, dim), sign * 1e-3, np.float32),
                    )

                sched.register(
                    "serving_freshness",
                    prober_mod.make_serving_freshness_probe(
                        predict, push_canary
                    ),
                    interval_secs=interval,
                    description="canary push -> serving router "
                                "prediction change (outside-in "
                                "push-to-servable)",
                )
        if getattr(args, "stream_dir", "") and \
                self.stream_ingestor is not None:
            append = prober_mod.make_stream_appender(args.stream_dir)

            def canary_watermark():
                part = self.stream_ingestor.render()["partitions"].get(
                    prober_mod.CANARY_STREAM_PARTITION
                )
                return None if part is None else int(part["committed"])

            sched.register(
                "stream_watermark",
                prober_mod.make_stream_watermark_probe(
                    append, canary_watermark
                ),
                interval_secs=interval,
                description="canary stream append -> committed "
                            "watermark advances past it",
            )
        if self.scheduler is not None:
            tenant = prober_mod.PROBER_TENANT
            tenant_disp = _ProberTenantDispatcher()
            try:
                self.scheduler.submit(
                    tenant, spec={"synthetic": True}, priority=-100,
                    gang_size=1, dispatcher=tenant_disp,
                    preempt_cb=sched.note_preempted,
                    resume_cb=sched.note_resumed,
                )
            except ValueError:
                # Already in the journal-restored table (recovery):
                # re-bind the volatile half only.
                self.scheduler.bind_job(
                    tenant, dispatcher=tenant_disp,
                    preempt_cb=sched.note_preempted,
                    resume_cb=sched.note_resumed,
                )
            sched.note_registered()
        self.metrics_plane.add_json_route(
            "/probes", lambda params: sched.render()
        )
        self.metrics_plane.set_health(sched.healthz)
        sched.start(poll_secs=min(1.0, max(0.05, interval / 4.0)))
        self.prober = sched

    def request_stop(self):
        """Ask the run loop to exit at the next tick (SIGTERM path).
        Signal-handler safe: sets a flag, no locks, no teardown here."""
        self._stop_requested = True

    def _job_finished(self) -> bool:
        """The run loop's exit gate: the primary dispatcher drained
        AND (in --sched mode) every scheduler job reached a terminal
        state — a preempted job still owed a resume must keep the
        fleet up."""
        if not self.task_dispatcher.finished():
            return False
        if self.scheduler is None:
            return True
        if not self.scheduler.idle() and self.prober is not None:
            # The prober tenant never drains by design. When it is the
            # ONLY job still non-terminal, the real work is done:
            # retire the canary tenant so it cannot wedge master exit.
            from elasticdl_tpu_torch.master.scheduler import TERMINAL_STATES
            from elasticdl_tpu_torch.observability.prober import (
                PROBER_TENANT,
            )

            jobs = self.scheduler.export_state()["jobs"]
            open_jobs = [
                job_id for job_id, job in jobs.items()
                if job["state"] not in TERMINAL_STATES
            ]
            if open_jobs == [PROBER_TENANT]:
                self.scheduler.cancel(PROBER_TENANT)
        return self.scheduler.idle()

    def run(self, poll_secs: float = 5.0):
        """Sleep until the job is finished (reference
        master.py:218-238); each tick, kill stragglers (3× mean task
        time, :487-509), tick the autoscaler and, under --sched,
        arbitrate."""
        try:
            while not self._job_finished():
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
                    if self.instance_manager is not None:
                        self.instance_manager.kill_worker(worker_id)
                    else:
                        self.task_dispatcher.recover_tasks(worker_id)
                    # A relaunch comes back under a NEW worker id —
                    # drop the dead id's series now, not at the TTL.
                    self.servicer.remove_worker_metrics(worker_id)
                # Resize-barrier upkeep: refresh membership from the
                # live fleet so a worker that died mid-barrier (its
                # tasks recovered above / by the watch path) cannot
                # wedge it — its replacement acks under its own id.
                if self.servicer.resize_status() is not None:
                    live = (
                        list(self.instance_manager.live_workers)
                        if self.instance_manager is not None
                        else list(self.servicer.worker_liveness())
                    )
                    self.servicer.maybe_complete_resize(live)
                if self.autoscaler is not None:
                    self.autoscaler.tick()
                if self.scheduler is not None:
                    # Multi-job arbitration: completion sweep, gang
                    # allocation, preemption, resume. A fenced journal
                    # aborts the tick (JournalFencedError) — a zombie
                    # arbiter must stop.
                    try:
                        self.scheduler.tick()
                    except Exception:
                        logger.exception("scheduler tick failed")
                if self.row_reshard is not None:
                    # Rebalance ranges, refresh hot-row replicas; tick()
                    # contains its own failures (a flaky shard must not
                    # take the master loop down).
                    self.row_reshard.tick()
                if self.row_pod_scaler is not None:
                    # Pod-closing half of merges: drain the pod behind
                    # any slot the controller just retired.
                    try:
                        self.row_pod_scaler.tick()
                    except Exception:
                        logger.exception("row pod scaler tick failed")
                # SLO plane: sample the time-series store (if due) and
                # evaluate the rules on the fresh window.
                self.metrics_plane.slo_tick()
                self.metrics_plane.publish_tensorboard(
                    self.servicer.model_version
                )
            if self.scheduler is not None and not self._stop_requested:
                # In --sched mode the finished signal flips at the
                # same arbitration tick that satisfies the exit gate
                # above — unlike the single-job plane, where workers
                # observe it the moment the last report lands, a full
                # poll window before the master exits. Serve the
                # finished response for a couple of poll intervals so
                # the fleet learns completion from get_task instead of
                # burning its reattach grace on a drained job.
                time.sleep(min(10.0, 2 * poll_secs))
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
        if self.prober is not None:
            self.prober.stop()
        if self.stream_ingestor is not None:
            self.stream_ingestor.stop()
        if self.row_reshard is not None:
            self.row_reshard.close()
        self.metrics_plane.stop()
        self.evaluation_service.stop()
        if self.instance_manager is not None:
            self.instance_manager.stop()
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


def run_standby(args, k8s_client=None) -> int:
    """``--standby`` role: keep a WARM continuously-replayed dispatcher
    by tailing the primary's journal, heartbeat the primary, and on
    missed heartbeats FENCE the old incarnation and promote into a full
    ``Master`` that ADOPTS the warm dispatcher.

    The standby pays the cold start (interpreter, imports, model-spec
    load) up front and amortizes the journal replay over its lifetime:
    each poll folds only the appended tail into the warm dispatcher
    (``StandbyMaster.poll_journal``), so promotion replays nothing but
    the last partial poll, and ``Master(args, warm_state=...)`` skips
    ``recover_master_state`` and re-arms the whole assembly around the
    handed-over state, the k8s adoption of running pods included. The
    standby reports into the primary's cluster view
    (``ComponentMetricsReporter``), so the SLO absence rule on its
    heartbeat series fires when it dies."""
    from elasticdl_tpu_torch.master.standby import StandbyMaster
    from elasticdl_tpu_torch.observability import default_registry

    journal_dir = getattr(args, "journal_dir", "")
    if not journal_dir:
        logger.error("--standby requires --journal_dir (shared with "
                     "the primary)")
        return 2
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
    # Report into the primary's cluster view so the master-side
    # absence rule on the heartbeat series can fire when this standby
    # dies (failover protection gone).
    from elasticdl_tpu_torch.observability.reporter import (
        ComponentMetricsReporter,
    )

    reporter = ComponentMetricsReporter(primary, "standby")
    reporter.start()
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
    reporter.stop()
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
    master = Master(args, k8s_client=k8s_client, warm_state=warm)
    master.prepare()
    m_failover.observe(time.monotonic() - t_detect)
    return master.run()


def main(argv=None):
    args = parse_master_args(argv)
    k8s_client = None
    if getattr(args, "image_name", ""):
        from elasticdl_tpu_torch.platform import k8s_client as k8s_mod

        try:
            k8s_client = k8s_mod.Client(
                namespace=args.namespace,
                force_kube_config=args.force_use_kube_config_file,
            )
        except k8s_mod.K8sUnavailableError as exc:
            logger.warning("k8s unavailable (%s); running master-only", exc)
    if getattr(args, "standby", False):
        return run_standby(args, k8s_client=k8s_client)
    master = Master(args, k8s_client=k8s_client)
    master.prepare()
    # Graceful eviction: with a handler, run() exits at the next tick
    # and stop() deletes the worker pods (each then runs its own SIGTERM
    # checkpoint + task hand-back) inside the master's grace period.
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
