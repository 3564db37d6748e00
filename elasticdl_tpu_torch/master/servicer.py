"""Master service handlers.

A copy of elasticdl_tpu/master/servicer.py: the port keeps its own.

Counterpart of the reference's ``master/servicer.py`` (MasterServicer): the
four control RPCs — get_task, report_task_result, report_evaluation_metrics,
report_version — plus worker-liveness and mean-task-time tracking used for
timeout-based straggler detection (reference servicer.py:107-124).

Handlers take/return plain dicts (see comm/rpc.py); ``InProcessMaster`` in
testing/ calls them directly, the RpcServer serves them over gRPC.

Tracing: over RPC each handler already runs under a ``serve/<method>``
server span (comm/rpc.py); the dispatcher adds its own ``dispatch``
span inside get_task, and the eval-metrics fold — the one handler
doing real compute — gets an ``eval_report`` span here. Piggybacked
worker spans ride the ``metrics`` snapshots and are popped into the
plane's TraceCollector by ``MetricsPlane.ingest``.
"""

import threading
import time
from typing import Dict, Optional

from elasticdl_tpu_torch.common.constants import TaskType
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.task import Task
from elasticdl_tpu_torch.observability import tracing

logger = get_logger("master_servicer")

SERVICE_NAME = "elasticdl_tpu.Master"


class MasterServicer:
    def __init__(self, task_dispatcher, evaluation_service=None,
                 task_timeout_secs: float = 300.0, metrics_plane=None,
                 journal=None, generation: int = 0, scheduler=None):
        from elasticdl_tpu_torch.observability import MetricsPlane

        self._task_d = task_dispatcher
        self._eval_service = evaluation_service
        # Multi-job mode (master/scheduler.py): when a GangScheduler is
        # attached, get_task routes through its worker->job binding and
        # every lease/report is job-scoped; without one, behavior is
        # the single-job plane unchanged.
        self._scheduler = scheduler
        # Master incarnation fence (master/journal.py): stamped on every
        # get_task response so workers detect a restart and re-attach;
        # reports carry the generation their task was dispatched under,
        # and ones referencing a task the recovered master re-queued
        # are fenced (accepted=False) instead of double-applied.
        self._journal = journal
        self.generation = int(generation)
        # Cluster telemetry: workers piggyback registry snapshots on the
        # RPCs below; the plane merges them keyed by worker id and ages
        # out workers that stop reporting (elastic resize / preemption).
        self.metrics_plane = metrics_plane or MetricsPlane()
        self._m_straggler = self.metrics_plane.registry.counter(
            "master_straggler_timeouts_total",
            "Tasks that blew the straggler deadline (factor x mean)",
        )
        self._m_reattach = self.metrics_plane.registry.counter(
            "master_worker_reattach_total",
            "Workers that re-registered after a master restart "
            "(their last-seen generation predates ours)",
        )
        self._m_fenced = self.metrics_plane.registry.counter(
            "master_fenced_requests_total",
            "RPCs rejected because this incarnation was fenced by a "
            "hot-standby takeover (split-brain guard)", ["method"],
        )
        self._lock = threading.Lock()
        self._worker_liveness: Dict[int, float] = {}
        # Workers already counted as re-attached to this generation.
        self._reattached = set()
        # Task ids already counted as stragglers (pruned against the
        # doing set so re-queued ids can be counted again).
        self._straggler_counted = set()
        # Running mean of task duration, for straggler detection
        # (reference servicer.py:107-121: default 300s until enough data).
        self._default_task_secs = task_timeout_secs
        self._task_secs_sum = 0.0
        self._task_count = 0
        # Keyed (job, task_id): per-job dispatchers number task ids
        # independently, so a bare int key would collide across jobs
        # in scheduler mode. The single-job plane uses job "".
        self._task_start_times: Dict[tuple, float] = {}
        self.model_version = 0
        # ---- live-resize barrier (docs/elasticity.md) ----------------
        # At most one pending resize: {resize_id, spec, direction,
        # expected (worker-id set), acks {worker_id: status}, t0}.
        # Directives piggyback on get_task responses (like the
        # generation fence); workers apply at a task boundary and ack
        # via report_resize; the barrier completes when every expected
        # worker acked — membership shrinks via maybe_complete_resize
        # when a worker dies mid-barrier (its replacement sees the
        # still-pending directive on its first get_task). Journaled
        # like dispatch: begin/done records survive a master crash, and
        # a recovered master re-offers the pending directive (acks are
        # volatile; the worker-side apply is idempotent by resize_id).
        self._resize: Optional[dict] = None
        self._next_resize_id = 0
        self._m_resize = self.metrics_plane.registry.counter(
            "master_resize_total",
            "Live mesh-resize barriers begun", ["direction"],
        )
        self._m_resize_pending = self.metrics_plane.registry.gauge(
            "master_resize_pending",
            "1 while a resize barrier is awaiting worker acks",
        )
        self._m_resize_barrier = self.metrics_plane.registry.histogram(
            "master_resize_barrier_seconds",
            "Resize barrier latency: begin_resize to last worker ack",
        )

    # ---- handler table -------------------------------------------------

    def handlers(self):
        return {
            "get_task": self.get_task,
            "report_task_result": self.report_task_result,
            "report_evaluation_metrics": self.report_evaluation_metrics,
            "report_version": self.report_version,
            "report_resize": self.report_resize,
            "report_metrics": self.report_metrics,
            "submit_job": self.submit_job,
            "sched_status": self.sched_status,
            "ping": lambda req: {"ok": True},
        }

    # ---- RPC handlers --------------------------------------------------

    def _ingest_metrics(self, worker_id: int, request: dict):
        snapshot = request.get("metrics")
        if snapshot:
            self.metrics_plane.ingest(worker_id, snapshot)

    def _stale_master_reject(self, method: str) -> Optional[dict]:
        """Fencing pre-check (master/journal.py hot-standby takeover):
        once a newer incarnation fenced this one, every state-mutating
        handler must reject — a zombie primary that kept dispatching
        or acking would fork the job's truth. The journal append
        itself is the authoritative guard (it re-checks under the
        flock and raises); this pre-check turns that hard error into a
        clean ``stale_master`` response workers re-resolve on."""
        if self._journal is None or not self._journal.is_fenced():
            return None
        self._m_fenced.labels(method).inc()
        logger.error(
            "FENCED: %s rejected — this master (generation %d) was "
            "superseded by a hot-standby takeover (fence generation "
            "%d); refusing to serve", method, self.generation,
            self._journal.fence_generation(),
        )
        return {"accepted": False, "fenced": True, "stale_master": True,
                "task": None, "finished": False,
                "generation": self.generation}

    def _note_worker_generation(self, worker_id: int, request: dict):
        """Re-attach detection: a worker reporting a last-seen
        generation below ours rode out a master restart."""
        seen = request.get("generation")
        if (seen is None or worker_id < 0
                # seen < 0 = a fresh worker that never attached to any
                # incarnation — an arrival, not a re-attach.
                or int(seen) < 0 or int(seen) >= self.generation):
            return
        with self._lock:
            fresh = worker_id not in self._reattached
            self._reattached.add(worker_id)
        if fresh:
            self._m_reattach.inc()
            logger.info(
                "worker %d re-attached (knew generation %s, now %d)",
                worker_id, seen, self.generation,
            )

    def get_task(self, request: dict) -> dict:
        fenced = self._stale_master_reject("get_task")
        if fenced is not None:
            return fenced
        worker_id = int(request.get("worker_id", -1))
        self._record_liveness(worker_id)
        self._ingest_metrics(worker_id, request)
        self._note_worker_generation(worker_id, request)
        extra = {}
        offer = self._resize_offer(worker_id)
        if offer is not None:
            # Piggybacked like the generation fence: WAIT responses
            # carry it too, so an idle worker still joins the barrier.
            extra["resize"] = offer
        if self._scheduler is not None:
            # Multi-job: the gang scheduler decides which job this
            # worker slot serves right now; the lease carries the job
            # id so the worker's report routes back to the same
            # dispatcher (and so a post-preemption rebinding cannot
            # mis-apply a stale report to the new job).
            job_id, disp = self._scheduler.lease_for(worker_id)
            if disp is not None:
                task = disp.get(worker_id)
                if task is not None:
                    with self._lock:
                        self._task_start_times[
                            (job_id, task.task_id)
                        ] = time.time()
                    return {"task": task.to_dict(), "finished": False,
                            "job": job_id,
                            "generation": self.generation, **extra}
            if self._scheduler.idle() and self._task_d.finished():
                return {"task": None, "finished": True,
                        "generation": self.generation, **extra}
            wait = Task(task_id=-1, type=TaskType.WAIT)
            return {"task": wait.to_dict(), "finished": False,
                    "generation": self.generation, **extra}
        task = self._task_d.get(worker_id)
        if task is not None:
            with self._lock:
                self._task_start_times[("", task.task_id)] = time.time()
            return {"task": task.to_dict(), "finished": False,
                    "generation": self.generation, **extra}
        if self._task_d.finished():
            return {"task": None, "finished": True,
                    "generation": self.generation, **extra}
        # Queue temporarily empty (doing tasks may re-queue on failure):
        # tell the worker to wait (reference servicer.py:60-68).
        wait = Task(task_id=-1, type=TaskType.WAIT)
        return {"task": wait.to_dict(), "finished": False,
                "generation": self.generation, **extra}

    def report_task_result(self, request: dict) -> dict:
        fenced = self._stale_master_reject("report_task_result")
        if fenced is not None:
            # Rejected unresolved: the worker re-resolves to the live
            # master, whose dispatcher (journal-recovered, leases
            # intact) applies it — or answers it from the resolved
            # ledger if an earlier attempt already landed there.
            return fenced
        task_id = int(request["task_id"])
        err_reason = request.get("err_reason", "")
        success = not err_reason
        worker_id = int(request.get("worker_id", -1))
        job_id = str(request.get("job", "") or "")
        self._ingest_metrics(worker_id, request)
        self._note_worker_generation(worker_id, request)
        with self._lock:
            start = self._task_start_times.pop((job_id, task_id), None)
        # Job-scoped routing: the lease carried a job id (scheduler
        # mode) and the report echoes it, so it applies to the
        # dispatcher that issued the lease even if this worker has
        # since been rebound to another gang. A done/cancelled job's
        # dispatcher still answers from its resolved ledger.
        dispatcher = self._task_d
        if job_id and self._scheduler is not None:
            routed = self._scheduler.dispatcher_of(job_id)
            if routed is None:
                return {"accepted": False, "fenced": True,
                        "generation": self.generation}
            dispatcher = routed
        # The duplicate flag is decided atomically with the report
        # application (dispatcher lock): a ledger hit means the side
        # effects below already ran on the first application — only
        # the outcome is re-sent. A pre-check here would race a
        # concurrent retry of the same report.
        task, _worker, requeued, duplicate = dispatcher.apply_report(
            task_id, success, err_reason
        )
        if (task is not None and success and start is not None
                and not duplicate):
            # First applications only: a straggler's late report (its
            # task already requeued, outcome ledger-answered) would
            # otherwise fold its pathological hold time into the mean
            # the straggler deadline derives from.
            with self._lock:
                self._task_secs_sum += time.time() - start
                self._task_count += 1
        if task is None:
            # Unknown AND not in the ledger: a report fenced to a dead
            # generation whose task the recovered master re-queued (or
            # a genuinely bogus id) — reject so the re-dispatched copy
            # is the only one that counts.
            return {"accepted": False, "fenced": True,
                    "generation": self.generation}
        # An eval task counts toward its EvaluationJob when it succeeds OR
        # fails permanently (dropped after retry cap) — otherwise one bad
        # eval shard would wedge the evaluation service forever.
        if (
            not duplicate
            and not requeued
            and task.type == TaskType.EVALUATION
            and self._eval_service is not None
        ):
            self._eval_service.complete_task(task.model_version)
        return {"accepted": True, "generation": self.generation}

    def report_evaluation_metrics(self, request: dict) -> dict:
        fenced = self._stale_master_reject("report_evaluation_metrics")
        if fenced is not None:
            return fenced
        if self._eval_service is None:
            return {"accepted": False}
        # The one handler that does real compute (metric fold over raw
        # output arrays) — span it so a slow eval fold is attributable
        # in the task timeline rather than reading as RPC time.
        outputs = request["model_outputs"]
        rows = getattr(outputs, "shape", None)
        with tracing.span(
            "eval_report", outputs=int(rows[0]) if rows else len(outputs),
        ):
            ok = self._eval_service.report_evaluation_metrics(
                outputs, request["labels"],
                # Dedup key: the fold is a plain accumulate, so a
                # retried send must not double-count its samples.
                task_id=int(request.get("task_id", -1)),
            )
        return {"accepted": ok, "generation": self.generation}

    def report_metrics(self, request: dict) -> dict:
        """Standalone-component telemetry fold-in: processes that are
        not workers (the serving router today) push their registry
        snapshots here so ``ClusterMetrics`` — and the time-series
        store sampling it — see the whole fleet, not just the training
        tier. Keyed ``<component>-<id>`` (e.g. ``router-0``) in the
        cluster view; the same TTL aging applies, so a router that
        stops reporting leaves ``/metrics`` and its series go stale."""
        component = str(request.get("component", "") or "")
        if not component or any(
            c in component for c in ("/", "\\", "\n", '"')
        ):
            return {"accepted": False,
                    "generation": self.generation}
        component_id = int(request.get("component_id", 0))
        snapshot = request.get("metrics")
        if snapshot:
            # Shape gate: a version-skewed reporter's malformed
            # snapshot must be rejected here, not stored to crash the
            # sampler on the next master tick.
            if not self._valid_snapshot(snapshot):
                return {"accepted": False,
                        "generation": self.generation}
            self.metrics_plane.ingest(
                f"{component}-{component_id}", snapshot
            )
        return {"accepted": True, "generation": self.generation}

    # ---- multi-job control (master/scheduler.py) -----------------------

    def submit_job(self, request: dict) -> dict:
        """Admit a job into the gang scheduler's table. Fenced like
        every state mutator: a zombie primary must not grow the job
        table (the submit journals BEFORE the table mutates, so even
        a fence that lands mid-handler aborts cleanly)."""
        fenced = self._stale_master_reject("submit_job")
        if fenced is not None:
            return fenced
        if self._scheduler is None:
            return {"accepted": False, "error": "scheduler disabled",
                    "generation": self.generation}
        job_id = str(request.get("job", "") or "")
        try:
            entry = self._scheduler.submit(
                job_id,
                spec=request.get("spec") or {},
                priority=int(request.get("priority", 0)),
                gang_size=int(request.get("gang_size", 1)),
            )
        except ValueError as exc:
            return {"accepted": False, "error": str(exc),
                    "generation": self.generation}
        return {"accepted": True, "job": job_id,
                "state": entry["state"],
                "generation": self.generation}

    def sched_status(self, request: dict) -> dict:
        """Job-table read for clients (``dump_metrics --sched`` talks
        to the HTTP ``/sched`` route; this is the RPC twin). Reads are
        not fenced — a stale table is labeled, not hidden."""
        if self._scheduler is None:
            return {"enabled": False, "generation": self.generation}
        out = self._scheduler.render()
        out["enabled"] = True
        out["generation"] = self.generation
        out["fenced"] = bool(
            self._journal is not None and self._journal.is_fenced()
        )
        return out

    @staticmethod
    def _valid_snapshot(snapshot) -> bool:
        if not isinstance(snapshot, dict):
            return False
        families = snapshot.get("families", [])
        if not isinstance(families, list):
            return False
        for family in families:
            if not isinstance(family, dict):
                return False
            if not isinstance(family.get("series", []), list):
                return False
            if not all(isinstance(s, dict)
                       for s in family.get("series", [])):
                return False
        return True

    def report_version(self, request: dict) -> dict:
        fenced = self._stale_master_reject("report_version")
        if fenced is not None:
            return fenced
        version = int(request["model_version"])
        worker_id = int(request.get("worker_id", -1))
        self._record_liveness(worker_id)
        self._ingest_metrics(worker_id, request)
        with self._lock:
            advanced = version > self.model_version
            self.model_version = max(self.model_version, version)
        if advanced and self._journal is not None:
            # Model-version high-water mark: recovery re-arms eval
            # triggering and TensorBoard publishing from it. The
            # worker id rides along so replay also restores the
            # dispatcher's per-worker version map (SSP bookkeeping).
            self._journal.append(
                "version", model_version=version,
                worker_id=int(worker_id),
            )
        self._task_d.record_worker_version(worker_id, version)
        if self._eval_service is not None:
            self._eval_service.add_evaluation_task_if_needed(version)
        return {"ok": True, "generation": self.generation}

    # ---- live-resize barrier (docs/elasticity.md) ----------------------

    def begin_resize(self, spec: dict, direction: str = "resize",
                     expected_workers=None) -> int:
        """Open a resize barrier: offer ``spec`` (parallel/reshard.py
        ``mesh_spec`` dict) to every worker on its next get_task.
        ``expected_workers`` seeds the barrier membership (defaults to
        every worker the servicer has seen alive); the autoscaler tick
        refreshes membership via ``maybe_complete_resize`` so a worker
        killed mid-barrier cannot wedge it. Raises if a barrier is
        already pending — resizes are serialized by design (two
        in-flight target meshes would race on the workers)."""
        with self._lock:
            if self._resize is not None:
                raise RuntimeError(
                    f"resize {self._resize['resize_id']} is still "
                    "pending; one barrier at a time"
                )
            self._next_resize_id += 1
            resize_id = self._next_resize_id
            if expected_workers is None:
                expected_workers = list(self._worker_liveness)
            expected = {int(w) for w in expected_workers}
            self._resize = {
                "resize_id": resize_id,
                "spec": dict(spec),
                "direction": str(direction),
                "expected": expected,
                "acks": {},
                "t0": time.monotonic(),
            }
            if self._journal is not None:
                # Inside the lock: a fast ack's done record must not
                # land before this begin record.
                self._journal.append(
                    "resize", resize_id=int(resize_id), spec=dict(spec),
                    direction=str(direction), done=False,
                )
            # Pending gauge set under the lock too: a worker ack on a
            # server thread can complete the barrier the instant the
            # lock drops, and its set(0) must not be overwritten by a
            # late set(1) here.
            self._m_resize_pending.set(1.0)
        self._m_resize.labels(str(direction)).inc()
        logger.info(
            "resize %d (%s) begun: %s, awaiting %s",
            resize_id, direction, spec, sorted(expected),
        )
        return resize_id

    def rearm_resize(self, record: dict):
        """Master-restart recovery: re-open the journaled pending
        barrier. Acks are volatile (they died with the old master), so
        the directive is re-offered to everyone; workers that already
        applied it re-ack idempotently by resize_id. Membership is
        UNKNOWN (``expected=None``) until the run-loop tick supplies
        the live worker set — ack-driven completion is disabled so the
        first re-ack cannot complete a fleet-wide barrier while peers
        still await the re-offer."""
        with self._lock:
            resize_id = int(record["resize_id"])
            self._next_resize_id = max(self._next_resize_id, resize_id)
            self._resize = {
                "resize_id": resize_id,
                "spec": dict(record["spec"]),
                "direction": str(record.get("direction", "resize")),
                "expected": None,  # unknown until the tick refreshes
                "acks": {},
                "t0": time.monotonic(),
            }
            self._m_resize_pending.set(1.0)
        logger.info("re-armed pending resize %d after master restart",
                    resize_id)

    def _resize_offer(self, worker_id: int) -> Optional[dict]:
        with self._lock:
            pending = self._resize
            if pending is None or worker_id in pending["acks"]:
                return None
            return {"resize_id": pending["resize_id"],
                    "spec": dict(pending["spec"])}

    def report_resize(self, request: dict) -> dict:
        """A worker finished applying (or noop-acked) a resize
        directive. Fenced by resize_id: an ack for anything but the
        pending barrier is rejected, so a late ack from before a master
        restart or a superseded resize cannot complete the wrong one."""
        fenced = self._stale_master_reject("report_resize")
        if fenced is not None:
            return fenced
        worker_id = int(request.get("worker_id", -1))
        resize_id = int(request.get("resize_id", -1))
        self._record_liveness(worker_id)
        self._ingest_metrics(worker_id, request)
        self._note_worker_generation(worker_id, request)
        with self._lock:
            pending = self._resize
            if pending is None or pending["resize_id"] != resize_id:
                return {"accepted": False, "fenced": True,
                        "generation": self.generation}
            pending["acks"][worker_id] = str(
                request.get("status", "applied")
            )
            # A worker that arrived after begin (elastic relaunch)
            # joins the membership by acking; a re-armed barrier's
            # membership stays unknown until the tick supplies it.
            if pending["expected"] is not None:
                pending["expected"].add(worker_id)
        self.maybe_complete_resize()
        return {"accepted": True, "generation": self.generation}

    def maybe_complete_resize(self, live_workers=None) -> Optional[dict]:
        """Complete the barrier iff every expected worker has acked.
        Pass the CURRENT live worker set to shrink membership after a
        mid-barrier death (the autoscaler tick / drill does); with no
        argument the membership recorded at begin (plus late joiners)
        decides, and a re-armed barrier (membership unknown) never
        completes. Returns the completed barrier dict or None."""
        with self._lock:
            pending = self._resize
            if pending is None:
                return None
            if live_workers is not None:
                # Membership from the live fleet. An EMPTY live set
                # completes the barrier: everyone who could apply is
                # gone (job drained mid-barrier) — leaving it pending
                # would wedge resize_status()/begin_resize forever.
                expected = {int(w) for w in live_workers}
            else:
                expected = pending["expected"]
                if not expected:
                    # Begin-time membership unknown (re-armed barrier)
                    # or empty: only the tick's live set may decide.
                    return None
            if expected - set(pending["acks"]):
                return None
            self._resize = None
            elapsed = time.monotonic() - pending["t0"]
            if self._journal is not None:
                # Inside the lock, like begin: the done record must not
                # be reorderable against a concurrent begin's record.
                self._journal.append(
                    "resize", resize_id=int(pending["resize_id"]),
                    spec=dict(pending["spec"]),
                    direction=str(pending["direction"]), done=True,
                )
            self._m_resize_pending.set(0.0)
        pending["barrier_seconds"] = elapsed
        self._m_resize_barrier.observe(elapsed)
        logger.info(
            "resize %d (%s) complete: %d ack(s) in %.3fs",
            pending["resize_id"], pending["direction"],
            len(pending["acks"]), elapsed,
        )
        return pending

    def resize_status(self) -> Optional[dict]:
        """Pending barrier (copy) or None — for the autoscaler tick
        and tests."""
        with self._lock:
            if self._resize is None:
                return None
            out = dict(self._resize)
            out["acks"] = dict(out["acks"])
            if out["expected"] is not None:
                out["expected"] = set(out["expected"])
            return out

    # ---- liveness / straggler detection --------------------------------

    def _record_liveness(self, worker_id: int):
        if worker_id >= 0:
            with self._lock:
                self._worker_liveness[worker_id] = time.time()

    def worker_liveness(self) -> Dict[int, float]:
        with self._lock:
            return dict(self._worker_liveness)

    def average_task_secs(self) -> float:
        with self._lock:
            if self._task_count < 3:
                return self._default_task_secs
            return self._task_secs_sum / self._task_count

    def find_timeout_tasks(self, factor: float = 3.0):
        """(task_id, worker_id) pairs running > factor × mean task time
        (reference master.py:487-509 _check_timeout_tasks)."""
        threshold = factor * self.average_task_secs()
        now = time.time()
        out = []
        # Composite (job, task_id) keys: in scheduler mode the scan
        # covers every gang currently holding slots, and per-job task
        # ids collide across dispatchers.
        doing = {
            ("", tid): v
            for tid, v in self._task_d.doing_start_times().items()
        }
        if self._scheduler is not None:
            for job_id, disp in (
                self._scheduler.active_dispatchers().items()
            ):
                if disp is self._task_d:
                    continue
                for tid, v in disp.doing_start_times().items():
                    doing[(job_id, tid)] = v
        for key, (worker_id, start) in doing.items():
            if now - start > threshold:
                out.append((key, worker_id))
        with self._lock:
            # Count each straggling task once, not once per poll tick —
            # in k8s mode kill_worker recovery is async (the pod DELETED
            # watch event), so a timed-out task stays in the doing set
            # for several ticks before it is re-queued.
            self._straggler_counted &= set(doing)
            fresh = [k for k, _w in out if k not in self._straggler_counted]
            self._straggler_counted.update(fresh)
        if fresh:
            self._m_straggler.inc(len(fresh))
        # Callers act on (task_id, worker_id) — kill_worker only needs
        # the worker; the job scoping above is for dedup correctness.
        return [(key[1], worker_id) for key, worker_id in out]

    def seed_task_start_times(self, task_ids):
        """Recovery: start the straggler clock now for every lease
        that survived the master crash (the pre-crash start times died
        with the old process; counting from recovery avoids instantly
        timing out every surviving worker). Bare ints seed the
        single-job plane (job ""); (job, task_id) pairs seed a
        scheduler job's leases."""
        now = time.time()
        with self._lock:
            for tid in task_ids:
                if isinstance(tid, (tuple, list)):
                    job_id, raw = tid
                    self._task_start_times[
                        (str(job_id), int(raw))
                    ] = now
                else:
                    self._task_start_times[("", int(tid))] = now

    def remove_worker_metrics(self, worker_id: int):
        """Drop a departed worker from the cluster view immediately
        (recovery / elastic scale-down path) instead of waiting for the
        report TTL — and from the time-series store, so a deliberate
        removal never reads as an absence-rule breach."""
        self.metrics_plane.remove_worker(worker_id)
        with self._lock:
            self._worker_liveness.pop(worker_id, None)
