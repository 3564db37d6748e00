"""Multi-tenant gang scheduler: many jobs on one elastic fleet (copy of
elasticdl_tpu/master/scheduler.py; the port keeps its own, and journals
the same ``sched`` records).

Every plane below this one is single-job by construction — the
dispatcher hands shards of ONE job to workers, the autoscaler sizes
ONE gang, the journal event-sources ONE control plane. This module
turns the master into a multi-job arbiter (the resource-allocation
shape of Podracer's multi-workload orchestration and the cluster
half of the MPMD pipeline scheduler; PAPERS.md):

- **Job table** — ``{job_id: spec, priority, gang_size, lifecycle
  state, preemption count}`` with the state machine ``submitted ->
  scheduled -> running -> (preempted -> scheduled -> running)* ->
  done`` (``cancel`` exits any non-terminal state). Every transition
  is event-sourced onto the master journal as a ``sched`` record
  (master/journal.py), so the table survives failover, warm-replays
  into the hot standby, and a fenced zombie cannot mutate it — its
  append raises ``JournalFencedError`` before any byte lands.
- **Gang scheduling** — a job runs only when its whole gang fits:
  each tick re-derives the allocation from scratch (priority-ordered
  first-fit over the live slot count), so fleet growth and shrink
  (the autoscaler's doing) re-arbitrate automatically.
- **Priority preemption** — a higher-priority job that cannot fit
  evicts the lowest-priority running gang: ``preempt`` = the job's
  ``checkpoint_now`` callback (the existing checkpoint chain), then a
  journaled preemption record, then the gang's leases hand back
  through the dispatcher's graceful-preemption path (retry budgets
  untouched, resolved-ledger idempotence intact — exactly-once
  accounting across the eviction). ``resume`` = the restore chain +
  push-WAL tail replay, both existing paths, via the job's resume
  callback.
- **Fair share** — among equal priorities the arbiter orders by the
  usage plane's per-job share (``/usage``): the job that has
  consumed the least fleet time schedules first, so back-to-back
  equal-priority jobs converge toward equal shares instead of
  first-come-forever.

Workers bind to jobs lazily (``lease_for``): a worker slot asking for
work is bound to the allocated job with the emptiest gang, and the
binding drops when the job is preempted or done — the fleet is shared
capacity, not per-job silos. ``chaos/sched_drill.py`` is the
adversarial proof and ``tools/check_sched.py`` its fsck.
"""

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("scheduler")

# Lifecycle states (journal fold: master/journal.py apply_sched_record).
SUBMITTED = "submitted"
SCHEDULED = "scheduled"
RUNNING = "running"
PREEMPTED = "preempted"
DONE = "done"
CANCELLED = "cancelled"

ACTIVE_STATES = (SCHEDULED, RUNNING)
WAITING_STATES = (SUBMITTED, PREEMPTED)
TERMINAL_STATES = (DONE, CANCELLED)


def default_dispatcher_factory(spec: dict):
    """Build a ``TaskDispatcher`` from a submitted job spec:
    ``{"shards": {name: [start, end]}, "records_per_task": int,
    "num_epochs": int}`` — the portable subset a journal-replayed
    table can rebuild on any incarnation. A streaming job declares
    ``{"stream": true}`` instead of shards: its task queue comes from
    the live tail, so the rebuilt
    dispatcher starts empty in streaming mode and the journal's STREAM
    records / the re-bound ingestor repopulate it."""
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher

    if spec.get("stream"):
        return TaskDispatcher(
            training_shards={},
            records_per_task=int(spec.get("records_per_task", 1)),
            shuffle=False,
            seed=int(spec.get("seed", 0)),
            streaming=True,
        )
    shards = {
        str(name): (int(lo), int(hi))
        for name, (lo, hi) in (spec.get("shards") or {}).items()
    }
    if not shards:
        raise ValueError("job spec has no shards")
    return TaskDispatcher(
        training_shards=shards,
        records_per_task=int(spec.get("records_per_task", 1)),
        num_epochs=int(spec.get("num_epochs", 1)),
        shuffle=False,
        seed=int(spec.get("seed", 0)),
    )


class GangScheduler:
    """The job table + arbiter. Thread-safe: ``tick`` runs on the
    master loop, ``lease_for``/``dispatcher_of`` on RPC threads,
    ``submit`` on either."""

    def __init__(
        self,
        slots_fn: Callable[[], int],
        journal=None,
        dispatcher_factory: Optional[Callable[[dict], object]] = None,
        usage_fn: Optional[Callable[[], dict]] = None,
        registry=None,
    ):
        from elasticdl_tpu_torch.observability import default_registry

        self._slots_fn = slots_fn
        self._journal = journal
        self._factory = dispatcher_factory or default_dispatcher_factory
        self._usage_fn = usage_fn
        self._lock = threading.RLock()
        # job table: {job_id: entry dict} — same shape the journal
        # fold produces (apply_sched_record), plus volatile fields the
        # journal deliberately omits (dispatcher, callbacks, bindings).
        self._jobs: Dict[str, dict] = {}
        self._dispatchers: Dict[str, object] = {}
        self._preempt_cbs: Dict[str, Callable] = {}
        self._resume_cbs: Dict[str, Callable] = {}
        self._submit_seq: Dict[str, int] = {}
        self._next_seq = 0
        self._alloc: Dict[str, int] = {}   # job -> allocated slots
        self._bound: Dict[int, str] = {}   # worker_id -> job
        self.preemptions = 0
        registry = registry or default_registry()
        self._m_jobs = registry.gauge(
            "sched_jobs", "Jobs in the gang scheduler's table, "
            "by lifecycle state", ["state"],
        )
        self._m_preempt = registry.counter(
            "sched_preemptions_total",
            "Gang evictions by a higher-priority job",
        )
        self._m_slots_total = registry.gauge(
            "sched_slots_total", "Worker slots the arbiter sees",
        )
        self._m_slots_alloc = registry.gauge(
            "sched_slots_allocated",
            "Worker slots currently allocated to gangs",
        )

    # ---- journal plumbing ----------------------------------------------

    def _journal_event(self, event: str, job: str, **fields):
        if self._journal is not None:
            # JournalFencedError propagates: a fenced incarnation must
            # not mutate the table (the servicer's pre-check turns it
            # into a clean stale_master response first).
            self._journal.append("sched", event=event, job=job,
                                 **fields)

    # ---- submission -----------------------------------------------------

    def submit(self, job_id: str, spec: Optional[dict] = None,
               priority: int = 0, gang_size: int = 1,
               dispatcher=None,
               preempt_cb: Optional[Callable] = None,
               resume_cb: Optional[Callable] = None) -> dict:
        """Add a job. ``dispatcher`` (optional) serves the job's tasks
        directly; without it the spec must carry enough to build one
        (``default_dispatcher_factory``). Journals the submission
        BEFORE the table mutates — a fenced zombie's submit must leave
        no trace."""
        job_id = str(job_id)
        if not job_id:
            raise ValueError("job_id must be non-empty")
        spec = dict(spec or {})
        with self._lock:
            existing = self._jobs.get(job_id)
            if existing is not None and (
                existing["state"] not in TERMINAL_STATES
            ):
                raise ValueError(f"job {job_id!r} already active")
            self._journal_event("submit", job_id, spec=spec,
                                priority=int(priority),
                                gang_size=int(gang_size))
            self._jobs[job_id] = {
                "spec": spec,
                "priority": int(priority),
                "gang_size": max(1, int(gang_size)),
                "state": SUBMITTED,
                "preemptions": 0,
            }
            if dispatcher is not None:
                self._dispatchers[job_id] = dispatcher
            if preempt_cb is not None:
                self._preempt_cbs[job_id] = preempt_cb
            if resume_cb is not None:
                self._resume_cbs[job_id] = resume_cb
            self._submit_seq[job_id] = self._next_seq
            self._next_seq += 1
            logger.info(
                "job %s submitted (priority %d, gang %d)",
                job_id, int(priority), int(gang_size),
            )
            return dict(self._jobs[job_id])

    def cancel(self, job_id: str) -> bool:
        job_id = str(job_id)
        with self._lock:
            entry = self._jobs.get(job_id)
            if entry is None or entry["state"] in TERMINAL_STATES:
                return False
            self._journal_event("cancel", job_id)
            entry["state"] = CANCELLED
            self._release_locked(job_id)
            return True

    def restore(self, sched_state: Optional[dict]):
        """Re-arm from a replay carry's ``sched`` fold (cold recovery
        or warm standby takeover). Jobs the journal saw in flight
        (scheduled/running) come back as PREEMPTED: their gang died
        with the old incarnation, and the resume path — restore chain
        + WAL tail replay — is exactly the preemption contract. Their
        journaled preemption counts are preserved; the demotion
        itself is NOT journaled (replay must stay idempotent — the
        next tick's resume record captures the restart)."""
        if not sched_state:
            return
        with self._lock:
            for job_id, entry in (sched_state.get("jobs") or {}).items():
                job_id = str(job_id)
                restored = {
                    "spec": dict(entry.get("spec") or {}),
                    "priority": int(entry.get("priority", 0)),
                    "gang_size": max(1, int(entry.get("gang_size", 1))),
                    "state": str(entry.get("state", SUBMITTED)),
                    "preemptions": int(entry.get("preemptions", 0)),
                }
                if restored["state"] in ACTIVE_STATES:
                    restored["state"] = PREEMPTED
                self._jobs[job_id] = restored
                self._submit_seq.setdefault(job_id, self._next_seq)
                self._next_seq += 1
            self.preemptions = int(sched_state.get("preemptions", 0))

    def bind_job(self, job_id: str, dispatcher=None,
                 preempt_cb: Optional[Callable] = None,
                 resume_cb: Optional[Callable] = None):
        """Attach volatile per-job machinery (dispatcher, checkpoint
        callbacks) to a restored table entry — the journal carries
        the durable half only."""
        job_id = str(job_id)
        with self._lock:
            if dispatcher is not None:
                self._dispatchers[job_id] = dispatcher
            if preempt_cb is not None:
                self._preempt_cbs[job_id] = preempt_cb
            if resume_cb is not None:
                self._resume_cbs[job_id] = resume_cb

    # ---- fair share ------------------------------------------------------

    def _job_shares(self) -> Dict[str, float]:
        """Per-job consumed share from the usage plane: the mean of
        the share axes the ``/usage`` summary reports for principals
        carrying this job label. Missing plane or job -> 0.0 (never
        scheduled = most deserving)."""
        if self._usage_fn is None:
            return {}
        try:
            usage = self._usage_fn() or {}
        except Exception:
            logger.exception("usage_fn failed; fair share degraded")
            return {}
        shares: Dict[str, float] = {}
        for row in usage.get("principals") or []:
            who = row.get("principal") or {}
            job = str(who.get("job", ""))
            share = row.get("share") or {}
            values = [float(v) for v in share.values()]
            if not values:
                continue
            mean = sum(values) / len(values)
            shares[job] = max(shares.get(job, 0.0), mean)
        return shares

    # ---- arbitration -----------------------------------------------------

    def tick(self) -> List[str]:
        """One arbitration pass; returns the transitions made (for
        logs/drills), e.g. ``["done:a", "preempt:b", "schedule:c"]``.
        Never raises except ``JournalFencedError`` (a fenced arbiter
        must stop, not continue on stale state)."""
        actions: List[str] = []
        shares = self._job_shares()
        with self._lock:
            slots = max(0, int(self._slots_fn()))
            # 1. Completion sweep: a job whose dispatcher drained is
            # done — journal it and free the gang.
            for job_id, entry in list(self._jobs.items()):
                if entry["state"] not in ACTIVE_STATES:
                    continue
                disp = self._dispatchers.get(job_id)
                if disp is not None and disp.finished():
                    self._journal_event("done", job_id)
                    entry["state"] = DONE
                    self._release_locked(job_id)
                    actions.append(f"done:{job_id}")
                    logger.info("job %s done", job_id)
            # 2. Target allocation from scratch: priority first, then
            # least consumed share (fair share), then submit order.
            candidates = [
                (job_id, entry)
                for job_id, entry in self._jobs.items()
                if entry["state"] in ACTIVE_STATES + WAITING_STATES
            ]
            candidates.sort(key=lambda kv: (
                -kv[1]["priority"],
                shares.get(kv[0], 0.0),
                self._submit_seq.get(kv[0], 0),
            ))
            target: Dict[str, int] = {}
            free = slots
            for job_id, entry in candidates:
                gang = entry["gang_size"]
                if gang <= free:
                    target[job_id] = gang
                    free -= gang
            # 3. Evict active gangs that lost their allocation
            # (checkpoint -> journal -> release leases -> unbind).
            for job_id, entry in self._jobs.items():
                if entry["state"] in ACTIVE_STATES and (
                    job_id not in target
                ):
                    self._preempt_locked(job_id, entry)
                    actions.append(f"preempt:{job_id}")
            # 4. Admit waiting gangs that won one (build/rebind the
            # dispatcher, journal schedule/resume).
            for job_id in target:
                entry = self._jobs[job_id]
                if entry["state"] not in WAITING_STATES:
                    continue
                resuming = entry["state"] == PREEMPTED
                if job_id not in self._dispatchers:
                    try:
                        self._dispatchers[job_id] = self._factory(
                            entry["spec"]
                        )
                    except Exception:
                        logger.exception(
                            "job %s: dispatcher build failed; "
                            "cancelling", job_id,
                        )
                        self._journal_event("cancel", job_id)
                        entry["state"] = CANCELLED
                        continue
                self._journal_event(
                    "resume" if resuming else "schedule", job_id
                )
                entry["state"] = SCHEDULED
                if resuming:
                    cb = self._resume_cbs.get(job_id)
                    if cb is not None:
                        cb(job_id, entry)
                actions.append(
                    f"{'resume' if resuming else 'schedule'}:{job_id}"
                )
                logger.info(
                    "job %s %s (%d slot(s))", job_id,
                    "resumed" if resuming else "scheduled",
                    target[job_id],
                )
            # 5. Promote scheduled -> running (the gang holds its
            # slots from this tick on).
            for job_id in target:
                entry = self._jobs[job_id]
                if entry["state"] == SCHEDULED:
                    self._journal_event("run", job_id)
                    entry["state"] = RUNNING
                    actions.append(f"run:{job_id}")
            self._alloc = target
            # Drop bindings to jobs that no longer hold slots.
            for worker_id, job_id in list(self._bound.items()):
                if job_id not in target:
                    del self._bound[worker_id]
            self._m_slots_total.set(float(slots))
            self._m_slots_alloc.set(float(slots - free))
            counts: Dict[str, int] = {}
            for entry in self._jobs.values():
                counts[entry["state"]] = counts.get(
                    entry["state"], 0
                ) + 1
            for state in (SUBMITTED, SCHEDULED, RUNNING, PREEMPTED,
                          DONE, CANCELLED):
                self._m_jobs.labels(state).set(
                    float(counts.get(state, 0))
                )
        return actions

    def _preempt_locked(self, job_id: str, entry: dict):
        """checkpoint_now -> journal the preemption -> release the
        gang's leases through the dispatcher's graceful-preemption
        path -> unbind its workers. The checkpoint runs FIRST: once
        the preemption record is durable the gang may be reassigned
        immediately, and the job's next life must restore everything
        it had."""
        cb = self._preempt_cbs.get(job_id)
        if cb is not None:
            cb(job_id, entry)
        self._journal_event("preempt", job_id)
        entry["state"] = PREEMPTED
        entry["preemptions"] = int(entry.get("preemptions", 0)) + 1
        self.preemptions += 1
        self._m_preempt.inc()
        disp = self._dispatchers.get(job_id)
        if disp is not None:
            handed_back = disp.preempt_leases(
                f"preempted: gang released ({job_id})"
            )
            if handed_back:
                logger.info(
                    "job %s: %d leased task(s) handed back on "
                    "preemption", job_id, handed_back,
                )
        self._release_locked(job_id)
        logger.warning(
            "job %s preempted (count %d)", job_id,
            entry["preemptions"],
        )

    def _release_locked(self, job_id: str):
        self._alloc.pop(job_id, None)
        for worker_id, bound in list(self._bound.items()):
            if bound == job_id:
                del self._bound[worker_id]

    # ---- worker-facing (RPC threads) ------------------------------------

    def lease_for(self, worker_id: int) -> Tuple[Optional[str], object]:
        """The job this worker slot serves right now: its existing
        binding while that job still holds slots, else the allocated
        job with the emptiest gang. ``(None, None)`` = no allocated
        job wants a worker — the servicer answers WAIT."""
        worker_id = int(worker_id)
        with self._lock:
            job_id = self._bound.get(worker_id)
            if job_id is not None and job_id in self._alloc:
                return job_id, self._dispatchers.get(job_id)
            bound_counts: Dict[str, int] = {}
            for bound in self._bound.values():
                bound_counts[bound] = bound_counts.get(bound, 0) + 1
            best = None
            best_gap = 0
            for job_id, slots in self._alloc.items():
                gap = slots - bound_counts.get(job_id, 0)
                if gap > best_gap:
                    best, best_gap = job_id, gap
            if best is None:
                return None, None
            self._bound[worker_id] = best
            return best, self._dispatchers.get(best)

    def dispatcher_of(self, job_id: str):
        with self._lock:
            return self._dispatchers.get(str(job_id))

    def active_dispatchers(self) -> Dict[str, object]:
        """{job_id: dispatcher} for jobs currently holding slots —
        the servicer's straggler scan walks these next to the
        primary dispatcher."""
        with self._lock:
            return {
                job_id: self._dispatchers[job_id]
                for job_id in self._alloc
                if job_id in self._dispatchers
            }

    def idle(self) -> bool:
        """True when no job needs the fleet (all terminal)."""
        with self._lock:
            return all(
                entry["state"] in TERMINAL_STATES
                for entry in self._jobs.values()
            )

    def job_state(self, job_id: str) -> Optional[str]:
        with self._lock:
            entry = self._jobs.get(str(job_id))
            return entry["state"] if entry else None

    # ---- export (journal snapshot provider / endpoint) -------------------

    def export_state(self) -> dict:
        """The durable half of the table — same shape as the journal
        fold (``new_sched_state``)."""
        with self._lock:
            return {
                "jobs": {
                    job_id: {
                        "spec": dict(entry["spec"]),
                        "priority": entry["priority"],
                        "gang_size": entry["gang_size"],
                        "state": entry["state"],
                        "preemptions": entry["preemptions"],
                    }
                    for job_id, entry in self._jobs.items()
                },
                "preemptions": int(self.preemptions),
            }

    def render(self) -> dict:
        """The ``/sched`` endpoint body: job table + allocation +
        fair-share target vs consumed share."""
        shares = self._job_shares()
        with self._lock:
            slots = max(0, int(self._slots_fn()))
            jobs = {}
            bound_counts: Dict[str, int] = {}
            for bound in self._bound.values():
                bound_counts[bound] = bound_counts.get(bound, 0) + 1
            active = [
                e for e in self._jobs.values()
                if e["state"] in ACTIVE_STATES + WAITING_STATES
            ]
            fair = 1.0 / len(active) if active else 0.0
            for job_id, entry in self._jobs.items():
                disp = self._dispatchers.get(job_id)
                todo, doing = (
                    disp.queue_depths() if disp is not None else (0, 0)
                )
                jobs[job_id] = {
                    "priority": entry["priority"],
                    "gang_size": entry["gang_size"],
                    "state": entry["state"],
                    "preemptions": entry["preemptions"],
                    "allocated_slots": self._alloc.get(job_id, 0),
                    "bound_workers": bound_counts.get(job_id, 0),
                    "todo": todo,
                    "doing": doing,
                    "usage_share": shares.get(job_id, 0.0),
                    "fair_share": (
                        fair if entry["state"] not in TERMINAL_STATES
                        else 0.0
                    ),
                }
            return {
                "slots": {
                    "total": slots,
                    "allocated": sum(self._alloc.values()),
                },
                "preemptions": int(self.preemptions),
                "jobs": jobs,
                "now": time.time(),
            }
