"""Gang-scheduler drill (port of elasticdl_tpu/chaos/sched_drill.py):
two jobs on ONE elastic fleet, with a live priority preemption — and
nobody's state may smear.

``python -m elasticdl_tpu_torch.chaos.sched_drill --workdir DIR
[--report PATH]`` (exit 0 only if every gate holds):

One shared fleet (two worker slots + a 2-shard row service with the
write-ahead push log attached) runs two jobs through a real
``GangScheduler`` journaling onto a real ``MasterJournal``, leases
routed by a real ``MasterServicer`` in multi-job mode:

1. ``batch-lo`` (priority 1, gang 2) is submitted and starts running.
2. After ``PREEMPT_AFTER`` of its tasks land, ``prio-hi`` (priority
   10, gang 2) arrives via the ``submit_job`` RPC — the next
   scheduler tick preempts the batch job: its preempt callback
   checkpoints the dense model, ``preempt_leases`` hands the
   in-flight leases back (retry budgets untouched), and the drill
   kills the workers' pending applies the way a deleted pod would —
   side effects of a revoked lease never land.
3. ``prio-hi`` runs to completion on the whole fleet and journals
   ``done``; the next tick resumes ``batch-lo`` — its resume callback
   restores the dense model from the preemption checkpoint — and the
   batch job finishes on the slots it got back.

Each job owns a dense model vector plus its own embedding table on
the SHARED row service (plain SGD: per-row updates commute, and every
row id is pushed exactly once per job with exactly-representable
values — so any correct schedule is byte-identical to a solo run; a
lost or doubled task is not).

Gates (all must hold, else exit nonzero):

- **Isolation** — both jobs' final dense models AND row tables are
  byte-equal to solo control runs of the same job alone on a fresh
  fleet. A preemption that loses or double-applies work shows up
  here first.
- **Exactly-once** — every task of both jobs applied exactly once
  (the preempted in-flight leases were dropped un-applied and re-ran
  after resume; at least one such handback actually happened).
- **Lifecycle** — the journal's ``sched`` fold replays to both jobs
  ``done`` with exactly one recorded preemption of ``batch-lo``, and
  a cold fold over ``read_records`` agrees (the standby would wake
  with this exact table).
- **Fsck** — the port's ``tools/check_journal.py`` over the master
  journal and ``tools/check_pushlog.py`` over every shard's WAL come
  back clean.

Report is validated by ``elasticdl_tpu_torch/tools/check_sched.py``.
"""

import argparse
import json
import os
import sys

import numpy as np

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("sched_drill")

DENSE_DIM = 16
ROW_DIM = 4
ROWS_PER_TASK = 8      # records per task == rows per task (1:1)
SLOTS = 2              # worker slots on the shared fleet
LR = 0.5               # exactly representable: updates stay exact

LO_JOB = "batch-lo"    # priority 1, the long batch job
HI_JOB = "prio-hi"     # priority 10, the preemptor
LO_TASKS = 12
HI_TASKS = 6
PREEMPT_AFTER = 4      # lo tasks applied before hi is submitted
MAX_STEPS = 400        # scheduler/worker loop iterations before giving up

_TABLES = {LO_JOB: "rows_batch_lo", HI_JOB: "rows_prio_hi"}
_NTASKS = {LO_JOB: LO_TASKS, HI_JOB: HI_TASKS}
_SALT = {LO_JOB: 3, HI_JOB: 11}


def _job_spec(job: str) -> dict:
    """Spec the scheduler's default dispatcher factory understands:
    one shard, fixed-size tasks, no shuffle — task k covers rows
    ``[k*ROWS_PER_TASK, (k+1)*ROWS_PER_TASK)``."""
    return {
        "shards": {"data": [0, _NTASKS[job] * ROWS_PER_TASK]},
        "records_per_task": ROWS_PER_TASK,
        "num_epochs": 1,
        "seed": 0,
    }


def _row_ids(start: int, end: int) -> np.ndarray:
    """Row ids for record range [start, end): strided so the drill's
    small vocab spreads across the WHOLE bucket space (ids fold into
    buckets by ``id % NUM_BUCKETS``; consecutive small ints would all
    land on shard 0 and never exercise the second shard's WAL)."""
    from elasticdl_tpu_torch.embedding.shard_map import NUM_BUCKETS

    stride = NUM_BUCKETS // (LO_TASKS * ROWS_PER_TASK)
    return np.arange(start, end, dtype=np.int64) * stride


def _task_grads(job: str, start: int, end: int):
    """Deterministic, exactly-representable push for one task: small
    integers, so SGD's ``row - lr*grad`` is exact and the final table
    depends only on WHICH pushes landed, never on their order."""
    rows = np.arange(start, end, dtype=np.int64)
    base = rows[:, None] * ROW_DIM + np.arange(ROW_DIM)[None, :]
    return _row_ids(start, end), ((base + _SALT[job]) % 64).astype(
        np.float32
    )


def _task_dense(job: str, start: int) -> np.ndarray:
    """The task's dense-model contribution — small integers again, so
    the (commutative) float32 sum is exact in any apply order."""
    return (
        (np.arange(DENSE_DIM) + start + _SALT[job]) % 32
    ).astype(np.float32)


class _Fleet:
    """One run's row-service shards (both jobs' tables on every
    shard, WAL attached) + remote engine."""

    def __init__(self, root: str):
        from elasticdl_tpu_torch.embedding.optimizer import (
            SGD,
            HostOptimizerWrapper,
        )
        from elasticdl_tpu_torch.embedding.row_service import HostRowService
        from elasticdl_tpu_torch.embedding.table import EmbeddingTable

        self.root = root
        self.wal_dirs = []
        self.shards = []
        for i in range(2):
            svc = HostRowService(
                {t: EmbeddingTable(t, ROW_DIM)
                 for t in _TABLES.values()},
                HostOptimizerWrapper(SGD(lr=LR)),
            ).start("localhost:0")
            wal = os.path.join(root, "wal", f"shard{i}")
            svc.configure_push_log(wal, group_ms=1.0)
            self.wal_dirs.append(wal)
            self.shards.append(svc)
        self.engine = None

    def client(self):
        from elasticdl_tpu_torch.embedding.row_service import (
            make_remote_engine,
        )

        if self.engine is None:
            self.engine = make_remote_engine(
                ",".join(f"localhost:{s.port}" for s in self.shards),
                id_keys={t: f"ids_{t}" for t in _TABLES.values()},
                retries=6, backoff_secs=0.1,
            )
        return self.engine

    def push(self, table: str, ids, grads):
        engine = self.client()
        engine.optimizer.apply_gradients(
            engine.tables[table], ids, grads
        )

    def pull_bytes(self, table: str, num_rows: int) -> bytes:
        rows = np.asarray(
            self.client().tables[table].get(_row_ids(0, num_rows)),
            dtype=np.float32,
        )
        return rows.tobytes()

    def stop(self):
        if self.engine is not None:
            self.engine.close()
        for svc in self.shards:
            try:
                svc.stop(0)
            except Exception:
                pass


def _solo_run(workdir: str, job: str):
    """Control: the job alone on a fresh fleet, tasks in order.
    Returns (dense_bytes, table_bytes)."""
    fleet = _Fleet(os.path.join(workdir, f"solo_{job}"))
    try:
        model = np.zeros(DENSE_DIM, np.float32)
        for k in range(_NTASKS[job]):
            start = k * ROWS_PER_TASK
            ids, grads = _task_grads(job, start, start + ROWS_PER_TASK)
            fleet.push(_TABLES[job], ids, grads)
            model = model + _task_dense(job, start)
        return model.tobytes(), fleet.pull_bytes(
            _TABLES[job], _NTASKS[job] * ROWS_PER_TASK
        )
    finally:
        fleet.stop()


def _shared_run(workdir: str) -> dict:
    """The real thing: GangScheduler + MasterJournal + MasterServicer
    over one fleet, two simulated worker slots, a live preemption."""
    from elasticdl_tpu_torch.master.journal import MasterJournal
    from elasticdl_tpu_torch.master.scheduler import GangScheduler
    from elasticdl_tpu_torch.master.servicer import MasterServicer
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher

    root = os.path.join(workdir, "shared")
    fleet = _Fleet(root)
    journal_dir = os.path.join(root, "journal")
    journal = MasterJournal(journal_dir)
    generation = journal.open_generation()
    sched = GangScheduler(slots_fn=lambda: SLOTS, journal=journal)
    servicer = MasterServicer(
        TaskDispatcher({}, shuffle=False),  # single-job plane unused
        journal=journal, generation=generation, scheduler=sched,
    )

    out = {
        "events": [], "dropped_leases": 0, "preempt_checkpointed": 0,
        "resume_restored": 0, "steps": 0, "finished_seen": False,
        "applied": {LO_JOB: {}, HI_JOB: {}},
        "dense": {}, "rows": {}, "problems": [],
    }
    models = {LO_JOB: np.zeros(DENSE_DIM, np.float32)}
    ckpt_dir = os.path.join(root, "preempt_ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)

    def _preempt_lo(job_id, entry):
        # Checkpoint-now on preemption: persist the dense model and
        # poison the in-memory copy — an apply that sneaks in while
        # the gang is revoked would crash the drill, not corrupt it.
        np.save(os.path.join(ckpt_dir, "batch_lo.npy"),
                models[LO_JOB])
        models[LO_JOB] = None
        out["preempt_checkpointed"] += 1

    def _resume_lo(job_id, entry):
        models[LO_JOB] = np.load(
            os.path.join(ckpt_dir, "batch_lo.npy")
        )
        out["resume_restored"] += 1

    sched.submit(LO_JOB, spec=_job_spec(LO_JOB), priority=1,
                 gang_size=2, preempt_cb=_preempt_lo,
                 resume_cb=_resume_lo)

    def _apply(job: str, task: dict):
        start, end = int(task["start"]), int(task["end"])
        ids, grads = _task_grads(job, start, end)
        fleet.push(_TABLES[job], ids, grads)
        models[job] = models[job] + _task_dense(job, start)
        tid = int(task["task_id"])
        out["applied"][job][tid] = out["applied"][job].get(tid, 0) + 1

    hi_submitted = False
    pending = {w: None for w in range(SLOTS)}  # worker -> (job, task)
    try:
        for step in range(1, MAX_STEPS + 1):
            out["steps"] = step
            # Fetch: idle workers lease before the tick, so the
            # preemption below lands on genuinely in-flight leases.
            for w in range(SLOTS):
                if pending[w] is not None:
                    continue
                resp = servicer.get_task({"worker_id": w})
                if resp.get("finished"):
                    out["finished_seen"] = True
                    continue
                task = resp.get("task")
                if task is None or int(task["task_id"]) < 0:
                    continue
                pending[w] = (str(resp.get("job", "")), task)
            if (not hi_submitted
                    and len(out["applied"][LO_JOB]) >= PREEMPT_AFTER):
                models[HI_JOB] = np.zeros(DENSE_DIM, np.float32)
                resp = servicer.submit_job({
                    "job": HI_JOB, "spec": _job_spec(HI_JOB),
                    "priority": 10, "gang_size": 2,
                })
                if not resp.get("accepted"):
                    out["problems"].append(
                        f"submit_job rejected: {resp}"
                    )
                hi_submitted = True
            out["events"].extend(sched.tick())
            # A preempted gang's pods are deleted: any lease a worker
            # was still holding dies with it, un-applied. The handed-
            # back task re-runs after resume — exactly once.
            states = {
                j: e["state"]
                for j, e in sched.render()["jobs"].items()
            }
            for w in range(SLOTS):
                if (pending[w] is not None
                        and states.get(pending[w][0]) == "preempted"):
                    pending[w] = None
                    out["dropped_leases"] += 1
            # Apply + report the surviving leases.
            for w in range(SLOTS):
                if pending[w] is None:
                    continue
                job, task = pending[w]
                _apply(job, task)
                servicer.report_task_result({
                    "task_id": int(task["task_id"]),
                    "worker_id": w, "job": job,
                    "generation": generation,
                })
                pending[w] = None
            if states and all(s == "done" for s in states.values()):
                break
        # One more lease round so the servicer's finished verdict
        # (scheduler idle + primary drained) is exercised.
        resp = servicer.get_task({"worker_id": 0})
        if resp.get("finished"):
            out["finished_seen"] = True
        for job in (LO_JOB, HI_JOB):
            out["dense"][job] = models[job].tobytes()
            out["rows"][job] = fleet.pull_bytes(
                _TABLES[job], _NTASKS[job] * ROWS_PER_TASK
            )
        out["render"] = sched.render()
        out["journal_dir"] = journal_dir
        out["wal_dirs"] = list(fleet.wal_dirs)
    finally:
        fleet.stop()
        journal.close()
    return out


def _replay_fold(journal_dir: str) -> dict:
    """Cold fold of the journal's sched records — exactly what a
    promoted standby (or a recovering master) would wake up with."""
    from elasticdl_tpu_torch.master.journal import (
        JOURNAL_FILE,
        SCHED,
        SNAPSHOT,
        apply_sched_record,
        new_sched_state,
        read_records,
    )

    state = new_sched_state()
    for _offset, _end, record in read_records(
        os.path.join(journal_dir, JOURNAL_FILE)
    ):
        if record["t"] == SNAPSHOT and record.get("sched") is not None:
            state = record["sched"]
        elif record["t"] == SCHED:
            apply_sched_record(state, record)
    return state


def _fsck(journal_dir: str, wal_dirs) -> dict:
    from elasticdl_tpu_torch.tools.check_journal import check_journal
    from elasticdl_tpu_torch.tools.check_pushlog import check_one_log

    result = {"journal_errors": check_journal(journal_dir),
              "wal": []}
    for wal in wal_dirs:
        errors, rep = check_one_log(wal)
        result["wal"].append({
            "dir": wal, "errors": errors,
            "records": rep.get("records", 0),
            "torn_tail": rep.get("torn_tail"),
        })
    return result


def run_drill(workdir: str, seed: int = 0) -> dict:
    report = {
        "drill": "gang_sched",
        "seed": seed,
        "config": {
            "slots": SLOTS, "dense_dim": DENSE_DIM,
            "row_dim": ROW_DIM, "rows_per_task": ROWS_PER_TASK,
            "jobs": {
                LO_JOB: {"priority": 1, "gang": 2,
                         "tasks": LO_TASKS},
                HI_JOB: {"priority": 10, "gang": 2,
                         "tasks": HI_TASKS},
            },
            "preempt_after": PREEMPT_AFTER,
        },
        "problems": [],
    }

    solo = {job: _solo_run(workdir, job) for job in (LO_JOB, HI_JOB)}
    shared = _shared_run(workdir)
    report["problems"].extend(shared["problems"])
    report["scheduler"] = {
        "events": shared["events"],
        "steps": shared["steps"],
        "dropped_leases": shared["dropped_leases"],
        "finished_seen": shared["finished_seen"],
    }

    # Isolation: byte-equality against the solo controls.
    byte_equal = {}
    for job in (LO_JOB, HI_JOB):
        dense_ok = solo[job][0] == shared["dense"][job]
        rows_ok = solo[job][1] == shared["rows"][job]
        byte_equal[job] = {"dense": dense_ok, "rows": rows_ok}
        if not dense_ok:
            report["problems"].append(
                f"{job}: dense model diverged from solo run"
            )
        if not rows_ok:
            report["problems"].append(
                f"{job}: row table diverged from solo run"
            )
    report["byte_equal"] = byte_equal

    # Exactly-once accounting (and the preemption really revoked
    # in-flight leases whose tasks then re-ran).
    accounting = {}
    for job in (LO_JOB, HI_JOB):
        counts = shared["applied"][job]
        dupes = {t: c for t, c in counts.items() if c != 1}
        accounting[job] = {"applied": len(counts), "dupes": dupes}
        if len(counts) != _NTASKS[job]:
            report["problems"].append(
                f"{job}: {len(counts)} tasks applied, "
                f"want {_NTASKS[job]}"
            )
        if dupes:
            report["problems"].append(
                f"{job}: tasks applied more than once: {dupes}"
            )
    report["accounting"] = accounting
    if shared["dropped_leases"] < 1:
        report["problems"].append(
            "no in-flight lease was revoked by the preemption — the "
            "drill did not exercise the handback path"
        )
    if shared["preempt_checkpointed"] != 1:
        report["problems"].append(
            f"preempt checkpoint ran {shared['preempt_checkpointed']} "
            "times, want exactly 1"
        )
    if shared["resume_restored"] != 1:
        report["problems"].append(
            f"resume restore ran {shared['resume_restored']} times, "
            "want exactly 1"
        )
    if not shared["finished_seen"]:
        report["problems"].append(
            "servicer never reported finished after both jobs done"
        )

    # Lifecycle: live table and the cold journal fold must both say
    # done+done with exactly one preemption of the batch job.
    fold = _replay_fold(shared["journal_dir"])
    live = shared["render"]["jobs"]
    report["replay"] = {
        "jobs": {j: e.get("state") for j, e in fold["jobs"].items()},
        "preemptions": fold.get("preemptions", 0),
    }
    for job in (LO_JOB, HI_JOB):
        for name, table in (("live", live), ("replayed", fold["jobs"])):
            got = (table.get(job) or {}).get("state")
            if got != "done":
                report["problems"].append(
                    f"{name} state for {job} is {got!r}, want 'done'"
                )
    lo_preempts = (fold["jobs"].get(LO_JOB) or {}).get("preemptions", 0)
    if lo_preempts != 1:
        report["problems"].append(
            f"journal fold shows {lo_preempts} preemptions of "
            f"{LO_JOB}, want exactly 1"
        )

    # Fsck: journal + every shard WAL.
    fsck = _fsck(shared["journal_dir"], shared["wal_dirs"])
    report["fsck"] = fsck
    report["problems"].extend(
        f"journal fsck: {e}" for e in fsck["journal_errors"]
    )
    for wal in fsck["wal"]:
        report["problems"].extend(
            f"wal fsck {wal['dir']}: {e}" for e in wal["errors"]
        )
        if wal["records"] <= 0:
            report["problems"].append(
                f"wal {wal['dir']}: no push records — the WAL was "
                "not exercised"
            )

    report["passed"] = not report["problems"]
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("elasticdl_tpu_torch-sched-drill")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--report", default="",
                        help="default: <workdir>/SCHED_DRILL.json")
    args = parser.parse_args(argv)
    args.report = args.report or os.path.join(args.workdir,
                                              "SCHED_DRILL.json")

    report = run_drill(args.workdir, args.seed)
    with open(args.report, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True, default=str)
        fh.write("\n")
    logger.info(
        "sched drill: %s (%d events, %d dropped leases); report %s",
        "PASS" if report["passed"] else "FAIL",
        len(report["scheduler"]["events"]),
        report["scheduler"]["dropped_leases"],
        args.report,
    )
    if report["problems"]:
        for problem in report["problems"]:
            logger.error("problem: %s", problem)
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
