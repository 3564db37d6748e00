"""Schema-check gang-scheduler drill output
(``elasticdl_tpu_torch/chaos/sched_drill.py``), the port's copy of
``tools/check_sched.py``: the same checks, messages and exit codes (0 clean, 1
errors, 2 usage). Either package's report passes it.

Usage::

    python -m elasticdl_tpu_torch.tools.check_sched SCHED_DRILL.json
    python -m elasticdl_tpu_torch.tools.check_sched DRILL_DIR

Validates (returning a list of human-readable errors, empty = pass):

- **verdict**: ``passed`` true with an empty ``problems`` list;
- **isolation**: every per-job ``byte_equal`` flag (dense model AND
  row table vs the solo control run) true;
- **exactly-once**: per-job applied-task counts match the configured
  task counts, no duplicate applications, and at least one in-flight
  lease was actually revoked by the preemption (the drill must
  exercise the handback path, not schedule around it);
- **lifecycle**: the scheduler event stream contains the full
  preempt story in order (``preempt`` of the batch job before the
  high-priority job's ``done``, a ``resume`` after it), the journal
  replay fold says both jobs ``done`` with exactly one preemption,
  and the servicer reported ``finished`` at the end;
- **fsck**: the embedded journal fsck came back clean and every
  shard WAL fsck'd clean with a nonzero record count.

Stdlib only, importable from tests.
"""

import json
import os
import sys
from typing import List, Tuple

REPORT_NAME = "SCHED_DRILL.json"


def _check_isolation(report, errors: List[str]):
    byte_equal = report.get("byte_equal")
    if not isinstance(byte_equal, dict) or not byte_equal:
        errors.append("byte_equal: missing block")
        return
    for job, flags in byte_equal.items():
        for what in ("dense", "rows"):
            if not (flags or {}).get(what):
                errors.append(
                    f"byte_equal: {job} {what} state diverged from "
                    "the solo control run"
                )


def _check_accounting(report, errors: List[str]):
    accounting = report.get("accounting")
    jobs_cfg = (report.get("config") or {}).get("jobs") or {}
    if not isinstance(accounting, dict) or not accounting:
        errors.append("accounting: missing block")
        return
    for job, row in accounting.items():
        want = int((jobs_cfg.get(job) or {}).get("tasks", -1))
        applied = int((row or {}).get("applied", -1))
        if applied != want:
            errors.append(
                f"accounting: {job} applied {applied} tasks, "
                f"want {want}"
            )
        if (row or {}).get("dupes"):
            errors.append(
                f"accounting: {job} tasks applied more than once: "
                f"{row['dupes']}"
            )
    sched = report.get("scheduler") or {}
    if int(sched.get("dropped_leases", 0)) < 1:
        errors.append(
            "accounting: no in-flight lease revoked — the drill did "
            "not exercise the preemption handback path"
        )


def _check_lifecycle(report, errors: List[str]):
    sched = report.get("scheduler") or {}
    events = sched.get("events") or []
    preempts = [i for i, e in enumerate(events)
                if str(e).startswith("preempt:")]
    resumes = [i for i, e in enumerate(events)
               if str(e).startswith("resume:")]
    if not preempts:
        errors.append("lifecycle: no preempt event in the stream")
    if not resumes:
        errors.append("lifecycle: no resume event in the stream")
    if preempts and resumes and resumes[0] < preempts[0]:
        errors.append("lifecycle: resume precedes preempt")
    if not sched.get("finished_seen"):
        errors.append(
            "lifecycle: servicer never reported finished"
        )
    replay = report.get("replay")
    if not isinstance(replay, dict):
        errors.append("replay: missing block")
        return
    jobs_cfg = (report.get("config") or {}).get("jobs") or {}
    states = replay.get("jobs") or {}
    for job in jobs_cfg:
        if states.get(job) != "done":
            errors.append(
                f"replay: journal fold says {job} is "
                f"{states.get(job)!r}, want 'done'"
            )
    if int(replay.get("preemptions", 0)) != 1:
        errors.append(
            f"replay: {replay.get('preemptions')} preemptions in "
            "the journal fold, want exactly 1"
        )


def _check_fsck(report, errors: List[str]):
    fsck = report.get("fsck")
    if not isinstance(fsck, dict):
        errors.append("fsck: missing block")
        return
    for err in fsck.get("journal_errors") or []:
        errors.append(f"fsck: journal: {err}")
    wals = fsck.get("wal") or []
    if not wals:
        errors.append("fsck: no shard WALs audited")
    for wal in wals:
        for err in (wal or {}).get("errors") or []:
            errors.append(f"fsck: wal {wal.get('dir')}: {err}")
        if int((wal or {}).get("records", 0)) <= 0:
            errors.append(
                f"fsck: wal {wal.get('dir')} has no push records"
            )


def check_sched(path: str) -> Tuple[List[str], dict]:
    """Validate one SCHED_DRILL.json (or a dir containing it)."""
    if os.path.isdir(path):
        path = os.path.join(path, REPORT_NAME)
    if not os.path.exists(path):
        return [f"{path}: missing"], {}
    try:
        with open(path) as fh:
            report = json.load(fh)
    except (OSError, ValueError) as err:
        return [f"{path}: unreadable ({err})"], {}
    errors: List[str] = []
    if report.get("drill") != "gang_sched":
        errors.append(
            f"unexpected drill kind: {report.get('drill')!r}"
        )
    if not report.get("passed"):
        errors.append("drill did not pass")
    for problem in report.get("problems") or []:
        errors.append(f"recorded problem: {problem}")
    _check_isolation(report, errors)
    _check_accounting(report, errors)
    _check_lifecycle(report, errors)
    _check_fsck(report, errors)
    return errors, report


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: check_sched.py SCHED_DRILL.json|DIR",
              file=sys.stderr)
        return 2
    errors, report = check_sched(argv[0])
    if errors:
        for err in errors:
            print(f"FAIL: {err}")
        return 1
    sched = report.get("scheduler", {})
    print(
        "OK: gang scheduler drill "
        f"({len(sched.get('events') or [])} events, "
        f"{sched.get('dropped_leases', 0)} leases revoked, "
        f"{sched.get('steps', 0)} steps)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
