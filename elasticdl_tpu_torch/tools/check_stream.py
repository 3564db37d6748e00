"""Schema-check streaming-ingestion drill output
(``elasticdl_tpu_torch/chaos/stream_drill.py``), the port's copy of
``tools/check_stream.py``: the same checks, messages and exit codes (0 clean, 1
errors, 2 usage). Either package's report passes it.

Usage::

    python -m elasticdl_tpu_torch.tools.check_stream STREAM_DRILL.json
    python -m elasticdl_tpu_torch.tools.check_stream DRILL_DIR

Validates (returning a list of human-readable errors, empty = pass):

- **verdict**: ``passed`` true with an empty ``problems`` list;
- **offset contiguity**: every partition in every run ends with
  ``committed == next`` (no uncommitted gap), zero pending ranges,
  and ``committed`` exactly equal to the configured appended end —
  a hole in the offset space means an acked range was lost;
- **watermark bounds**: committed watermarks never exceed the
  appended end, and the kill run's RESUMED watermark is at or above
  the pre-kill committed snapshot (failover must never re-ack);
- **journal coverage**: the cold fold of the journal's STREAM/REPORT
  records equals the live dispatcher's final view — the stream state
  a relaunch derives is the state the pipeline actually reached;
- **exactly-once / durability**: read-your-writes checked with zero
  misses, the kill run byte-equal to its kill-free twin with equal
  applied push counts;
- **coexistence**: the streaming job was preempted by and yielded
  back from a batch tenant with a monotone watermark, per-range
  apply counts all 1, and nonzero backpressure while paused;
- **fsck**: master journal and every WAL (including the dead
  incarnation's pre-relaunch audit) clean, with records flowing.

Stdlib only, importable from tests.
"""

import json
import os
import sys
from typing import List, Tuple

REPORT_NAME = "STREAM_DRILL.json"


def _partitions(report) -> List[str]:
    return list((report.get("config") or {}).get("partitions") or [])


def _check_contiguity(report, errors: List[str]):
    want_end = int(
        (report.get("config") or {}).get("records_per_partition", -1)
    )
    kill = report.get("kill") or {}
    for label in ("killed", "twin"):
        run = kill.get(label) or {}
        final = run.get("final_progress")
        if not isinstance(final, dict) or not final:
            errors.append(f"{label}: final_progress missing")
            continue
        for partition in _partitions(report):
            part = final.get(partition)
            if not isinstance(part, dict):
                errors.append(
                    f"{label}: partition {partition!r} missing from "
                    "final_progress"
                )
                continue
            committed = int(part.get("committed", -1))
            nxt = int(part.get("next", -1))
            if committed != want_end:
                errors.append(
                    f"{label}: {partition} committed {committed}, "
                    f"want the appended end {want_end}"
                )
            if committed > nxt:
                errors.append(
                    f"{label}: {partition} committed {committed} "
                    f"beyond generated cursor {nxt}"
                )
            if committed != nxt:
                errors.append(
                    f"{label}: {partition} offset gap — committed "
                    f"{committed} != next {nxt} at drain"
                )
            if int(part.get("pending_ranges", 0)) != 0:
                errors.append(
                    f"{label}: {partition} drained with "
                    f"{part['pending_ranges']} pending ranges"
                )


def _check_watermarks(report, errors: List[str]):
    kill = (report.get("kill") or {}).get("killed") or {}
    snap = kill.get("committed_at_kill")
    resumed = kill.get("resumed_progress")
    if not isinstance(snap, dict) or not snap:
        errors.append("killed: no committed_at_kill snapshot — the "
                      "kill window never opened")
        return
    if not isinstance(resumed, dict):
        errors.append("killed: resumed_progress missing")
        return
    for partition, before in snap.items():
        was = int((before or {}).get("committed", -1))
        now = int((resumed.get(partition) or {}).get("committed", -1))
        if now < was:
            errors.append(
                f"watermark: {partition} resumed at {now}, below "
                f"the {was} committed before the kills — failover "
                "re-acked the stream"
            )
    if int(kill.get("read_your_writes", {}).get("checked", 0)) <= 0:
        errors.append(
            "read_your_writes: nothing checked after the relaunch"
        )
    if int(kill.get("read_your_writes", {}).get("missing", -1)) != 0:
        errors.append(
            "read_your_writes: committed offsets served zero rows"
        )


def _check_journal_coverage(report, errors: List[str]):
    for label in ("killed", "twin"):
        run = (report.get("kill") or {}).get(label) or {}
        fold = run.get("journal_fold")
        final = run.get("final_progress")
        if not isinstance(fold, dict) or not fold:
            errors.append(f"{label}: journal_fold missing")
            continue
        if fold != final:
            errors.append(
                f"{label}: journal stream fold {fold} disagrees "
                f"with the live dispatcher {final}"
            )


def _check_equivalence(report, errors: List[str]):
    kill = report.get("kill") or {}
    if not kill.get("byte_equal"):
        errors.append(
            "byte_equal: killed run's row fleet diverged from the "
            "kill-free twin"
        )
    killed = (kill.get("killed") or {}).get("push_counts")
    twin = (kill.get("twin") or {}).get("push_counts")
    if not killed or killed != twin:
        errors.append(
            f"push_counts: {killed} vs twin {twin} — a push was "
            "lost or double-applied"
        )


def _check_coexistence(report, errors: List[str]):
    co = report.get("coexist")
    if not isinstance(co, dict):
        errors.append("coexist: missing block")
        return
    if int(co.get("preemptions", 0)) < 1:
        errors.append("coexist: streaming tenant never preempted")
    if int(co.get("resumes", 0)) < 1:
        errors.append("coexist: streaming tenant never resumed")
    if int(co.get("dropped_leases", 0)) < 1:
        errors.append(
            "coexist: no in-flight lease revoked by the preemption"
        )
    if not co.get("watermark_monotone"):
        errors.append(
            "coexist: watermark regressed across the preemption"
        )
    if float(co.get("backpressure_seconds", 0.0)) <= 0.0:
        errors.append(
            "coexist: backpressure never accumulated while the "
            "streaming gang was paused"
        )
    states = co.get("states") or {}
    for job, want in (("stream-live", "done"), ("batch-hi", "done")):
        if states.get(job) != want:
            errors.append(
                f"coexist: job {job} ended {states.get(job)!r}, "
                f"want {want!r}"
            )
    applied = co.get("applied") or {}
    dupes = {k: c for k, c in applied.items() if int(c) != 1}
    if dupes:
        errors.append(f"coexist: stream ranges re-applied: {dupes}")


def _check_fsck(report, errors: List[str]):
    kill = report.get("kill") or {}
    for label in ("killed", "twin"):
        run = kill.get(label) or {}
        for err in run.get("journal_fsck_errors") or []:
            errors.append(f"fsck: {label} journal: {err}")
        wals = run.get("wal_fsck") or []
        if not wals:
            errors.append(f"fsck: {label}: no shard WALs audited")
        for wal in wals:
            for err in (wal or {}).get("errors") or []:
                errors.append(
                    f"fsck: {label} wal {wal.get('dir')}: {err}"
                )
            if int((wal or {}).get("records", 0)) <= 0:
                errors.append(
                    f"fsck: {label} wal {wal.get('dir')} has no "
                    "push records"
                )
    dead = (kill.get("killed") or {}).get("dead_wal_fsck")
    if not isinstance(dead, dict):
        errors.append(
            "fsck: dead incarnation's WAL was never audited before "
            "the relaunch"
        )
    coerrs = (report.get("coexist") or {}).get("journal_fsck_errors")
    for err in coerrs or []:
        errors.append(f"fsck: coexist journal: {err}")


def check_stream(path: str) -> Tuple[List[str], dict]:
    """Validate one STREAM_DRILL.json (or a dir containing it)."""
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
    if report.get("drill") != "stream_ingest":
        errors.append(
            f"unexpected drill kind: {report.get('drill')!r}"
        )
    if not report.get("passed"):
        errors.append("drill did not pass")
    for problem in report.get("problems") or []:
        errors.append(f"recorded problem: {problem}")
    _check_contiguity(report, errors)
    _check_watermarks(report, errors)
    _check_journal_coverage(report, errors)
    _check_equivalence(report, errors)
    _check_coexistence(report, errors)
    _check_fsck(report, errors)
    return errors, report


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: check_stream.py STREAM_DRILL.json|DIR",
              file=sys.stderr)
        return 2
    errors, report = check_stream(argv[0])
    if errors:
        for err in errors:
            print(f"FAIL: {err}")
        return 1
    ryw = ((report.get("kill") or {}).get("killed") or {}).get(
        "read_your_writes", {}
    )
    co = report.get("coexist", {})
    print(
        "OK: streaming ingestion drill "
        f"({ryw.get('checked', 0)} committed offsets read-your-"
        f"writes clean, byte-equal twin, {co.get('preemptions', 0)} "
        "preemption(s) survived)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
