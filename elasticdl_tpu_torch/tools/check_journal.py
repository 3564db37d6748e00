"""Fsck for the master's write-ahead job-state journal
(``elasticdl_tpu_torch/master/journal.py``), the port's copy of
``tools/check_journal.py``: the same checks, messages and exit codes (0
clean, 1 errors, 2 usage). It reads either package's journals (the
bytes are the same).

Usage::

    python -m elasticdl_tpu_torch.tools.check_journal JOURNAL_DIR_OR_FILE

Validates (returning a list of human-readable errors, empty = pass):

- framing: every byte accounted for by intact length+CRC32 frames;
  torn/trailing bytes are reported with the offset and size (recovery
  would silently truncate them — fsck's job is to surface the loss);
- every record passes the structural check (``validate_record``) —
  including the eval-round (``eval_round``/``eval_fold``), relaunch-
  generation, and takeover ``fence`` kinds;
- ``seq`` strictly increases across the file;
- ``generation`` fences strictly increase (a replayed incarnation
  must never reuse a generation);
- takeover ``fence`` records strictly increase, and no generation
  below a published fence ever appends after it — a violation means
  a fenced zombie incarnation wrote to the journal (split-brain);
- dispatch ``task_id``s strictly increase (the counter survives
  restarts by construction — reuse would break report fencing);
- report/tail consistency: every ``report`` names a task id known to
  the journal (an earlier ``dispatch`` record, or the latest
  snapshot's doing set / resolved ledger).

Importable: ``check_journal(path)``.
"""

import os
import sys
from typing import List


def check_journal(path: str) -> List[str]:
    from elasticdl_tpu_torch.master.journal import (
        DISPATCH,
        FENCE,
        GENERATION,
        JOURNAL_FILE,
        REPORT,
        SNAPSHOT,
        read_records,
        validate_record,
    )

    if os.path.isdir(path):
        path = os.path.join(path, JOURNAL_FILE)
    if not os.path.exists(path):
        return [f"{path}: no such journal"]
    errors: List[str] = []
    last_seq = None
    last_generation = None
    last_fence = None
    last_dispatch_id = None
    known_tasks = set()
    consumed = 0
    count = 0
    for offset, end, record in read_records(path):
        consumed = end
        count += 1
        err = validate_record(record)
        if err:
            errors.append(f"record @{offset}: {err}")
            continue
        seq = record["seq"]
        if last_seq is not None and seq <= last_seq:
            errors.append(
                f"record @{offset}: seq went backwards "
                f"({last_seq} -> {seq})"
            )
        last_seq = seq
        rtype = record["t"]
        if last_fence is not None and rtype in (GENERATION, DISPATCH):
            # Anything a fenced incarnation could write carries its
            # generation; dispatches and generation fences are the
            # state-bearing ones worth auditing.
            generation = record.get("generation")
            if generation is not None and generation < last_fence:
                errors.append(
                    f"record @{offset}: generation {generation} "
                    f"appended after fence {last_fence} — a fenced "
                    "zombie incarnation wrote to the journal"
                )
        if rtype == GENERATION:
            generation = record["generation"]
            if (last_generation is not None
                    and generation <= last_generation):
                errors.append(
                    f"record @{offset}: generation did not advance "
                    f"({last_generation} -> {generation})"
                )
            last_generation = generation
        elif rtype == FENCE:
            fence = record["generation"]
            if last_fence is not None and fence <= last_fence:
                errors.append(
                    f"record @{offset}: fence records are "
                    f"non-monotonic ({last_fence} -> {fence})"
                )
            last_fence = fence
        elif rtype == SNAPSHOT:
            state = record["state"]
            # The snapshot supersedes history: its doing set and
            # resolved ledger are the tail's report universe.
            known_tasks = {int(tid) for tid, _t, _w in state["doing"]}
            known_tasks |= {
                int(tid) for tid, _t, _w, _r in state.get("resolved", [])
            }
            last_dispatch_id = max(
                int(state.get("task_id", 0)), last_dispatch_id or 0
            )
        elif rtype == DISPATCH:
            task_id = record["task_id"]
            if (last_dispatch_id is not None
                    and task_id <= last_dispatch_id):
                errors.append(
                    f"record @{offset}: dispatch task_id not "
                    f"monotonic ({last_dispatch_id} -> {task_id})"
                )
            last_dispatch_id = task_id
            known_tasks.add(task_id)
        elif rtype == REPORT:
            task_id = record["task_id"]
            if task_id not in known_tasks:
                errors.append(
                    f"record @{offset}: report for task {task_id} "
                    "never dispatched in this journal "
                    "(snapshot/tail inconsistency)"
                )
    if count == 0:
        errors.append(f"{path}: no intact records")
    size = os.path.getsize(path)
    if size > consumed:
        errors.append(
            f"{path}: {size - consumed} torn/trailing byte(s) past "
            f"the last intact record @{consumed} (recovery would "
            "truncate them)"
        )
    return errors


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        print("usage: check_journal JOURNAL_DIR_OR_FILE",
              file=sys.stderr)
        return 2
    errors = check_journal(argv[0])
    if errors:
        for err in errors:
            print(f"check_journal: {err}", file=sys.stderr)
        print(f"{argv[0]}: FAILED ({len(errors)} error(s))",
              file=sys.stderr)
        return 1
    print(f"{argv[0]}: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
