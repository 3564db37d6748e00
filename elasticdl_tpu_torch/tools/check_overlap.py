"""Assert the sparse input pipeline actually OVERLAPS the device step
(the port's copy of ``tools/check_overlap.py``; the same checks,
messages and exit codes).

Usage::

    python -m elasticdl_tpu_torch.tools.check_overlap TRACE_sparse.json

Loads a Perfetto/Chrome ``trace_event`` JSON (the format
``elasticdl_tpu_torch/observability/trace_export.py`` writes) and checks that at least one
``row_pull`` span overlaps a ``device_step`` span in wall-clock —
overlap is the entire point of the pipelined sparse path (parallel
fan-out + pull-ahead + device double-buffering), and this pin keeps a
future refactor from silently re-serializing the pipeline: a
serialized pipeline pulls rows strictly between steps and the check
fails.

Two guards keep the signal honest:

- **Cross-tree only**: a ``row_pull`` that is part of the same trace
  tree as the ``device_step`` (the synchronous path, where prepare runs
  *inside* the step span) overlaps it trivially by nesting — such pairs
  are excluded. Pipelined pulls run on the prefetch thread under their
  own ``prepare_batch`` root, so they carry a different ``trace_id``.
- **Single worker**: run the checked job with ONE worker (the smoke
  does) — with several workers, worker A's pull overlapping worker B's
  step would fake the signal without any pipeline at all.

Stdlib only, importable from tests (``check_overlap(path)`` /
``find_overlaps(events)``).
"""

import json
import sys
from typing import List, Tuple

PULL_SPAN = "row_pull"
STEP_SPAN = "device_step"


def _complete_events(trace: dict) -> List[dict]:
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return []
    return [
        ev for ev in events
        if isinstance(ev, dict) and ev.get("ph") == "X"
    ]


def find_overlaps(events: List[dict],
                  pull_name: str = PULL_SPAN,
                  step_name: str = STEP_SPAN) -> List[Tuple[dict, dict]]:
    """(pull_event, step_event) pairs overlapping in wall-clock whose
    trace trees differ (see module docstring). ``events`` are Chrome
    ``X`` events (µs ``ts``/``dur``, ids in ``args``)."""
    pulls = [e for e in events if e.get("name") == pull_name]
    steps = [e for e in events if e.get("name") == step_name]
    out = []
    for pull in pulls:
        p_trace = (pull.get("args") or {}).get("trace_id")
        p0 = float(pull.get("ts", 0.0))
        p1 = p0 + float(pull.get("dur", 0.0))
        for step in steps:
            if p_trace and p_trace == (step.get("args") or {}).get(
                "trace_id"
            ):
                continue  # same tree: nesting, not pipelining
            s0 = float(step.get("ts", 0.0))
            s1 = s0 + float(step.get("dur", 0.0))
            if max(p0, s0) < min(p1, s1):
                out.append((pull, step))
    return out


def check_overlap(path: str) -> List[str]:
    """Human-readable error list; empty = the pipeline overlapped."""
    try:
        with open(path) as fh:
            trace = json.load(fh)
    except (OSError, ValueError) as exc:
        return [f"cannot load {path}: {exc}"]
    events = _complete_events(trace)
    if not events:
        return [f"{path}: no complete (ph=X) trace events"]
    pulls = [e for e in events if e.get("name") == PULL_SPAN]
    steps = [e for e in events if e.get("name") == STEP_SPAN]
    if not pulls:
        return [f"{path}: no {PULL_SPAN!r} spans — was the sparse "
                "pipeline (and its tracing) on?"]
    if not steps:
        return [f"{path}: no {STEP_SPAN!r} spans — did the job train?"]
    overlaps = find_overlaps(events)
    if not overlaps:
        return [
            f"{path}: none of {len(pulls)} {PULL_SPAN!r} spans overlaps "
            f"any of {len(steps)} {STEP_SPAN!r} spans outside its own "
            "trace tree — the sparse pipeline is running SERIALIZED "
            "(row pulls sit back on the step critical path)"
        ]
    return []


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        print("usage: check_overlap.py TRACE.json", file=sys.stderr)
        return 2
    errors = check_overlap(argv[0])
    if errors:
        for err in errors:
            print(f"check_overlap: {err}", file=sys.stderr)
        print(f"{argv[0]}: FAILED ({len(errors)} error(s))",
              file=sys.stderr)
        return 1
    with open(argv[0]) as fh:
        n = len(find_overlaps(_complete_events(json.load(fh))))
    print(f"{argv[0]}: OK ({n} row_pull/device_step overlap(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
