#!/usr/bin/env python
"""Schema-check a Perfetto/Chrome ``trace_event`` JSON produced by
``python -m elasticdl_tpu_torch trace`` (observability/trace_export.py).

Usage::

    python -m elasticdl_tpu_torch.tools.check_trace TRACE.json

The port's copy of ``tools/check_trace.py``: the same checks, messages
and exit codes.

Validates (returning a list of human-readable errors, empty = pass):

- top-level shape: ``{"traceEvents": [...]}``, non-empty;
- every ``X`` (complete) event carries name / numeric ts+dur /
  integer pid+tid and the span/trace ids in ``args``;
- every pid used by an event has a ``process_name`` metadata record
  (the role tracks Perfetto shows);
- at least one ``task`` span's subtree forms a single connected tree
  crossing **master → worker → row-service** — the acceptance shape:
  dispatch, step phases, and row pulls visible in one timeline;
- **principal propagation**: any event whose args carry one of the
  ``principal_job`` / ``principal_component`` / ``principal_purpose``
  tags carries all three, with the purpose drawn from the closed
  enum (docs/observability.md "Workload attribution"). Vacuous on
  principal-free traces — attribution is optional, half a principal
  is not.

Stdlib only, importable from tests (``check_trace(path)``).
"""

import json
import sys
from typing import Dict, List

REQUIRED_ROLES = ("worker", "master", "rowservice")
PRINCIPAL_KEYS = ("principal_job", "principal_component",
                  "principal_purpose")
# Closed purpose enum — mirror of observability/principal.py PURPOSES
# (+ the "unknown" fallback); stdlib-only tools keep their own copy.
PRINCIPAL_PURPOSES = frozenset((
    "training", "serving_read", "migration", "replica_refresh",
    "replay", "checkpoint", "control", "streaming_ingest", "canary",
    "unknown",
))


def check_trace(path: str,
                required_roles=REQUIRED_ROLES) -> List[str]:
    errors: List[str] = []
    try:
        with open(path) as fh:
            trace = json.load(fh)
    except (OSError, ValueError) as exc:
        return [f"cannot load {path}: {exc}"]
    events = trace.get("traceEvents")
    if not isinstance(events, list) or not events:
        return [f"{path}: traceEvents missing or empty"]

    named_pids = set()
    spans: Dict[str, dict] = {}
    children: Dict[str, List[dict]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph == "M":
            if ev.get("name") == "process_name":
                named_pids.add(ev.get("pid"))
            continue
        if ph != "X":
            errors.append(f"event {i}: unexpected ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errors.append(f"event {i}: missing name")
        for key in ("ts", "dur"):
            value = ev.get(key)
            if not isinstance(value, (int, float)):
                errors.append(f"event {i}: non-numeric {key}")
            elif value < 0:
                errors.append(f"event {i}: negative {key}")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                errors.append(f"event {i}: non-integer {key}")
        args = ev.get("args")
        if not isinstance(args, dict) or not args.get("span_id"):
            errors.append(f"event {i}: args.span_id missing")
            continue
        if any(key in args for key in PRINCIPAL_KEYS):
            missing = [k for k in PRINCIPAL_KEYS if k not in args]
            if missing:
                errors.append(
                    f"event {i} ({ev.get('name')}): partial "
                    f"principal tags, missing {missing}"
                )
            purpose = args.get("principal_purpose")
            if (purpose is not None
                    and purpose not in PRINCIPAL_PURPOSES):
                errors.append(
                    f"event {i} ({ev.get('name')}): "
                    f"principal_purpose {purpose!r} outside the "
                    "closed enum"
                )
        span = {
            "name": ev.get("name"),
            "role": ev.get("cat"),
            "span_id": args.get("span_id"),
            "parent_id": args.get("parent_id"),
            "trace_id": args.get("trace_id"),
            "pid": ev.get("pid"),
        }
        spans[span["span_id"]] = span
        if span["parent_id"]:
            children.setdefault(span["parent_id"], []).append(span)

    used_pids = {s["pid"] for s in spans.values()}
    unnamed = used_pids - named_pids
    if unnamed:
        errors.append(
            f"pids without process_name metadata: {sorted(unnamed)}"
        )

    # Parent links must resolve within the file (a dangling parent_id is
    # fine only for spans whose parent fell off the flight-recorder
    # ring — tolerated, but the task tree below must be fully linked).
    task_ok = False
    best_roles = set()
    for span in spans.values():
        if span["name"] != "task":
            continue
        roles = set()
        todo = [span]
        while todo:
            node = todo.pop()
            roles.add(node["role"])
            todo.extend(children.get(node["span_id"], ()))
        if roles >= set(required_roles):
            task_ok = True
            break
        if len(roles) > len(best_roles):
            best_roles = roles
    if not task_ok:
        errors.append(
            "no task span tree crosses roles "
            f"{list(required_roles)} (best tree covered "
            f"{sorted(best_roles) or 'no task spans at all'})"
        )
    return errors


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        print("usage: check_trace.py TRACE.json", file=sys.stderr)
        return 2
    errors = check_trace(argv[0])
    if errors:
        for err in errors:
            print(f"check_trace: {err}", file=sys.stderr)
        print(f"{argv[0]}: FAILED ({len(errors)} error(s))",
              file=sys.stderr)
        return 1
    print(f"{argv[0]}: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
