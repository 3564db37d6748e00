#!/usr/bin/env python
"""Schema-check an incident bundle written by
``observability/slo.IncidentRecorder``.

Usage::

    python -m elasticdl_tpu_torch.tools.check_incident INCIDENT_DIR
    python -m elasticdl_tpu_torch.tools.check_incident PARENT_DIR

(one bundle, or the newest bundle inside). The port's copy of
``tools/check_incident.py``: the same checks, messages and exit codes;
it reads either package's bundles.

A bundle is the black box an SLO alert leaves behind; this validates
that it is actually usable at 9 a.m. (returning a list of
human-readable errors, empty = pass):

- ``alert.json``: the firing rule state — rule name, kind, firing
  flag, capture timestamp, breach value;
- ``trace.json``: Perfetto-loadable Chrome ``trace_event`` JSON —
  well-formed ``X`` events (numeric ts/dur, integer pid/tid), every
  used pid carrying ``process_name`` metadata; an EMPTY event list is
  tolerated (a master without ``--flight_recorder`` collects no
  spans);
- ``critical_path.json``: the p99 attribution report
  (``span_count``/``trace_count`` present);
- ``series.json``: a NON-EMPTY time-series window around the breach —
  at least one series with at least one point, and the rule's own
  series family present when the store sampled it;
- ``journal_tail.json``: present and well-formed (an empty record list
  is fine — journal-less masters still bundle);
- ``profile.json``: when present and non-empty, every component's
  flame window passes the port's ``tools/check_profile.py``; with
  ``--require-profile`` an empty/missing capture FAILS (a fleet run
  with ``--profile_hz`` must leave flame tables in its black box);
- ``exemplars.json``: when present, well-formed exemplar entries
  (value + trace id per breached-series bucket); with
  ``--require-exemplars`` at least one entry must exist AND resolve to
  a span recorded in ``trace.json`` — the metric→trace link the
  bundle exists for.

Stdlib only, importable from tests (``check_incident(path)``).
"""

import json
import os
import sys
from typing import List, Optional

from elasticdl_tpu_torch.tools.check_profile import check_bundle_profile


def _load(bundle: str, name: str, errors: List[str]) -> Optional[dict]:
    path = os.path.join(bundle, name)
    if not os.path.exists(path):
        errors.append(f"{name}: missing")
        return None
    try:
        with open(path) as fh:
            return json.load(fh)
    except ValueError as exc:
        errors.append(f"{name}: invalid JSON ({exc})")
        return None


def _check_trace_events(trace: dict, errors: List[str]):
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        errors.append("trace.json: traceEvents missing")
        return
    # An EMPTY event list is legitimate: a master running with
    # --incident_dir but no --flight_recorder collects no spans, and
    # its bundle (series window, attribution, journal tail) is still
    # the 2 a.m. artifact — Perfetto loads an empty trace fine. The
    # same tolerance the journal-tail check gives journal-less
    # masters.
    if not events:
        return
    named_pids = set()
    used_pids = set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"trace.json: event {i} not an object")
            continue
        ph = ev.get("ph")
        if ph == "M":
            if ev.get("name") == "process_name":
                named_pids.add(ev.get("pid"))
            continue
        if ph != "X":
            errors.append(f"trace.json: event {i} unexpected ph {ph!r}")
            continue
        for key in ("ts", "dur"):
            if not isinstance(ev.get(key), (int, float)):
                errors.append(
                    f"trace.json: event {i} non-numeric {key}"
                )
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                errors.append(
                    f"trace.json: event {i} non-integer {key}"
                )
        used_pids.add(ev.get("pid"))
    unnamed = used_pids - named_pids
    if unnamed:
        errors.append(
            "trace.json: pids without process_name metadata: "
            f"{sorted(unnamed)}"
        )


def _trace_ids_in(trace: Optional[dict]) -> set:
    """Trace ids of every span event in a chrome_trace payload (the
    exporter stamps them into event args)."""
    ids = set()
    for ev in (trace or {}).get("traceEvents", []) or []:
        if isinstance(ev, dict) and ev.get("ph") == "X":
            tid = (ev.get("args") or {}).get("trace_id")
            if tid:
                ids.add(str(tid))
    return ids


def _check_exemplars(payload, trace: Optional[dict],
                     require: bool, errors: List[str]):
    if not isinstance(payload, dict):
        errors.append("exemplars.json: not an object")
        return
    entries = payload.get("exemplars")
    if not isinstance(entries, list):
        errors.append("exemplars.json: 'exemplars' not a list")
        return
    trace_ids = set()
    for i, entry in enumerate(entries):
        if not isinstance(entry, dict):
            errors.append(f"exemplars.json: entry {i} not an object")
            continue
        if not entry.get("trace_id"):
            errors.append(f"exemplars.json: entry {i} has no trace_id")
            continue
        if not isinstance(entry.get("value"), (int, float)):
            errors.append(
                f"exemplars.json: entry {i} has no numeric value"
            )
        trace_ids.add(str(entry["trace_id"]))
    if not require:
        return
    if not trace_ids:
        errors.append(
            "exemplars.json: no exemplar captured for the breached "
            "series (are its histograms exemplar-enabled and traced?)"
        )
        return
    resolved = trace_ids & _trace_ids_in(trace)
    if not resolved:
        errors.append(
            "exemplars.json: no exemplar trace id resolves to a span "
            f"in trace.json ({len(trace_ids)} exemplar trace ids, "
            f"{len(_trace_ids_in(trace))} trace ids in the timeline)"
        )


def check_incident(bundle: str, require_profile: bool = False,
                   require_exemplars: bool = False) -> List[str]:
    errors: List[str] = []
    if not os.path.isdir(bundle):
        return [f"{bundle}: not a directory"]

    alert = _load(bundle, "alert.json", errors)
    rule_series = None
    if alert is not None:
        state = alert.get("alert")
        if not isinstance(state, dict):
            errors.append("alert.json: no 'alert' rule state")
        else:
            for key in ("rule", "kind", "firing"):
                if key not in state:
                    errors.append(f"alert.json: alert.{key} missing")
            rule_series = state.get("series")
        if not isinstance(alert.get("captured_at"), (int, float)):
            errors.append("alert.json: captured_at missing")

    trace = _load(bundle, "trace.json", errors)
    if trace is not None:
        _check_trace_events(trace, errors)

    cp = _load(bundle, "critical_path.json", errors)
    if cp is not None:
        for key in ("span_count", "trace_count"):
            if key not in cp:
                errors.append(f"critical_path.json: {key} missing")

    series = _load(bundle, "series.json", errors)
    if series is not None:
        entries = series.get("series")
        if not isinstance(entries, dict) or not entries:
            errors.append("series.json: empty series window")
        else:
            total_points = sum(
                len(entry.get("points", ())) for entry in entries.values()
            )
            if total_points == 0:
                errors.append("series.json: series hold zero points")
            if rule_series and not any(
                entry.get("family") == rule_series
                for entry in entries.values()
            ):
                errors.append(
                    f"series.json: breached family {rule_series!r} "
                    "not in the captured window"
                )

    tail = _load(bundle, "journal_tail.json", errors)
    if tail is not None and not isinstance(tail.get("records"), list):
        errors.append("journal_tail.json: 'records' not a list")

    # Continuous-profiling additions (older bundles predate them:
    # absent files only fail under the require flags).
    profile_path = os.path.join(bundle, "profile.json")
    if os.path.exists(profile_path):
        profile = _load(bundle, "profile.json", errors)
        if profile is not None:
            has_components = bool(profile.get("components"))
            if has_components:
                errors.extend(check_bundle_profile(profile))
            elif require_profile:
                errors.append(
                    "profile.json: no component carries profile "
                    "windows (is anything running --profile_hz?)"
                )
    elif require_profile:
        errors.append("profile.json: missing")

    exemplars_path = os.path.join(bundle, "exemplars.json")
    if os.path.exists(exemplars_path):
        exemplars = _load(bundle, "exemplars.json", errors)
        if exemplars is not None:
            _check_exemplars(
                exemplars, trace, require_exemplars, errors
            )
    elif require_exemplars:
        errors.append("exemplars.json: missing")
    return errors


def newest_bundle(parent: str) -> Optional[str]:
    """Newest ``incident_*`` directory under ``parent`` (mtime order),
    or None."""
    candidates = [
        os.path.join(parent, name)
        for name in os.listdir(parent)
        if name.startswith("incident_")
        and os.path.isdir(os.path.join(parent, name))
    ]
    if not candidates:
        return None
    return max(candidates, key=os.path.getmtime)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    require_profile = "--require-profile" in argv
    require_exemplars = "--require-exemplars" in argv
    unknown = [
        a for a in argv
        if a.startswith("--")
        and a not in ("--require-profile", "--require-exemplars")
    ]
    if unknown:
        # A typo'd flag must fail loudly, not silently run the check
        # without the strictness it was meant to enforce.
        print(f"check_incident: unknown flag(s) {unknown}",
              file=sys.stderr)
        return 2
    argv = [a for a in argv if not a.startswith("--")]
    if len(argv) != 1:
        print("usage: check_incident.py [--require-profile] "
              "[--require-exemplars] INCIDENT_DIR", file=sys.stderr)
        return 2
    path = argv[0]
    if os.path.isdir(path) and not os.path.exists(
        os.path.join(path, "alert.json")
    ):
        # A parent directory: check the newest bundle inside it.
        bundle = newest_bundle(path)
        if bundle is None:
            print(f"{path}: no incident_* bundle inside",
                  file=sys.stderr)
            return 1
        path = bundle
    errors = check_incident(
        path, require_profile=require_profile,
        require_exemplars=require_exemplars,
    )
    if errors:
        for err in errors:
            print(f"check_incident: {err}", file=sys.stderr)
        print(f"{path}: FAILED ({len(errors)} error(s))",
              file=sys.stderr)
        return 1
    print(f"{path}: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
