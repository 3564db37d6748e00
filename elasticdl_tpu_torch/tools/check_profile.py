#!/usr/bin/env python
"""Schema-check continuous-profiling output
(``observability/profiler.py``).

Usage::

    python -m elasticdl_tpu_torch.tools.check_profile PROFILE.json
    python -m elasticdl_tpu_torch.tools.check_profile INCIDENT_DIR

(a ``/profile`` body, or the ``profile.json`` of an incident bundle).

The port's copy of ``tools/check_profile.py``: the same checks,
messages and exit codes; it reads either package's windows.

Validates (returning a list of human-readable errors, empty = pass):

- **window**: ``t0 < t1``, positive ``hz``, positive ``sample_count``;
- **folded-stack schema**: every key is ``class;frame;...;frame`` with
  a positive integer count, the first segment naming a thread class
  (or the ``phases`` pseudo-class for span-derived stacks, or the
  overflow bucket);
- **sample-count consistency with window × hz**: the sampler takes at
  most ``(t1 - t0) × hz`` passes (slack for scheduler jitter), each
  pass contributes at most one sample per live thread — so per
  thread-class totals must fit ``passes × peak-threads-of-class``.
  Span-derived ``phases`` stacks are synthetic weights and exempt;
- **pprof JSON loadable**: the pprof-shaped export parses, its
  string-table indices resolve, and its sample counts mirror the
  folded table.

Stdlib only, importable from tests and ``tools/check_incident.py``
(``check_profile_payload`` / ``check_bundle_profile``).
"""

import json
import os
import sys
from typing import List

OVERFLOW_KEY = "__overflow__"
SPAN_CLASS = "phases"
# Scheduler jitter slack on the expected pass count: the sampler
# sleeps 1/hz BETWEEN walks, so it can only undershoot — the ceiling
# is tight, the floor is not checked.
PASS_SLACK = 1.5
PASS_SLOP = 5


def _check_samples(samples, window: dict, where: str,
                   errors: List[str]):
    if not isinstance(samples, dict) or not samples:
        errors.append(f"{where}: empty samples table")
        return
    t0 = float(window.get("t0", 0.0))
    t1 = float(window.get("t1", 0.0))
    hz = float(window.get("hz", 0.0))
    passes = int(window.get("sample_count", 0))
    if t1 <= t0:
        errors.append(f"{where}: window t1 {t1} <= t0 {t0}")
    if hz <= 0:
        errors.append(f"{where}: non-positive hz {hz}")
    if passes <= 0:
        errors.append(f"{where}: non-positive sample_count {passes}")
    if hz > 0 and t1 > t0:
        ceiling = (t1 - t0) * hz * PASS_SLACK + PASS_SLOP
        if passes > ceiling:
            errors.append(
                f"{where}: sample_count {passes} exceeds window×hz "
                f"ceiling {ceiling:.0f} "
                f"({t1 - t0:.1f}s at {hz:g} Hz)"
            )
    threads = window.get("threads") or {}
    per_class = {}
    for stack, count in samples.items():
        if not isinstance(stack, str) or not stack:
            errors.append(f"{where}: non-string stack key {stack!r}")
            continue
        if not isinstance(count, int) or count <= 0:
            errors.append(
                f"{where}: stack {stack!r} has non-positive/"
                f"non-integer count {count!r}"
            )
            continue
        if stack == OVERFLOW_KEY:
            continue
        parts = stack.split(";")
        if len(parts) < 2:
            errors.append(
                f"{where}: stack {stack!r} lacks a "
                "class;frame;... shape"
            )
            continue
        if any(not p for p in parts):
            errors.append(f"{where}: stack {stack!r} has empty frames")
        per_class[parts[0]] = per_class.get(parts[0], 0) + count
    # Per-class totals vs passes × peak threads of that class. Classes
    # the window never recorded a peak for (span-derived "phases",
    # threads that appeared only in other windows of a merge) are
    # exempt — the check is about the SAMPLER's arithmetic.
    for tclass, total in sorted(per_class.items()):
        if tclass == SPAN_CLASS:
            continue
        peak = threads.get(tclass)
        if peak is None:
            continue
        ceiling = passes * max(1, int(peak)) * PASS_SLACK + PASS_SLOP
        if total > ceiling:
            errors.append(
                f"{where}: class {tclass!r} holds {total} samples, "
                f"more than {passes} passes x {peak} threads "
                f"(ceiling {ceiling:.0f}) can produce"
            )


def _check_pprof(pprof, samples, where: str, errors: List[str]):
    if not isinstance(pprof, dict):
        errors.append(f"{where}: pprof not an object")
        return
    try:
        json.loads(json.dumps(pprof))
    except (TypeError, ValueError) as exc:
        errors.append(f"{where}: pprof not JSON-serializable ({exc})")
        return
    strings = pprof.get("string_table")
    if not isinstance(strings, list) or not strings:
        errors.append(f"{where}: pprof string_table missing")
        return
    if float(pprof.get("period", 0) or 0) <= 0:
        errors.append(f"{where}: pprof period missing/non-positive")
    entries = pprof.get("samples")
    if not isinstance(entries, list) or not entries:
        errors.append(f"{where}: pprof samples missing")
        return
    total = 0
    for i, entry in enumerate(entries):
        locs = entry.get("location_id")
        values = entry.get("value")
        if not isinstance(locs, list) or not locs:
            errors.append(f"{where}: pprof sample {i} has no stack")
            continue
        if any(
            not isinstance(at, int) or at < 0 or at >= len(strings)
            for at in locs
        ):
            errors.append(
                f"{where}: pprof sample {i} indexes outside the "
                "string table"
            )
        if (not isinstance(values, list) or not values
                or not isinstance(values[0], int)):
            errors.append(f"{where}: pprof sample {i} has no count")
            continue
        total += values[0]
    folded_total = sum(
        c for c in samples.values() if isinstance(c, int)
    ) if isinstance(samples, dict) else 0
    if folded_total and total != folded_total:
        errors.append(
            f"{where}: pprof total {total} != folded total "
            f"{folded_total}"
        )


def check_profile_payload(payload, where: str = "profile") -> List[str]:
    """Validate one ``/profile`` response body (or any dict carrying
    ``window`` (+ optional ``pprof``/``folded``))."""
    errors: List[str] = []
    if not isinstance(payload, dict):
        return [f"{where}: not an object"]
    if payload.get("error"):
        return [f"{where}: carries error {payload['error']!r}"]
    window = payload.get("window")
    if not isinstance(window, dict):
        return [f"{where}: no window"]
    _check_samples(window.get("samples"), window, where, errors)
    if "folded" in payload:
        folded = payload["folded"]
        if not isinstance(folded, str) or not folded.strip():
            errors.append(f"{where}: folded text empty")
        else:
            for ln, line in enumerate(folded.strip().splitlines()):
                stack, _, count = line.rpartition(" ")
                if not stack or not count.isdigit():
                    errors.append(
                        f"{where}: folded line {ln} not "
                        f"'stack count': {line!r}"
                    )
    if "pprof" in payload:
        _check_pprof(
            payload["pprof"], window.get("samples"), where, errors
        )
    return errors


def check_bundle_profile(payload) -> List[str]:
    """Validate an incident bundle's ``profile.json``
    (``IncidentRecorder`` / ``ProfileStore.bundle_capture`` shape):
    at least one component with a valid flame window."""
    errors: List[str] = []
    if not isinstance(payload, dict):
        return ["profile.json: not an object"]
    components = payload.get("components")
    if not isinstance(components, dict):
        return ["profile.json: 'components' missing"]
    if not components:
        return ["profile.json: no component carries profile windows"]
    for name, entry in sorted(components.items()):
        if not isinstance(entry, dict):
            errors.append(f"profile.json[{name}]: not an object")
            continue
        errors.extend(check_profile_payload(
            entry, where=f"profile.json[{name}]"
        ))
    return errors


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        print("usage: check_profile.py PROFILE.json | INCIDENT_DIR",
              file=sys.stderr)
        return 2
    path = argv[0]
    if os.path.isdir(path):
        path = os.path.join(path, "profile.json")
    try:
        with open(path) as fh:
            payload = json.load(fh)
    except (OSError, ValueError) as exc:
        print(f"check_profile: {path}: {exc}", file=sys.stderr)
        return 1
    if isinstance(payload, dict) and "components" in payload:
        errors = check_bundle_profile(payload)
    else:
        errors = check_profile_payload(payload)
    if errors:
        for err in errors:
            print(f"check_profile: {err}", file=sys.stderr)
        print(f"{path}: FAILED ({len(errors)} error(s))",
              file=sys.stderr)
        return 1
    print(f"{path}: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
