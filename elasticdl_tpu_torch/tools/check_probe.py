"""Schema-check synthetic-probe drill output
(``elasticdl_tpu_torch/chaos/probe_drill.py``), the port's copy of
``tools/check_probe.py``: the same checks, messages and exit codes (0
clean, 1 errors, 2 usage). Either package's report passes it.

Usage::

    python -m elasticdl_tpu_torch.tools.check_probe PROBE_DRILL.json
    python -m elasticdl_tpu_torch.tools.check_probe DRILL_DIR

Validates (returning a list of human-readable errors, empty = pass):

- **verdict**: ``passed`` true with an empty ``problems`` list;
- **coverage**: all five shipped probes configured, and all three
  fault windows present;
- **detection**: every window red the MATCHING probe within the
  drill's tick bound (``within_bound``) and re-greened after repair
  (``recover_ticks`` set) — the prober detects each outage from
  outside, fast, and the verdict clears when the plane heals;
- **zero false positives**: the kill-free twin ran its full tick
  budget with zero probe failures, and its timeline exercises every
  probe;
- **incident linkage**: each window's red transition captured an
  incident bundle carrying a non-empty trace id;
- **attribution**: canary traffic metered in /usage (>0 requests
  under the canary job) with zero purpose/job violations;
- **keyspace contract**: the drill ran against the RESERVED canary
  keyspace — base ``2**62``, span ``2**20`` — so the synthetic
  traffic could not have perturbed real training rows.

Stdlib only, importable from tests.
"""

import json
import os
import sys
from typing import List, Tuple

REPORT_NAME = "PROBE_DRILL.json"

EXPECTED_PROBES = (
    "row_ryw", "serving_freshness", "reshard_convergence",
    "stream_watermark", "dispatch_roundtrip",
)
EXPECTED_WINDOWS = {
    "row_shard_kill": "row_ryw",
    "serving_stall": "serving_freshness",
    "master_kill": "dispatch_roundtrip",
}
CANARY_ID_BASE = 1 << 62
CANARY_ID_SPAN = 1 << 20


def _check_config(report, errors: List[str]):
    config = report.get("config") or {}
    probes = list(config.get("probes") or [])
    for probe in EXPECTED_PROBES:
        if probe not in probes:
            errors.append(f"config: probe {probe} not configured")
    if int(config.get("canary_id_base", -1)) != CANARY_ID_BASE:
        errors.append(
            "config: canary_id_base is "
            f"{config.get('canary_id_base')!r}, expected 2**62 — "
            "synthetic traffic may collide with real ids"
        )
    if int(config.get("canary_id_span", -1)) != CANARY_ID_SPAN:
        errors.append(
            "config: canary_id_span is "
            f"{config.get('canary_id_span')!r}, expected 2**20"
        )
    if int(config.get("detect_bound_ticks", 0)) <= 0:
        errors.append("config: detect_bound_ticks missing")


def _check_windows(report, errors: List[str]):
    faulted = report.get("faulted") or {}
    windows = {
        w.get("window"): w for w in faulted.get("windows") or []
    }
    for window, probe in EXPECTED_WINDOWS.items():
        entry = windows.get(window)
        if entry is None:
            errors.append(f"faulted: window {window} missing")
            continue
        if entry.get("probe") != probe:
            errors.append(
                f"faulted: window {window} gated probe "
                f"{entry.get('probe')!r}, expected {probe}"
            )
        if not entry.get("within_bound"):
            errors.append(
                f"faulted: window {window} did not red {probe} "
                "within the tick bound"
            )
        detect = entry.get("detect_ticks")
        if not isinstance(detect, int) or detect < 1:
            errors.append(
                f"faulted: window {window} detect_ticks "
                f"{detect!r} invalid"
            )
        recover = entry.get("recover_ticks")
        if not isinstance(recover, int) or recover < 1:
            errors.append(
                f"faulted: window {window} never re-greened "
                f"(recover_ticks {recover!r})"
            )


def _check_twin(report, errors: List[str]):
    twin = report.get("twin") or {}
    ticks = twin.get("ticks")
    if not isinstance(ticks, int) or ticks < 1:
        errors.append(f"twin: no ticks recorded ({ticks!r})")
        return
    if twin.get("failures") != 0:
        errors.append(
            f"twin: {twin.get('failures')!r} probe failure(s) with "
            "no fault injected (false positives)"
        )
    exercised = set()
    for entry in twin.get("timeline") or []:
        results = entry.get("results") or {}
        exercised |= set(results)
        for probe, verdict in results.items():
            if verdict != "ok":
                errors.append(
                    f"twin: probe {probe} failed ({verdict}) in a "
                    "kill-free run"
                )
    for probe in EXPECTED_PROBES:
        if probe not in exercised:
            errors.append(f"twin: probe {probe} never exercised")


def _check_incidents(report, errors: List[str]):
    incidents = (report.get("faulted") or {}).get("incidents") or {}
    for probe in EXPECTED_WINDOWS.values():
        entry = incidents.get(probe)
        if not isinstance(entry, dict):
            errors.append(
                f"incidents: no bundle recorded for probe {probe}"
            )
        elif not entry.get("trace_id"):
            errors.append(
                f"incidents: bundle for probe {probe} carries no "
                "trace id"
            )


def _check_usage(report, errors: List[str]):
    usage = report.get("usage") or {}
    if int(usage.get("canary_requests", 0)) <= 0:
        errors.append(
            "usage: no canary-principal requests metered — "
            "probe traffic is invisible to attribution"
        )
    for violation in usage.get("violations") or []:
        errors.append(f"usage: {violation}")


def check_probe(path: str) -> Tuple[List[str], dict]:
    """Validate one PROBE_DRILL.json (or a dir containing it)."""
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
    if report.get("drill") != "probe":
        errors.append(
            f"unexpected drill kind: {report.get('drill')!r}"
        )
    if not report.get("passed"):
        errors.append("drill did not pass")
    for problem in report.get("problems") or []:
        errors.append(f"recorded problem: {problem}")
    _check_config(report, errors)
    _check_windows(report, errors)
    _check_twin(report, errors)
    _check_incidents(report, errors)
    _check_usage(report, errors)
    return errors, report


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: check_probe.py PROBE_DRILL.json|DIR",
              file=sys.stderr)
        return 2
    errors, report = check_probe(argv[0])
    if errors:
        for err in errors:
            print(f"FAIL: {err}")
        return 1
    windows = (report.get("faulted") or {}).get("windows") or []
    detail = ", ".join(
        f"{w.get('window')}→{w.get('probe')} in "
        f"{w.get('detect_ticks')} tick(s)"
        for w in windows
    )
    twin = report.get("twin") or {}
    print(
        "OK: synthetic-probe drill "
        f"({detail}; twin {twin.get('ticks', 0)} tick(s) all green; "
        f"{(report.get('usage') or {}).get('canary_requests', 0)} "
        "canary requests metered)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
