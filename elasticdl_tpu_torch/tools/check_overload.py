"""Schema-check brownout drill output
(``elasticdl_tpu_torch/chaos/brownout_drill.py``), the port's copy of
``tools/check_overload.py``: the same checks, messages and exit codes
(0 clean, 1 errors, 2 usage). Either package's report passes it.

Usage::

    python -m elasticdl_tpu_torch.tools.check_overload BROWNOUT_DRILL.json
    python -m elasticdl_tpu_torch.tools.check_overload DRILL_DIR

Validates (returning a list of human-readable errors, empty = pass):

- **verdict**: ``passed`` true, empty ``problems``, every gate row
  carrying a true ``passed`` flag, and the full gate set present
  (no gate silently dropped by a drill edit);
- **controlled run, re-derived from the raw numbers** (not just the
  recorded verdicts): brownout serving p99 within
  ``max_p99_ratio x baseline`` (or the absolute floor), zero
  serving_read sheds with the background-purpose shed fraction at or
  above ``min_background_shed_frac``, total brownout retry
  amplification at or under ``max_amplification``, and 100% per-purpose
  goodput in the recovery window;
- **uncontrolled twin**: zero sheds, background amplification
  STRICTLY above the controlled cap, and the serving p99 inversion —
  the run that proves the controls are what hold the line;
- **stall**: both runs actually injected ``fsync_stall`` fires (a
  drill whose brownout never happened proves nothing);
- **shape**: per-purpose rows carry offered/ok/attempts with
  attempts >= offered >= ok >= 0, and purposes stay inside the
  closed principal enum.

Stdlib only, importable from tests.
"""

import json
import os
import sys
from typing import List, Tuple

REPORT_NAME = "BROWNOUT_DRILL.json"
# Closed purpose enum — mirror of observability/principal.py PURPOSES
# (+ "unknown"); stdlib-only tools keep their own copy.
PURPOSES = (
    "training", "serving_read", "migration", "replica_refresh",
    "replay", "checkpoint", "control", "streaming_ingest", "canary",
)
UNKNOWN = "unknown"
# Mirror of comm/overload.py BACKGROUND_PURPOSES.
BACKGROUND = ("migration", "replica_refresh", "checkpoint", "replay",
              "canary")
EXPECTED_GATES = (
    "controlled_serving_p99",
    "controlled_sheds_background_frac",
    "controlled_amplification",
    "controlled_recovery_goodput",
    "uncontrolled_no_sheds",
    "uncontrolled_background_amplification",
    "uncontrolled_serving_inversion",
)


def _purpose_rows(window) -> dict:
    if not isinstance(window, dict):
        return {}
    return {p: row for p, row in window.items()
            if p != "_total" and isinstance(row, dict)}


def _check_window_shape(mode: str, name: str, window,
                        errors: List[str]):
    if not isinstance(window, dict):
        errors.append(f"{mode}: missing '{name}' window")
        return
    allowed = set(PURPOSES) | {UNKNOWN}
    rows = _purpose_rows(window)
    if not rows:
        errors.append(f"{mode}.{name}: no per-purpose rows")
    for purpose, row in rows.items():
        if purpose not in allowed:
            errors.append(f"{mode}.{name}: purpose '{purpose}' "
                          "outside the closed enum")
        offered = float(row.get("offered", -1))
        ok = float(row.get("ok", -1))
        attempts = float(row.get("attempts", -1))
        if not 0 <= ok <= offered <= attempts:
            errors.append(
                f"{mode}.{name}.{purpose}: inconsistent counts "
                f"ok={ok} offered={offered} attempts={attempts}"
            )
    total = window.get("_total") or {}
    if float(total.get("offered", 0)) <= 0:
        errors.append(f"{mode}.{name}: empty _total")


def _serving_bound(config: dict, baseline) -> float:
    p99 = float(_purpose_rows(baseline).get(
        "serving_read", {}
    ).get("p99_secs", 0.0))
    return max(float(config.get("max_p99_ratio", 0.0)) * p99,
               float(config.get("p99_abs_floor_secs", 0.0)))


def _check_controlled(config: dict, run, errors: List[str]):
    if not isinstance(run, dict):
        errors.append("controlled: missing run block")
        return
    for name in ("baseline", "brownout", "recovery"):
        _check_window_shape("controlled", name, run.get(name), errors)
    if int(run.get("stall_fired", 0)) <= 0:
        errors.append("controlled: fsync_stall never fired")

    bound = _serving_bound(config, run.get("baseline"))
    p99 = float(_purpose_rows(run.get("brownout")).get(
        "serving_read", {}
    ).get("p99_secs", 1e9))
    if bound <= 0:
        errors.append("controlled: degenerate serving p99 bound")
    elif p99 > bound:
        errors.append(
            f"controlled: brownout serving p99 {p99} exceeds "
            f"bound {bound}"
        )

    sheds = run.get("sheds") or {}
    total = sum(int(n) for n in sheds.values())
    background = sum(int(n) for p, n in sheds.items()
                     if p in BACKGROUND)
    want_frac = float(config.get("min_background_shed_frac", 1.0))
    if total <= 0:
        errors.append("controlled: admission gate never shed")
    elif background / total < want_frac:
        errors.append(
            f"controlled: background shed fraction "
            f"{background / total:.3f} below {want_frac}"
        )
    if int(sheds.get("serving_read", 0)) != 0:
        errors.append(
            f"controlled: {sheds['serving_read']} serving_read "
            "sheds (priority order violated)"
        )

    amp = float((run.get("brownout") or {}).get(
        "_total", {}
    ).get("amplification", 1e9))
    cap = float(config.get("max_amplification", 0.0))
    if amp > cap:
        errors.append(
            f"controlled: brownout amplification {amp} exceeds "
            f"cap {cap}"
        )

    for purpose, row in _purpose_rows(run.get("recovery")).items():
        if int(row.get("ok", 0)) < int(row.get("offered", 0)):
            errors.append(
                f"controlled: recovery goodput for {purpose} is "
                f"{row.get('ok')}/{row.get('offered')}, want 100%"
            )


def _check_uncontrolled(config: dict, run, errors: List[str]):
    if not isinstance(run, dict):
        errors.append("uncontrolled: missing run block")
        return
    for name in ("baseline", "brownout"):
        _check_window_shape("uncontrolled", name, run.get(name),
                            errors)
    if int(run.get("stall_fired", 0)) <= 0:
        errors.append("uncontrolled: fsync_stall never fired")
    sheds = run.get("sheds") or {}
    if sum(int(n) for n in sheds.values()) != 0:
        errors.append(
            f"uncontrolled: sheds recorded with admission off "
            f"({sheds})"
        )
    brownout = _purpose_rows(run.get("brownout"))
    bg_amp = max(
        (float(brownout.get(p, {}).get("amplification", 0.0))
         for p in BACKGROUND), default=0.0,
    )
    cap = float(config.get("max_amplification", 0.0))
    if bg_amp <= cap:
        errors.append(
            f"uncontrolled: background amplification {bg_amp} "
            f"never exceeded the {cap} cap the controls enforce"
        )
    bound = _serving_bound(config, run.get("baseline"))
    p99 = float(brownout.get("serving_read", {}).get("p99_secs", 0.0))
    if p99 <= bound:
        errors.append(
            f"uncontrolled: serving p99 {p99} within bound {bound} "
            "— no inversion, the controls proved nothing"
        )


def check_overload(path: str) -> Tuple[List[str], dict]:
    """Validate one BROWNOUT_DRILL.json (or a dir containing it)."""
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
    if report.get("drill") != "brownout":
        errors.append(
            f"unexpected drill kind: {report.get('drill')!r}"
        )
    if not report.get("passed"):
        errors.append("drill did not pass")
    for problem in report.get("problems") or []:
        errors.append(f"recorded problem: {problem}")
    gates = {g.get("name"): g for g in report.get("gates") or []}
    for name in EXPECTED_GATES:
        gate = gates.get(name)
        if gate is None:
            errors.append(f"gate '{name}' missing from report")
        elif not gate.get("passed"):
            errors.append(f"gate '{name}' recorded as failed")
    config = report.get("config") or {}
    runs = report.get("runs") or {}
    _check_controlled(config, runs.get("controlled"), errors)
    _check_uncontrolled(config, runs.get("uncontrolled"), errors)
    return errors, report


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: check_overload.py BROWNOUT_DRILL.json|DIR",
              file=sys.stderr)
        return 2
    errors, report = check_overload(argv[0])
    if errors:
        for err in errors:
            print(f"FAIL: {err}")
        return 1
    sheds = (report.get("runs", {}).get("controlled", {})
             .get("sheds", {}))
    total = sum(int(n) for n in sheds.values())
    background = sum(int(n) for p, n in sheds.items()
                     if p in BACKGROUND)
    print(
        "OK: brownout drill "
        f"(sheds {total}, background {background / max(1, total):.3f}"
        ", serving p99 "
        f"{report['runs']['controlled']['brownout']['serving_read']['p99_secs']}s)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
