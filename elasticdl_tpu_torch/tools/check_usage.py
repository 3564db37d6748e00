"""Schema-check workload-attribution drill output
(``elasticdl_tpu_torch/chaos/usage_drill.py``), the port's copy of
``tools/check_usage.py``: the same checks, messages and exit codes (0
clean, 1 errors, 2 usage). Either package's report passes it.

Usage::

    python -m elasticdl_tpu_torch.tools.check_usage USAGE_DRILL.json
    python -m elasticdl_tpu_torch.tools.check_usage DRILL_DIR

Validates (returning a list of human-readable errors, empty = pass):

- **verdict**: ``passed`` true with an empty ``problems`` list, and
  every per-gate ``ok`` flag true;
- **latency gate**: at least one measurement attempt, positive p99s,
  and the accepted attempt's ratio really at or under the gate;
- **purity gate**: ``ingest_rows`` bytes only under
  ``purpose="migration"``, ``replica_refresh`` bytes only under
  ``purpose="replica_refresh"``, both with nonzero volume;
- **coverage gate**: ``attributed_handler_share`` in [0, 1] and at
  or above its gate;
- **usage summary shape**: non-negative totals, purpose keys drawn
  from the closed enum (plus ``unknown``), principal rows carrying
  the full ``{job, component, purpose}`` triple with shares in
  [0, 1], and a ``shards`` top-K block.

Stdlib only, importable from tests.
"""

import json
import os
import sys
from typing import List, Tuple

REPORT_NAME = "USAGE_DRILL.json"
# Closed purpose enum — mirror of observability/principal.py PURPOSES
# (+ the "unknown" fallback); stdlib-only tools keep their own copy.
PURPOSES = (
    "training", "serving_read", "migration", "replica_refresh",
    "replay", "checkpoint", "control", "streaming_ingest", "canary",
)
UNKNOWN = "unknown"
PURITY_WANT = {
    "ingest_rows": "migration",
    "replica_refresh": "replica_refresh",
}


def _check_latency(latency, errors: List[str]):
    if not isinstance(latency, dict):
        errors.append("latency: missing block")
        return
    gate = float(latency.get("gate", 0.0))
    if gate <= 1.0:
        errors.append(f"latency: implausible gate {gate}")
    attempts = latency.get("attempts") or []
    if not attempts:
        errors.append("latency: no measurement attempts")
        return
    for i, att in enumerate(attempts):
        for key in ("p99_baseline_s", "p99_attributed_s"):
            if float(att.get(key, 0.0)) <= 0:
                errors.append(f"latency attempt {i}: non-positive "
                              f"{key} {att.get(key)}")
    last = attempts[-1]
    if latency.get("ok") and float(last.get("ratio", 0.0)) > gate:
        errors.append(
            f"latency: marked ok but final ratio "
            f"{last.get('ratio')} > gate {gate}"
        )
    if not latency.get("ok"):
        errors.append("latency: gate not met")


def _check_purity(purity, errors: List[str]):
    if not isinstance(purity, dict):
        errors.append("purity: missing block")
        return
    purposes = purity.get("purposes_by_method") or {}
    volumes = purity.get("bytes_by_method") or {}
    for method, want in PURITY_WANT.items():
        seen = purposes.get(method)
        if seen != [want]:
            errors.append(
                f"purity: {method} bytes under purposes {seen}, "
                f"want only ['{want}']"
            )
        if float(volumes.get(method, 0.0)) <= 0:
            errors.append(f"purity: no {method} bytes flowed")
    if not purity.get("ok"):
        errors.append("purity: gate not met")


def _check_attribution(attribution, errors: List[str]):
    if not isinstance(attribution, dict):
        errors.append("attribution: missing block")
        return
    share = float(attribution.get("attributed_handler_share", -1.0))
    gate = float(attribution.get("gate", 0.0))
    if not 0.0 <= share <= 1.0 + 1e-9:
        errors.append(f"attribution: share {share} outside [0, 1]")
    if not 0.0 < gate <= 1.0:
        errors.append(f"attribution: implausible gate {gate}")
    if share < gate:
        errors.append(
            f"attribution: share {share} below gate {gate}"
        )


def _check_usage_summary(usage, errors: List[str]):
    if not isinstance(usage, dict):
        errors.append("usage: missing summary block")
        return
    totals = usage.get("totals") or {}
    for key, value in totals.items():
        if float(value) < 0:
            errors.append(f"usage: negative total {key}={value}")
    allowed = set(PURPOSES) | {UNKNOWN}
    for purpose, row in (usage.get("purposes") or {}).items():
        if purpose not in allowed:
            errors.append(
                f"usage: purpose '{purpose}' outside the closed enum"
            )
        share = float(row.get("share", -1.0))
        if not 0.0 <= share <= 1.0 + 1e-9:
            errors.append(
                f"usage: purpose '{purpose}' share {share} "
                "outside [0, 1]"
            )
    for i, row in enumerate(usage.get("principals") or []):
        who = row.get("principal") or {}
        for field in ("job", "component", "purpose"):
            if field not in who:
                errors.append(
                    f"usage: principal row {i} missing '{field}'"
                )
        if who.get("purpose") not in allowed:
            errors.append(
                f"usage: principal row {i} purpose "
                f"'{who.get('purpose')}' outside the closed enum"
            )
        for key, share in (row.get("share") or {}).items():
            if not 0.0 <= float(share) <= 1.0 + 1e-9:
                errors.append(
                    f"usage: principal row {i} share {key}={share} "
                    "outside [0, 1]"
                )
    if "shards" not in usage:
        errors.append("usage: missing per-shard top-K block")


def check_usage(path: str) -> Tuple[List[str], dict]:
    """Validate one USAGE_DRILL.json (or a dir containing it)."""
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
    if report.get("drill") != "workload_attribution":
        errors.append(
            f"unexpected drill kind: {report.get('drill')!r}"
        )
    if not report.get("passed"):
        errors.append("drill did not pass")
    for problem in report.get("problems") or []:
        errors.append(f"recorded problem: {problem}")
    _check_latency(report.get("latency"), errors)
    _check_purity(report.get("purity"), errors)
    _check_attribution(report.get("attribution"), errors)
    _check_usage_summary(report.get("usage"), errors)
    return errors, report


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: check_usage.py USAGE_DRILL.json|DIR",
              file=sys.stderr)
        return 2
    errors, report = check_usage(argv[0])
    if errors:
        for err in errors:
            print(f"FAIL: {err}")
        return 1
    attribution = report.get("attribution", {})
    print(
        "OK: workload attribution drill "
        f"(share {attribution.get('attributed_handler_share', 0):.3f}"
        f", gate {attribution.get('gate', 0)})"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
