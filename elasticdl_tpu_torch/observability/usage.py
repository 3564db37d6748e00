"""Per-principal usage metering and the fleet-wide ``/usage`` view.

A copy of elasticdl_tpu/observability/usage.py: the port keeps its own.

The metering half runs in the serving paths (the RPC server wrap and
the row-service handlers) and turns each request's ambient principal
(``principal.py``) into labeled counter increments on the process
registry:

======================================  ===============================
family (``edl_tpu_`` prefixed)          meaning
======================================  ===============================
``usage_requests_total``                requests served, by principal
                                        and method
``usage_rows_total``                    rows moved (pull + push +
                                        ingest + replica), by principal
                                        and method
``usage_bytes_total``                   payload bytes moved, same axes
``usage_lock_hold_seconds_total``       row-service table-lock hold
                                        time, by principal
``usage_fsync_wait_seconds_total``      durable-ack fsync wait
                                        (push-log group commit), by
                                        principal
``usage_cold_fault_rows_total``         rows faulted from the cold
``usage_cold_fault_seconds_total``      tier + the fault I/O time, by
                                        principal
``usage_handler_seconds``               handler wall time histogram,
                                        by purpose and method (bounded
                                        axes; feeds SLO-per-purpose
                                        burn rules and the drill's
                                        non-``unknown`` share gate)
======================================  ===============================

Label cardinality is bounded: ``purpose`` is the closed enum,
``component`` is one of a handful of process roles, and ``job`` — the
one free-form axis — folds to ``__other__`` once ``MAX_JOBS`` distinct
values have been seen (``fold_job``; profiler-style overflow bucket),
so a job-id churn storm cannot grow the registry without bound.

The aggregation half (``summarize_usage``) runs at the master's
metrics plane: it merges the ``usage_*`` families across every
reporter snapshot plus the master's own registry into per-principal
totals, shares, and top-K consumers per shard — the ``/usage``
endpoint's body and the substrate the fair-share scheduler PR will
arbitrate with (ROADMAP).

Families resolve through ``default_registry()`` per call, like
``rpc._retry_counter`` — a dict hit, and a test's registry reset can't
strand cached series.
"""

import time
from threading import Lock
from typing import Dict, List, Optional

from elasticdl_tpu_torch.observability import principal as _principal
from elasticdl_tpu_torch.observability.registry import default_registry

OTHER_JOB = "__other__"
# Default job-label budget; a multi-tenant fleet raises it via
# --usage_max_jobs / set_max_jobs (a legitimately multi-job master
# must not fold real tenants into __other__).
MAX_JOBS = 32
_max_jobs = MAX_JOBS


def set_max_jobs(n: Optional[int]):
    """Override the job-label fold budget (``--usage_max_jobs``).
    ``None`` or 0 restores the ``MAX_JOBS`` default. Raising the cap
    takes effect immediately; lowering it does not un-admit jobs
    already granted a series (their budget is spent)."""
    global _max_jobs
    _max_jobs = int(n) if n else MAX_JOBS
    if _max_jobs <= 0:
        _max_jobs = MAX_JOBS


def max_jobs() -> int:
    return _max_jobs

# Handler-time buckets: 100µs .. 5s — RPC handlers, not jobs.
HANDLER_BUCKETS = (0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05,
                   0.1, 0.5, 1.0, 5.0)

_PRINCIPAL_LABELS = ["job", "component", "purpose"]

# job-fold state, keyed to the registry generation so a reset starts a
# fresh budget (the folded-to series died with the families).
_fold_lock = Lock()
_fold_generation = -1
_fold_jobs: set = set()


def fold_job(job: str, registry=None) -> str:
    """Bound the free-form job label: the first ``max_jobs()`` distinct
    values pass through (default ``MAX_JOBS``; --usage_max_jobs
    raises it), everything after folds to ``__other__``. ``unknown``
    and ``__other__`` ride free (absence/overflow values must never
    consume budget)."""
    global _fold_generation, _fold_jobs
    job = str(job)
    if job == _principal.UNKNOWN or job == OTHER_JOB:
        return job
    registry = registry if registry is not None else default_registry()
    with _fold_lock:
        if registry.generation != _fold_generation:
            _fold_generation = registry.generation
            _fold_jobs = set()
        if job in _fold_jobs:
            return job
        if len(_fold_jobs) < _max_jobs:
            _fold_jobs.add(job)
            return job
        return OTHER_JOB


def _labels(principal: Optional["_principal.Principal"]):
    if principal is None:
        principal = _principal.NOBODY
    return (fold_job(principal.job), principal.component,
            principal.purpose)


def _requests():
    return default_registry().counter(
        "usage_requests_total",
        "RPCs served, by workload principal and method",
        _PRINCIPAL_LABELS + ["method"],
    )


def _rows():
    return default_registry().counter(
        "usage_rows_total",
        "Embedding rows moved, by workload principal and method",
        _PRINCIPAL_LABELS + ["method"],
    )


def _bytes():
    return default_registry().counter(
        "usage_bytes_total",
        "Payload bytes moved, by workload principal and method",
        _PRINCIPAL_LABELS + ["method"],
    )


def _lock_hold():
    return default_registry().counter(
        "usage_lock_hold_seconds_total",
        "Row-service table-lock hold time, by workload principal",
        _PRINCIPAL_LABELS,
    )


def _fsync_wait():
    return default_registry().counter(
        "usage_fsync_wait_seconds_total",
        "Durable-ack fsync wait (push-log group commit), by workload "
        "principal",
        _PRINCIPAL_LABELS,
    )


def _fault_rows():
    return default_registry().counter(
        "usage_cold_fault_rows_total",
        "Rows faulted in from the cold tier, by workload principal",
        _PRINCIPAL_LABELS,
    )


def _fault_seconds():
    return default_registry().counter(
        "usage_cold_fault_seconds_total",
        "Cold-tier fault I/O time, by workload principal",
        _PRINCIPAL_LABELS,
    )


def _handler_seconds():
    return default_registry().histogram(
        "usage_handler_seconds",
        "RPC handler wall time, by purpose and method (bounded axes "
        "for SLO-per-purpose burn rules)",
        ["purpose", "method"],
        buckets=HANDLER_BUCKETS,
    )


def meter_request(principal, method: str, seconds: float):
    """One served request: count it and observe handler wall time.
    Called by the generic RPC server wrap (``comm/rpc.py``) — covers
    the master and the row tier uniformly."""
    if not _principal.enabled():
        return
    labels = _labels(principal)
    _requests().labels(*labels, str(method)).inc()
    _handler_seconds().labels(labels[2], str(method)).observe(
        float(seconds)
    )


def meter_rows(principal, method: str, rows: int = 0,
               nbytes: int = 0):
    if not _principal.enabled():
        return
    labels = _labels(principal)
    if rows:
        _rows().labels(*labels, str(method)).inc(int(rows))
    if nbytes:
        _bytes().labels(*labels, str(method)).inc(int(nbytes))


def meter_lock_hold(principal, seconds: float):
    if not _principal.enabled():
        return
    _lock_hold().labels(*_labels(principal)).inc(float(seconds))


def meter_fsync_wait(principal, seconds: float):
    if not _principal.enabled():
        return
    _fsync_wait().labels(*_labels(principal)).inc(float(seconds))


def meter_cold_fault(principal, rows: int, seconds: float):
    if not _principal.enabled():
        return
    labels = _labels(principal)
    if rows:
        _fault_rows().labels(*labels).inc(int(rows))
    _fault_seconds().labels(*labels).inc(float(seconds))


# ---- /usage aggregation -------------------------------------------------

_NS = "edl_tpu_"
_COUNTER_KEYS = {
    _NS + "usage_requests_total": "requests",
    _NS + "usage_rows_total": "rows",
    _NS + "usage_bytes_total": "bytes",
    _NS + "usage_lock_hold_seconds_total": "lock_hold_seconds",
    _NS + "usage_fsync_wait_seconds_total": "fsync_wait_seconds",
    _NS + "usage_cold_fault_rows_total": "cold_fault_rows",
    _NS + "usage_cold_fault_seconds_total": "cold_fault_seconds",
}
_HANDLER_FAMILY = _NS + "usage_handler_seconds"
_SHARE_KEYS = ("requests", "rows", "bytes", "lock_hold_seconds",
               "fsync_wait_seconds")


def _zero_totals() -> dict:
    out = {key: 0.0 for key in _COUNTER_KEYS.values()}
    out["handler_seconds"] = 0.0
    return out


def summarize_usage(snapshots: Dict[str, dict], top_k: int = 5) -> dict:
    """Fold ``usage_*`` families from reporter snapshots (reporter key
    -> ``registry.snapshot()`` form; the master passes its own registry
    under key ``""``) into the ``/usage`` body:

    - ``principals``: per-``(job, component, purpose)`` totals across
      the fleet plus each metric's share of its fleet total;
    - ``purposes``: handler-seconds by purpose with shares, and the
      ``attributed_handler_share`` (non-``unknown`` fraction — the
      drill's 95% gate reads this);
    - ``shards``: per-reporter top-K principals by bytes (requests as
      tiebreak) — who is hammering which shard;
    - ``totals``: the fleet-wide sums.
    """
    per_principal: Dict[tuple, dict] = {}
    per_purpose: Dict[str, float] = {}
    per_shard: Dict[str, Dict[tuple, dict]] = {}

    for reporter, snapshot in sorted(
            snapshots.items(), key=lambda kv: str(kv[0])):
        families = (snapshot or {}).get("families") or []
        shard_acc = per_shard.setdefault(str(reporter), {})
        for family in families:
            name = family.get("name")
            labelnames = family.get("labelnames") or []
            if name in _COUNTER_KEYS:
                key = _COUNTER_KEYS[name]
                for series in family.get("series") or []:
                    labels = dict(zip(labelnames,
                                      series.get("labels") or []))
                    who = (labels.get("job", _principal.UNKNOWN),
                           labels.get("component", _principal.UNKNOWN),
                           labels.get("purpose", _principal.UNKNOWN))
                    value = float(series.get("value") or 0.0)
                    acc = per_principal.setdefault(who, _zero_totals())
                    acc[key] += value
                    sacc = shard_acc.setdefault(who, _zero_totals())
                    sacc[key] += value
            elif name == _HANDLER_FAMILY:
                for series in family.get("series") or []:
                    labels = dict(zip(labelnames,
                                      series.get("labels") or []))
                    purpose = labels.get("purpose", _principal.UNKNOWN)
                    secs = float(series.get("sum") or 0.0)
                    per_purpose[purpose] = (
                        per_purpose.get(purpose, 0.0) + secs
                    )

    totals = _zero_totals()
    for acc in per_principal.values():
        for key in _COUNTER_KEYS.values():
            totals[key] += acc[key]
    handler_total = sum(per_purpose.values())
    totals["handler_seconds"] = handler_total

    # handler_seconds is purpose-axis only (the histogram is
    # deliberately job-free): principal rows carry the counter axes,
    # the purposes block carries handler time.
    principals: List[dict] = []
    for who in sorted(per_principal):
        acc = per_principal[who]
        share = {
            key: (acc[key] / totals[key]) if totals[key] else 0.0
            for key in _SHARE_KEYS
        }
        principals.append({
            "principal": {"job": who[0], "component": who[1],
                          "purpose": who[2]},
            **{key: acc[key] for key in _COUNTER_KEYS.values()},
            "share": share,
        })
    principals.sort(
        key=lambda row: (-row["bytes"], -row["requests"],
                         str(row["principal"]))
    )

    purposes = {
        purpose: {
            "handler_seconds": secs,
            "share": (secs / handler_total) if handler_total else 0.0,
        }
        for purpose, secs in sorted(per_purpose.items())
    }
    unknown_secs = per_purpose.get(_principal.UNKNOWN, 0.0)
    attributed_share = (
        (handler_total - unknown_secs) / handler_total
        if handler_total else 0.0
    )

    shards = {}
    for reporter, acc_by_who in per_shard.items():
        rows = []
        for who, acc in acc_by_who.items():
            if not any(acc[key] for key in _COUNTER_KEYS.values()):
                continue
            rows.append({
                "principal": {"job": who[0], "component": who[1],
                              "purpose": who[2]},
                "requests": acc["requests"],
                "rows": acc["rows"],
                "bytes": acc["bytes"],
                "lock_hold_seconds": acc["lock_hold_seconds"],
            })
        if not rows:
            continue
        rows.sort(key=lambda row: (-row["bytes"], -row["requests"],
                                   str(row["principal"])))
        shards[reporter] = {"top": rows[:int(top_k)]}

    return {
        "now": time.time(),
        "totals": totals,
        "principals": principals,
        "purposes": purposes,
        "attributed_handler_share": attributed_share,
        "shards": shards,
    }
