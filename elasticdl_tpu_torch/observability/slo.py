"""Declarative SLOs over the time-series store: burn-rate alerting +
triggered black-box incident capture.

Three rule kinds, all evaluated on the master tick against
``observability/timeseries.TimeSeriesStore``:

- ``burn_rate`` — the SRE-workbook shape: an objective ("99% of
  ``rpc_client_seconds`` observations finish under 1 s") defines an
  error *budget* (1 − objective); the observed bad fraction over a
  window, divided by the budget, is the **burn rate** (1.0 = spending
  the budget exactly as fast as allowed). The rule fires only when
  BOTH a long and a short window exceed the threshold — the long
  window gives significance, the short window makes the alert reset
  promptly once the problem stops (no hour-long tail of a transient).
  The SLI is either a latency histogram with ``latency_threshold``
  (bad = observations above it, derived from bucket deltas) or a
  ``bad_series``/``series`` counter pair (bad = e.g. error total).
- ``threshold`` — a windowed aggregation (``p50``/``p99``/``mean``/
  ``rate``/``last``/``max``/``min``) compared against a value.
- ``absence`` — a series that was reporting has gone stale: its
  ``last_seen`` froze more than ``staleness_secs`` ago (the sampler
  freezes it the moment a reporter stops piggybacking snapshots —
  see ``TimeSeriesStore``). Offenders older than ``forget_secs`` are
  dropped from the alert: a worker that legitimately scaled away must
  not page forever.

Rule states surface three ways: the ``/alerts`` JSON endpoint next to
``/metrics``, ``edl_tpu_alert_active{rule}`` gauges (scrapeable, so a
real Prometheus can page on them), and zero-duration spans on the
master trace track at every transition (the alert appears on the same
Perfetto timeline as the tasks it indicts).

When a rule transitions to firing, the ``IncidentRecorder`` captures a
self-contained black-box bundle to disk — flight-recorder spans from
every role (Perfetto-loadable), the time-series window around the
breach, the critical-path p99 attribution, and the master journal tail
— so a transient 2 a.m. degradation leaves an artifact instead of
nothing. ``tools/check_incident.py`` schema-checks bundles;
``make slo-smoke`` drills the whole loop (docs/observability.md).
"""

import dataclasses
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.observability.timeseries import TimeSeriesStore

logger = get_logger("slo")

BURN_RATE = "burn_rate"
THRESHOLD = "threshold"
ABSENCE = "absence"
KINDS = (BURN_RATE, THRESHOLD, ABSENCE)

AGGREGATIONS = ("p50", "p90", "p99", "mean", "rate", "last", "max",
                "min")


@dataclasses.dataclass
class SLORule:
    """One declarative rule (see module docstring for semantics). The
    JSON rule-file form is exactly these field names; unknown fields
    are rejected so a typo'd rule fails at load, not silently never
    fires."""

    name: str
    kind: str
    series: str                       # family name, e.g. edl_tpu_rpc_client_seconds
    labels: Optional[Dict[str, str]] = None  # label subset filter
    source: Optional[str] = None      # reporter filter ("" = master-local)
    # burn_rate:
    objective: float = 0.99
    latency_threshold: Optional[float] = None  # seconds; histogram SLI
    bad_series: str = ""              # counter-pair SLI numerator
    long_window_secs: float = 300.0
    short_window_secs: float = 60.0
    burn_rate_threshold: float = 4.0
    # threshold:
    aggregation: str = "p99"
    op: str = ">"
    value: float = 0.0
    window_secs: float = 60.0
    # absence:
    staleness_secs: float = 120.0
    forget_secs: float = 0.0          # 0 = 4 × staleness_secs
    # common:
    min_count: int = 1                # observations needed before judging
    description: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown SLO rule kind {self.kind!r}")
        if self.kind == BURN_RATE:
            if not (0.0 < self.objective < 1.0):
                raise ValueError(
                    f"{self.name}: objective must be in (0, 1)"
                )
            if self.latency_threshold is None and not self.bad_series:
                raise ValueError(
                    f"{self.name}: burn_rate needs latency_threshold "
                    "(histogram SLI) or bad_series (counter SLI)"
                )
            if self.short_window_secs > self.long_window_secs:
                raise ValueError(
                    f"{self.name}: short window exceeds long window"
                )
        if self.kind == THRESHOLD:
            if self.aggregation not in AGGREGATIONS:
                raise ValueError(
                    f"{self.name}: unknown aggregation "
                    f"{self.aggregation!r}"
                )
            if self.op not in (">", "<", ">=", "<="):
                raise ValueError(f"{self.name}: unknown op {self.op!r}")
        if not self.forget_secs:
            self.forget_secs = 4.0 * self.staleness_secs
        if self.kind == ABSENCE \
                and self.forget_secs <= self.staleness_secs:
            # The offender window is (staleness, forget]; inverted
            # bounds would load cleanly and never fire — exactly the
            # silent misconfiguration this validation exists to stop.
            raise ValueError(
                f"{self.name}: forget_secs ({self.forget_secs}) must "
                f"exceed staleness_secs ({self.staleness_secs})"
            )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SLORule":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown SLO rule fields {sorted(unknown)} "
                f"in {d.get('name', '<unnamed>')!r}"
            )
        return cls(**d)


def load_rules(path: str) -> List[SLORule]:
    """Rule file: JSON ``{"rules": [{...}, ...]}`` (or a bare list)."""
    with open(path) as fh:
        raw = json.load(fh)
    if isinstance(raw, dict):
        raw = raw.get("rules", [])
    return [SLORule.from_dict(d) for d in raw]


def default_rules() -> List[SLORule]:
    """Built-in rules any training master benefits from; rules over
    families that never report simply stay idle (min_count)."""
    return [
        SLORule(
            name="rpc-latency-burn",
            kind=BURN_RATE,
            series="edl_tpu_rpc_client_seconds",
            latency_threshold=1.0,
            objective=0.99,
            long_window_secs=300.0,
            short_window_secs=60.0,
            burn_rate_threshold=4.0,
            min_count=20,
            description="control/row-plane RPC attempts slower than "
                        "1s are burning >4x the 1% error budget",
        ),
        SLORule(
            name="worker-absent",
            kind=ABSENCE,
            series="edl_tpu_worker_step_seconds",
            staleness_secs=600.0,
            description="a worker that was reporting step telemetry "
                        "has gone silent (not scaled away)",
        ),
        SLORule(
            name="primary-heartbeat-absent",
            kind=ABSENCE,
            series="edl_tpu_master_primary_heartbeat_seconds",
            staleness_secs=120.0,
            description="the hot standby stopped confirming primary "
                        "heartbeats (it reports them into the cluster "
                        "view via ComponentMetricsReporter): either "
                        "the standby died or it can no longer see the "
                        "primary — failover protection is gone "
                        "(docs/fault_tolerance.md)",
        ),
        SLORule(
            name="row-push-log-fsync-stall",
            kind=THRESHOLD,
            series="edl_tpu_row_push_log_fsync_seconds",
            aggregation="p99",
            op=">",
            value=0.25,
            window_secs=300.0,
            min_count=10,
            description="push-log group commits stalling >250ms at "
                        "p99: durable-ack pushes are paying the "
                        "stall directly, and in applied-ack mode the "
                        "RPO window is growing past its group-ms "
                        "budget — usually a sick WAL disk "
                        "(docs/fault_tolerance.md 'Zero-RPO row "
                        "plane')",
        ),
        # Per-workload burn (docs/observability.md "Workload
        # attribution"): the usage plane's handler-time histogram
        # carries a bounded ``purpose`` label, so burn accounting can
        # target one workload class without the others' traffic
        # diluting (or inflating) its error budget — serving reads
        # burn against a tight latency bound while training pushes get
        # a looser one, on the SAME family.
        SLORule(
            name="usage-burn-serving-read",
            kind=BURN_RATE,
            series="edl_tpu_usage_handler_seconds",
            labels={"purpose": "serving_read"},
            latency_threshold=0.25,
            objective=0.99,
            long_window_secs=300.0,
            short_window_secs=60.0,
            burn_rate_threshold=4.0,
            min_count=20,
            description="serving-read row handlers slower than 250ms "
                        "are burning >4x the 1% error budget — scoped "
                        "to purpose=serving_read, so a training push "
                        "storm cannot mask (or trigger) it",
        ),
        SLORule(
            name="usage-burn-training",
            kind=BURN_RATE,
            series="edl_tpu_usage_handler_seconds",
            labels={"purpose": "training"},
            latency_threshold=1.0,
            objective=0.99,
            long_window_secs=300.0,
            short_window_secs=60.0,
            burn_rate_threshold=4.0,
            min_count=20,
            description="training push/pull handlers slower than 1s "
                        "are burning >4x the 1% error budget — scoped "
                        "to purpose=training",
        ),
        SLORule(
            name="row-freshness",
            kind=THRESHOLD,
            series="edl_tpu_row_freshness_seconds",
            aggregation="p99",
            op=">",
            value=60.0,
            window_secs=300.0,
            min_count=5,
            description="push-to-servable latency p99 above 60s: "
                        "serving reads are going stale "
                        "(docs/observability.md)",
        ),
        # Streaming watermark stall (master/stream_ingest.py): the
        # oldest uncommitted stream record aging past 5 minutes means
        # the train→serve loop is open — workers are not resolving
        # stream tasks (fleet dead/lagging, backpressure wedge, or a
        # master that stopped pumping). docs/online_learning.md.
        SLORule(
            name="stream-watermark-stall",
            kind=THRESHOLD,
            series="edl_tpu_stream_ingest_watermark_lag_seconds",
            aggregation="max",
            op=">",
            value=300.0,
            window_secs=300.0,
            min_count=5,
            description="a stream partition's committed watermark has "
                        "lagged the tail by >5 minutes across the "
                        "window: online learning has stalled "
                        "(docs/online_learning.md)",
        ),
        # Gang-scheduler starvation (master/scheduler.py): submitted
        # jobs should either schedule or preempt their way in within
        # an arbitration window. The mean of the submitted-state gauge
        # staying above 0.5 for the whole window means at least one
        # job sat admitted-but-never-arbitrated — a wedged tick loop,
        # a gang larger than the fleet will ever be, or priorities
        # starving the tail (docs/scheduler.md "Starvation").
        SLORule(
            name="sched-job-starved",
            kind=THRESHOLD,
            series="edl_tpu_sched_jobs",
            labels={"state": "submitted"},
            aggregation="mean",
            op=">",
            value=0.5,
            window_secs=300.0,
            min_count=10,
            description="a submitted job has sat unscheduled for the "
                        "whole evaluation window: the fleet never fit "
                        "its gang and nothing preempted to admit it "
                        "(docs/scheduler.md)",
        ),
        # Outside-in SLIs (observability/prober.py): the synthetic
        # canary plane's black-box probes are the first rules whose
        # inputs come from OUTSIDE the components — a probe failure
        # means a user-visible contract broke, whatever the white-box
        # families claim.
        SLORule(
            name="probe-failure-burn",
            kind=BURN_RATE,
            series="edl_tpu_probe_attempts_total",
            bad_series="edl_tpu_probe_failures_total",
            objective=0.99,
            long_window_secs=300.0,
            short_window_secs=60.0,
            burn_rate_threshold=4.0,
            min_count=4,
            description="black-box probe failure ratio burns the "
                        "outside-in availability budget across probes "
                        "— a user-visible contract (read-your-writes, "
                        "push-to-servable, reshard convergence, stream "
                        "watermark, dispatch) is failing from outside "
                        "(docs/observability.md 'Synthetic probing')",
        ),
        SLORule(
            name="probe-absent",
            kind=ABSENCE,
            series="edl_tpu_probe_attempts_total",
            staleness_secs=120.0,
            forget_secs=900.0,
            description="the prober stopped running: probe attempts "
                        "went stale, so every outside-in SLI above is "
                        "blind — treat monitoring loss as an incident, "
                        "not as green",
        ),
        # Overload plane (comm/overload.py, docs/fault_tolerance.md
        # "Graceful degradation"): shedding BACKGROUND purposes under
        # pressure is the design working, so no rule fires on it —
        # these rules fire on the shapes that mean the design is NOT
        # working: serving reads being shed (priority inversion),
        # clients giving up because the shared retry budget drained
        # (sustained overload, not a blip), breakers stuck open.
        SLORule(
            name="overload-serving-shed",
            kind=THRESHOLD,
            series="edl_tpu_overload_shed_total",
            labels={"purpose": "serving_read"},
            aggregation="rate",
            op=">",
            value=0.0,
            window_secs=60.0,
            min_count=1,
            description="the admission gate shed serving reads — the "
                        "one purpose load shedding exists to protect. "
                        "Background purposes are already fully shed "
                        "and the fleet is STILL saturated: add "
                        "capacity or cut the serving limit "
                        "(docs/fault_tolerance.md 'Graceful "
                        "degradation')",
        ),
        SLORule(
            name="rpc-retry-budget-exhausted",
            kind=THRESHOLD,
            series="edl_tpu_rpc_retry_budget_exhausted_total",
            aggregation="rate",
            op=">",
            value=0.5,
            window_secs=300.0,
            min_count=5,
            description="clients are abandoning retries faster than "
                        "the token bucket refills, sustained across "
                        "the window: the dependency is in prolonged "
                        "overload and unbudgeted callers would be "
                        "amplifying it (docs/fault_tolerance.md)",
        ),
        SLORule(
            name="rpc-breaker-open",
            kind=THRESHOLD,
            series="edl_tpu_rpc_breaker_state",
            aggregation="min",
            op=">=",
            value=1.0,
            window_secs=120.0,
            min_count=5,
            description="a client circuit breaker has not closed for "
                        "a whole window (state 1=open/2=half-open "
                        "throughout): its target is persistently "
                        "unreachable and every caller is failing "
                        "fast, not slow (docs/fault_tolerance.md)",
        ),
    ]


class RollingWindow:
    """Tiny shared helper: a bounded deque of ``(t, ok, latency)``
    samples with windowed error-ratio / quantile reductions — the
    serving router's per-replica SLO status uses it (one per replica;
    the master side uses the full TimeSeriesStore instead)."""

    def __init__(self, window_secs: float = 60.0, capacity: int = 2048):
        self.window_secs = float(window_secs)
        self._samples = deque(maxlen=int(capacity))
        self._lock = threading.Lock()

    def record(self, ok: bool, latency_secs: float,
               now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        with self._lock:
            self._samples.append((now, bool(ok), float(latency_secs)))

    def status(self, now: Optional[float] = None) -> dict:
        now = time.monotonic() if now is None else now
        cutoff = now - self.window_secs
        with self._lock:
            live = [s for s in self._samples if s[0] >= cutoff]
        n = len(live)
        if not n:
            return {"window_secs": self.window_secs, "requests": 0,
                    "error_ratio": 0.0, "p95_ms": 0.0}
        errors = sum(1 for _t, ok, _l in live if not ok)
        lats = sorted(lat for _t, _ok, lat in live)
        p95 = lats[min(n - 1, int(round(0.95 * (n - 1))))]
        return {
            "window_secs": self.window_secs,
            "requests": n,
            "error_ratio": round(errors / n, 4),
            "p95_ms": round(p95 * 1e3, 3),
        }


class SLOEngine:
    """Evaluate rules against the store each master tick; keep per-rule
    firing state; surface transitions as gauges, trace events, and
    incident captures."""

    def __init__(self, store: TimeSeriesStore,
                 rules: Optional[List[SLORule]] = None,
                 metrics_registry=None,
                 incident_recorder: Optional["IncidentRecorder"] = None,
                 clock: Callable[[], float] = time.time):
        from elasticdl_tpu_torch.observability import default_registry

        self.store = store
        self.rules = list(rules if rules is not None else default_rules())
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO rule names in {names}")
        self.incident_recorder = incident_recorder
        self._clock = clock
        self._lock = threading.Lock()
        # rule name -> {"firing", "since", "value", "detail", "fired_count"}
        self._states: Dict[str, dict] = {
            rule.name: {
                "firing": False, "since": None, "value": 0.0,
                "detail": "", "fired_count": 0,
            }
            for rule in self.rules
        }
        registry = metrics_registry or default_registry()
        self._m_active = registry.gauge(
            "alert_active",
            "1 while the named SLO rule is firing", ["rule"],
        )
        self._m_fired = registry.counter(
            "alerts_fired_total",
            "SLO rule transitions to firing", ["rule"],
        )
        self._m_eval_seconds = registry.histogram(
            "slo_eval_seconds", "One full rule-evaluation pass",
        )
        for rule in self.rules:
            self._m_active.labels(rule.name).set(0.0)

    # ---- evaluation ----------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One pass over every rule; returns the alert states (the
        ``/alerts`` body's ``rules`` list)."""
        now = self._clock() if now is None else now
        t0 = time.monotonic()
        out = []
        for rule in self.rules:
            try:
                firing, value, detail = self._eval_rule(rule, now)
            except Exception:
                logger.exception("SLO rule %s evaluation failed",
                                 rule.name)
                continue
            out.append(self._transition(rule, firing, value, detail, now))
        self._m_eval_seconds.observe(time.monotonic() - t0)
        return out

    def _transition(self, rule: SLORule, firing: bool, value: float,
                    detail: str, now: float) -> dict:
        with self._lock:
            state = self._states[rule.name]
            was = state["firing"]
            state["value"] = value
            state["detail"] = detail
            if firing and not was:
                state["firing"] = True
                state["since"] = now
                state["fired_count"] += 1
        if firing and not was:
            self._m_active.labels(rule.name).set(1.0)
            self._m_fired.labels(rule.name).inc()
            self._emit_trace_event(rule, "firing", value, detail)
            logger.warning("SLO ALERT %s firing: %s (value %.4g)",
                           rule.name, detail, value)
            if self.incident_recorder is not None:
                try:
                    self.incident_recorder.capture(
                        self.alert_state(rule.name), now=now
                    )
                except Exception:
                    logger.exception(
                        "incident capture for %s failed", rule.name
                    )
        elif was and not firing:
            with self._lock:
                self._states[rule.name]["firing"] = False
                self._states[rule.name]["since"] = None
            self._m_active.labels(rule.name).set(0.0)
            self._emit_trace_event(rule, "resolved", value, detail)
            logger.info("SLO alert %s resolved", rule.name)
        return self.alert_state(rule.name)

    def _emit_trace_event(self, rule: SLORule, event: str, value: float,
                          detail: str):
        """Zero-duration span on the master track: the alert transition
        lands on the same Perfetto timeline as the tasks it indicts.
        Free when no flight recorder is installed."""
        from elasticdl_tpu_torch.observability import tracing

        tracing.record_span(
            f"alert/{rule.name}", time.monotonic(), 0.0,
            role="master", event=event, rule=rule.name,
            kind=rule.kind, value=round(float(value), 6),
            detail=detail,
        )

    # ---- rule kinds ----------------------------------------------------

    def _eval_rule(self, rule: SLORule, now: float):
        if rule.kind == BURN_RATE:
            return self._eval_burn_rate(rule, now)
        if rule.kind == THRESHOLD:
            return self._eval_threshold(rule, now)
        return self._eval_absence(rule, now)

    def _error_ratio(self, rule: SLORule, window: float, now: float):
        """(bad fraction, observation count) over one window."""
        if rule.latency_threshold is not None:
            count, _total, deltas, ubs = self.store.window_hist(
                rule.series, window, rule.labels, rule.source, now
            )
            if not deltas or count <= 0:
                return 0.0, 0.0
            # Registry buckets are per-bucket (non-cumulative): good =
            # observations in buckets at or under the threshold.
            thr = float(rule.latency_threshold)
            good = sum(
                d for ub, d in zip(ubs, deltas) if ub <= thr + 1e-12
            )
            return max(0.0, (count - good) / count), count
        bad, _n = self.store.window_counter_delta(
            rule.bad_series, window, rule.labels, rule.source, now
        )
        total, _n = self.store.window_counter_delta(
            rule.series, window, rule.labels, rule.source, now
        )
        if total <= 0:
            return 0.0, 0.0
        return min(1.0, max(0.0, bad / total)), total

    def _eval_burn_rate(self, rule: SLORule, now: float):
        long_ratio, long_n = self._error_ratio(
            rule, rule.long_window_secs, now
        )
        short_ratio, _short_n = self._error_ratio(
            rule, rule.short_window_secs, now
        )
        budget = 1.0 - rule.objective
        burn_long = long_ratio / budget
        burn_short = short_ratio / budget
        firing = (
            long_n >= rule.min_count
            and burn_long >= rule.burn_rate_threshold
            and burn_short >= rule.burn_rate_threshold
        )
        detail = (
            f"burn {burn_long:.2f}x/{burn_short:.2f}x "
            f"(long {int(rule.long_window_secs)}s / short "
            f"{int(rule.short_window_secs)}s) of the "
            f"{budget:.2%} budget on {rule.series}; "
            f"threshold {rule.burn_rate_threshold}x, "
            f"n={int(long_n)}"
        )
        return firing, burn_long, detail

    def _eval_threshold(self, rule: SLORule, now: float):
        agg = rule.aggregation
        value, n = 0.0, 0.0
        if agg in ("p50", "p90", "p99", "mean"):
            if agg == "mean":
                count, total, _deltas, _ubs = self.store.window_hist(
                    rule.series, rule.window_secs, rule.labels,
                    rule.source, now,
                )
                value = total / count if count > 0 else 0.0
                n = count
            else:
                q = {"p50": 0.50, "p90": 0.90, "p99": 0.99}[agg]
                value, n = self.store.window_quantile(
                    rule.series, rule.window_secs, q,
                    rule.labels, rule.source, now,
                )
            if n <= 0 and agg == "mean":
                # No histogram matched: fall through to gauges so
                # "mean over the window" also works on a gauge series
                # (quantiles have no gauge equivalent — don't pay the
                # store scan just to discard it).
                values = self.store.gauge_values(
                    rule.series, rule.window_secs, rule.labels,
                    rule.source, now,
                )
                if values:
                    value, n = sum(values) / len(values), len(values)
        elif agg == "rate":
            delta, n = self.store.window_counter_delta(
                rule.series, rule.window_secs, rule.labels,
                rule.source, now,
            )
            value = delta / rule.window_secs if rule.window_secs else 0.0
        else:  # last / max / min over gauge points
            values = self.store.gauge_values(
                rule.series, rule.window_secs, rule.labels,
                rule.source, now,
            )
            n = len(values)
            if values:
                value = {
                    "last": values[-1],
                    "max": max(values),
                    "min": min(values),
                }[agg]
        cmp = {
            ">": value > rule.value, "<": value < rule.value,
            ">=": value >= rule.value, "<=": value <= rule.value,
        }[rule.op]
        firing = bool(cmp and n >= rule.min_count)
        detail = (
            f"{agg}({rule.series}[{int(rule.window_secs)}s]) = "
            f"{value:.4g} {rule.op} {rule.value:.4g}, n={int(n)}"
        )
        return firing, value, detail

    def _eval_absence(self, rule: SLORule, now: float):
        seen = self.store.last_seen(rule.series, rule.labels, rule.source)
        offenders = []
        worst = 0.0
        for key, t in seen.items():
            age = now - t
            if rule.staleness_secs < age <= rule.forget_secs:
                offenders.append(key)
                worst = max(worst, age)
        firing = bool(offenders)
        detail = (
            f"{len(offenders)} stale series on {rule.series} "
            f"(oldest {worst:.0f}s > {rule.staleness_secs:.0f}s): "
            f"{sorted(offenders)[:4]}"
            if offenders else
            f"all {len(seen)} series on {rule.series} fresh"
        )
        return firing, worst, detail

    # ---- state / endpoint ----------------------------------------------

    def alert_state(self, name: str) -> dict:
        rule = next(r for r in self.rules if r.name == name)
        with self._lock:
            state = dict(self._states[name])
        state["rule"] = name
        state["kind"] = rule.kind
        state["series"] = rule.series
        state["description"] = rule.description
        return state

    def firing(self) -> List[str]:
        with self._lock:
            return sorted(
                name for name, s in self._states.items() if s["firing"]
            )

    def render(self) -> dict:
        """JSON body for ``GET /alerts``."""
        rules = [self.alert_state(rule.name) for rule in self.rules]
        return {
            "now": self._clock(),
            "firing": self.firing(),
            "rules": rules,
        }


class IncidentRecorder:
    """Black-box capture on alert transitions: one self-contained
    bundle directory per firing, rate-limited per rule.

    Bundle layout (``tools/check_incident.py`` is the schema check)::

        <out_dir>/incident_<utc stamp>_<rule>/
            alert.json          # the firing rule state + rule config
            trace.json          # Perfetto trace_event JSON of every
                                # collected span (all roles' flight
                                # recorders, via the metrics pipeline)
            critical_path.json  # p99 task/step attribution over the
                                # same spans
            series.json         # TimeSeriesStore window around the
                                # breach (hot tier)
            journal_tail.json   # last N master-journal records (when
                                # the master runs with --journal_dir)
            profile.json        # per-component flame-table windows
                                # from the ProfileStore (when the fleet
                                # runs with --profile_hz) — WHICH CODE
                                # was burning when the rule fired
            exemplars.json      # the breached series' exemplar traces
                                # (value + trace id), resolvable
                                # against trace.json
    """

    def __init__(self, out_dir: str,
                 metrics_plane=None,
                 store: Optional[TimeSeriesStore] = None,
                 journal_tail_fn: Optional[Callable[[], list]] = None,
                 profile_store=None,
                 window_secs: float = 900.0,
                 profile_window_secs: float = 120.0,
                 cooldown_secs: float = 300.0,
                 background: bool = True,
                 clock: Callable[[], float] = time.time):
        self.out_dir = out_dir
        self.metrics_plane = metrics_plane
        self.store = store
        self.journal_tail_fn = journal_tail_fn
        # Default to the plane's store so every --incident_dir master
        # bundles profiles once any component runs with --profile_hz.
        if profile_store is None and metrics_plane is not None:
            profile_store = getattr(metrics_plane, "profiles", None)
        self.profile_store = profile_store
        self.window_secs = float(window_secs)
        self.profile_window_secs = float(profile_window_secs)
        self.cooldown_secs = float(cooldown_secs)
        # Captures serialize thousands of spans + a long series window
        # to disk — by default that happens on a daemon thread, NOT on
        # the master run loop that called evaluate() (an incident is
        # exactly when the master is already under pressure). Tests
        # and drills call flush() before asserting on bundles, or pass
        # background=False.
        self.background = bool(background)
        self._clock = clock
        self._lock = threading.Lock()
        self._last_capture: Dict[str, float] = {}
        self._writers: List[threading.Thread] = []
        self.bundles: List[str] = []

    def capture(self, alert_state: dict,
                now: Optional[float] = None) -> Optional[str]:
        """Capture one bundle; returns its path (write may still be in
        flight — see ``flush``), or None when the rule is inside its
        capture cooldown (a flapping rule must not fill the disk with
        near-identical bundles)."""
        now = self._clock() if now is None else now
        rule = str(alert_state.get("rule", "unknown"))
        with self._lock:
            last = self._last_capture.get(rule)
            if last is not None and now - last < self.cooldown_secs:
                return None
            self._last_capture[rule] = now
        stamp = time.strftime("%Y%m%d_%H%M%S", time.gmtime(now))
        path = os.path.join(self.out_dir, f"incident_{stamp}_{rule}")
        suffix = 0
        while os.path.exists(path):
            suffix += 1
            path = os.path.join(
                self.out_dir, f"incident_{stamp}_{rule}.{suffix}"
            )
        os.makedirs(path, exist_ok=True)
        if not self.background:
            self._write_bundle(path, alert_state, now)
            return path
        writer = threading.Thread(
            target=self._write_bundle, args=(path, alert_state, now),
            daemon=True, name="incident-writer",
        )
        with self._lock:
            self._writers = [
                t for t in self._writers if t.is_alive()
            ] + [writer]
        writer.start()
        return path

    def flush(self, timeout: float = 10.0):
        """Join in-flight bundle writes (shutdown / test barrier)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            writers = list(self._writers)
        for writer in writers:
            writer.join(timeout=max(0.0, deadline - time.monotonic()))

    def _write_bundle(self, path: str, alert_state: dict, now: float):
        """Every stage is individually contained: one failing
        collector (a malformed span, a store hiccup) must degrade the
        bundle — a fallback payload for that file — never abandon it
        half-written on a dead writer thread. This is the 2 a.m.
        artifact; partial beats silently absent. Disk-level failures
        (ENOSPC) are the one thing a fallback can't fix; they log
        loudly instead of killing the thread silently."""
        try:
            self._write_bundle_inner(path, alert_state, now)
        except Exception:
            logger.exception("incident bundle %s failed to write", path)

    def _write_bundle_inner(self, path: str, alert_state: dict,
                            now: float):

        def stage(name, fn, fallback):
            try:
                return fn()
            except Exception:
                logger.exception("incident: %s collection failed", name)
                return fallback

        spans = []
        if self.metrics_plane is not None:
            spans = stage(
                "span", self.metrics_plane.trace_spans, []
            )
        self._write_json(path, "alert.json", {
            "captured_at": now,
            "window_secs": self.window_secs,
            "alert": alert_state,
        })
        from elasticdl_tpu_torch.observability import critical_path
        from elasticdl_tpu_torch.observability.trace_export import chrome_trace

        self._write_json(path, "trace.json", stage(
            "trace", lambda: chrome_trace(spans),
            {"traceEvents": []},
        ))
        self._write_json(path, "critical_path.json", stage(
            "critical-path", lambda: critical_path.analyze(spans),
            {"span_count": 0, "trace_count": 0},
        ))
        series = {}
        if self.store is not None:
            series = stage(
                "series",
                lambda: self.store.render(
                    window_secs=self.window_secs, now=now
                ),
                {"series": {}, "error": "series capture failed"},
            )
        self._write_json(path, "series.json", series)
        tail = []
        if self.journal_tail_fn is not None:
            tail = stage(
                "journal-tail",
                lambda: list(self.journal_tail_fn()), [],
            )
        self._write_json(path, "journal_tail.json", {"records": tail})
        profile = {"window_secs": self.profile_window_secs,
                   "components": {}}
        if self.profile_store is not None:
            profile = stage(
                "profile",
                lambda: self.profile_store.bundle_capture(
                    window_secs=self.profile_window_secs
                ),
                profile,
            )
        self._write_json(path, "profile.json", profile)
        self._write_json(path, "exemplars.json", stage(
            "exemplar",
            lambda: self._collect_exemplars(alert_state),
            {"series": alert_state.get("series"), "exemplars": []},
        ))
        self.bundles.append(path)
        logger.warning("incident bundle written: %s (%d spans)",
                       path, len(spans))

    def _collect_exemplars(self, alert_state: dict) -> dict:
        """The breached rule's exemplar traces: scan the master-local
        registry and every live cluster snapshot for the rule's series
        family, collecting each series' exemplars (bucket bound, value,
        trace id, timestamp). These trace ids resolve against
        ``trace.json`` — the metric→trace rung the bundle exists for."""
        family_name = str(alert_state.get("series") or "")
        out = []
        if not family_name or self.metrics_plane is None:
            return {"series": family_name, "exemplars": out}
        sources = {"": self.metrics_plane.registry.snapshot()}
        sources.update({
            str(wid): snap
            for wid, snap in
            self.metrics_plane.cluster.snapshots().items()
        })
        for source, snapshot in sorted(sources.items()):
            for family in (snapshot or {}).get("families", []):
                if family.get("name") != family_name:
                    continue
                buckets = family.get("buckets") or []
                for series in family.get("series", []):
                    for idx, entry in sorted(
                        (series.get("exemplars") or {}).items()
                    ):
                        try:
                            i = int(idx)
                            value, trace_id, ts = entry
                        except (TypeError, ValueError):
                            continue
                        out.append({
                            "source": source,
                            "labels": list(series.get("labels", [])),
                            "bucket_le": (
                                float(buckets[i]) if i < len(buckets)
                                else None  # +Inf overflow
                            ),
                            "value": float(value),
                            "trace_id": str(trace_id),
                            "ts": float(ts),
                        })
        return {"series": family_name, "exemplars": out}

    @staticmethod
    def _write_json(bundle: str, name: str, payload):
        with open(os.path.join(bundle, name), "w") as fh:
            json.dump(payload, fh, indent=1, sort_keys=True,
                      default=str)
            fh.write("\n")
