"""Process-local metrics registry: counters, gauges, histograms (copy
of elasticdl_tpu/observability/registry.py; the port keeps its own).

Prometheus-shaped but dependency-free: a registry holds labeled metric
*families*; a family with label names yields per-label-value *series*
via ``labels()``; a family without labels is itself the series. All
mutation goes through one registry lock — instrumented paths are RPC
handlers and per-step host code, where a lock acquisition is noise.

``snapshot()`` returns a plain-dict form (msgpack/json-safe, no numpy),
the same as the JAX package's for the same calls; the master folds
them in ``aggregator.py`` and ``exposition.py`` renders them.

Families are idempotent per registry: re-declaring the same name
returns the existing family (instrumented classes may be constructed
many times per process, e.g. one ``TaskDispatcher`` per test), but a
kind/labelnames mismatch raises — two call sites disagreeing about a
metric is a bug, not a merge.
"""

import threading
import time
import uuid
from typing import Callable, Dict, Optional, Sequence, Tuple

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

# Lazily bound to tracing.current_trace_id on the first exemplar-enabled
# observation (tracing imports nothing from here, so the import is
# safe; lazy keeps registry import-light for the many modules that
# never enable exemplars).
_ambient_trace_id: Optional[Callable[[], Optional[str]]] = None


def _trace_id_now() -> Optional[str]:
    global _ambient_trace_id
    fn = _ambient_trace_id
    if fn is None:
        from elasticdl_tpu_torch.observability.tracing import current_trace_id

        fn = _ambient_trace_id = current_trace_id
    return fn()

# Default latency buckets (seconds): 100µs .. ~2min, roughly 3x apart —
# spans a single fused device step up to a straggling task.
DEFAULT_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
    1.0, 5.0, 15.0, 60.0, 120.0,
)


class _Series:
    """One (family, label values) time series."""

    def __init__(self, family: "MetricFamily"):
        self._family = family
        self._lock = family._lock
        self.value = 0.0
        self._fn: Optional[Callable[[], float]] = None
        if family.kind == HISTOGRAM:
            self.bucket_counts = [0] * len(family.buckets)
            self.sum = 0.0
            self.count = 0
            # Exemplars (opt-in per family): bucket index -> (value,
            # trace_id, unix ts) of the latest trace-linked observation
            # landing there — OpenMetrics-shaped, O(1) per observe, so
            # an alert's "p99 burned" can name one concrete offending
            # trace (docs/observability.md "Continuous profiling &
            # exemplars"). Index len(buckets) = the +Inf overflow.
            self.exemplars: Dict[int, tuple] = {}

    # ---- counter / gauge ----------------------------------------------

    def inc(self, amount: float = 1.0):
        if self._family.kind == COUNTER and amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0):
        if self._family.kind != GAUGE:
            raise ValueError("dec() is gauge-only")
        with self._lock:
            self.value -= amount

    def set(self, value: float):
        if self._family.kind != GAUGE:
            raise ValueError("set() is gauge-only")
        with self._lock:
            self.value = float(value)

    def set_function(self, fn: Callable[[], float]):
        """Pull-time gauge: ``fn`` is evaluated at snapshot. Re-binding
        replaces the callback (latest instance wins — long processes
        construct instrumented objects repeatedly)."""
        if self._family.kind != GAUGE:
            raise ValueError("set_function() is gauge-only")
        with self._lock:
            self._fn = fn

    # ---- histogram -----------------------------------------------------

    def observe(self, value: float, trace_id: Optional[str] = None):
        """``trace_id`` links this observation to a trace (exemplar-
        enabled families only). None falls back to the thread's
        innermost open span — call sites whose span already closed
        pass the id explicitly."""
        if self._family.kind != HISTOGRAM:
            raise ValueError("observe() is histogram-only")
        value = float(value)
        with self._lock:
            idx = len(self._family.buckets)
            for i, ub in enumerate(self._family.buckets):
                if value <= ub:
                    self.bucket_counts[i] += 1
                    idx = i
                    break
            self.sum += value
            self.count += 1
            if self._family.exemplars:
                if trace_id is None:
                    trace_id = _trace_id_now()
                if trace_id:
                    self.exemplars[idx] = (
                        value, str(trace_id), time.time()
                    )

    # ---- snapshot ------------------------------------------------------

    def _snapshot_locked(self, label_values: Tuple[str, ...]) -> dict:
        if self._family.kind == HISTOGRAM:
            out = {
                "labels": list(label_values),
                "buckets": list(self.bucket_counts),
                "sum": float(self.sum),
                "count": int(self.count),
            }
            if self.exemplars:
                # str keys: the snapshot must stay msgpack/json-safe
                # end to end (piggyback RPCs, incident bundles).
                out["exemplars"] = {
                    str(i): [float(v), tid, float(ts)]
                    for i, (v, tid, ts) in self.exemplars.items()
                }
            return out
        value = self.value
        if self._fn is not None:
            try:
                value = float(self._fn())
            except Exception:
                # A dead callback (its object got collected mid-test)
                # must not poison the whole snapshot.
                value = self.value
        return {"labels": list(label_values), "value": float(value)}


class MetricFamily:
    """A named metric with fixed label names; ``labels()`` yields the
    per-label-value series. With no label names the family proxies its
    single series (``family.inc()`` etc. work directly)."""

    def __init__(self, registry: "MetricsRegistry", name: str, kind: str,
                 help_text: str, labelnames: Sequence[str],
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 exemplars: bool = False):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        # Exemplar capture (histograms only): opt-in because every
        # enabled observe pays a thread-local read; idempotent
        # re-declaration ORs the flag (several call sites may declare
        # one family, any of them opting in wins).
        self.exemplars = bool(exemplars) and kind == HISTOGRAM
        self._lock = registry._lock
        self._series: Dict[Tuple[str, ...], _Series] = {}
        if not self.labelnames:
            self._series[()] = _Series(self)

    def labels(self, *values, **kv) -> _Series:
        if kv:
            if values:
                raise ValueError("pass label values or kwargs, not both")
            values = tuple(kv[name] for name in self.labelnames)
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {values}"
            )
        with self._lock:
            series = self._series.get(values)
            if series is None:
                series = self._series[values] = _Series(self)
            return series

    # Label-less proxying.
    def inc(self, amount: float = 1.0):
        self.labels().inc(amount)

    def dec(self, amount: float = 1.0):
        self.labels().dec(amount)

    def set(self, value: float):
        self.labels().set(value)

    def set_function(self, fn: Callable[[], float]):
        self.labels().set_function(fn)

    def observe(self, value: float, trace_id: Optional[str] = None):
        self.labels().observe(value, trace_id=trace_id)

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "name": self.name,
                "kind": self.kind,
                "help": self.help,
                "labelnames": list(self.labelnames),
                "series": [
                    series._snapshot_locked(values)
                    for values, series in sorted(self._series.items())
                ],
            }
            if self.kind == HISTOGRAM:
                out["buckets"] = list(self.buckets)
            return out


class MetricsRegistry:
    """A set of metric families sharing one namespace and lock.

    ``namespace`` prefixes every family name (``worker_step_seconds`` →
    ``edl_tpu_worker_step_seconds``) so the naming scheme lives in one
    place instead of at forty call sites.
    """

    def __init__(self, namespace: str = "edl_tpu"):
        self.namespace = namespace
        self._lock = threading.RLock()
        self._families: Dict[str, MetricFamily] = {}
        # Identifies this registry's lifetime in snapshots: a replacement
        # worker process reuses the departed one's worker id, and the
        # master tells "same process, counters continuous" from "new
        # process, counters restarted" by this token, not the id.
        self._instance = uuid.uuid4().hex
        # Bumped on reset(): callers caching resolved series (hot-path
        # instrumentation like RpcStub) compare this to notice the
        # families were dropped and must be re-resolved.
        self.generation = 0

    def _family(self, name: str, kind: str, help_text: str,
                labelnames: Sequence[str],
                buckets: Sequence[float] = DEFAULT_BUCKETS,
                exemplars: bool = False) -> MetricFamily:
        full = f"{self.namespace}_{name}" if self.namespace else name
        with self._lock:
            family = self._families.get(full)
            if family is not None:
                if (family.kind != kind
                        or family.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f"metric {full} re-declared as {kind}"
                        f"{tuple(labelnames)}; existing is {family.kind}"
                        f"{family.labelnames}"
                    )
                if (kind == HISTOGRAM and family.buckets
                        != tuple(sorted(float(b) for b in buckets))):
                    raise ValueError(
                        f"histogram {full} re-declared with buckets "
                        f"{tuple(buckets)}; existing is {family.buckets}"
                    )
                if exemplars and kind == HISTOGRAM:
                    family.exemplars = True
                return family
            family = MetricFamily(
                self, full, kind, help_text, labelnames, buckets,
                exemplars=exemplars,
            )
            self._families[full] = family
            return family

    def counter(self, name: str, help_text: str = "",
                labelnames: Sequence[str] = ()) -> MetricFamily:
        return self._family(name, COUNTER, help_text, labelnames)

    def gauge(self, name: str, help_text: str = "",
              labelnames: Sequence[str] = ()) -> MetricFamily:
        return self._family(name, GAUGE, help_text, labelnames)

    def histogram(self, name: str, help_text: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  exemplars: bool = False) -> MetricFamily:
        return self._family(name, HISTOGRAM, help_text, labelnames,
                            buckets, exemplars=exemplars)

    def snapshot(self) -> dict:
        """Plain-dict snapshot of every family (msgpack/json-safe) —
        what workers ship to the master."""
        with self._lock:
            families = list(self._families.values())
            instance = self._instance
        return {
            "instance": instance,
            "families": [f.snapshot() for f in families],
        }

    def reset(self):
        """Drop every family (test isolation for the shared default).
        Rotates the instance token: post-reset counters restart at zero,
        which downstream must treat like a process replacement."""
        with self._lock:
            self._families.clear()
            self._instance = uuid.uuid4().hex
            self.generation += 1


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every layer instruments by default —
    one worker per process in production, so per-process is per-worker;
    tests needing isolation construct their own ``MetricsRegistry``."""
    return _DEFAULT
