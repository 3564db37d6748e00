"""Master-side cluster metrics: merge worker snapshots, age out leavers.

Workers piggyback registry snapshots on master-client RPCs they already
make (get_task / report_task_result / report_version) — no new RPC, no
scrape path into worker pods. ``ClusterMetrics`` keeps the latest
snapshot per worker id plus its arrival time; a worker that stops
reporting (preempted, scaled away on elastic resize) ages out after
``ttl_secs`` and its series vanish from ``/metrics``; the master's
recovery path removes it immediately.

``MetricsPlane`` is the whole master-side assembly: the master-local
registry (task dispatcher, checkpoint, straggler counters), the cluster
view, the ``/metrics`` HTTP endpoint, and the TensorBoard bridge that
mirrors selected cluster aggregates into the existing ``SummaryWriter``
so TensorBoard stays the human view.

A copy of elasticdl_tpu/observability/aggregator.py as far as the
master's servicer needs it: ``ClusterMetrics`` whole, and a
``MetricsPlane`` without the continuous-profiling store (``/profile``;
a snapshot carrying profile windows raises) and the SLO plane
(``/timeseries``, ``/alerts``), which are not ported yet (ROADMAP Queue
1, item 8).
"""

import threading
import time
from typing import Callable, Dict, Optional

from elasticdl_tpu_torch.observability.exposition import (
    MetricsHTTPServer,
    render_prometheus,
)
from elasticdl_tpu_torch.observability.registry import (
    MetricsRegistry,
    default_registry,
)


def _accumulate(snapshot: dict, totals: Dict[str, float],
                hist: Dict[str, list], include_gauges: bool):
    """Fold one snapshot into scalar accumulators: counters sum,
    histograms pool (sum, count). Gauges are point-in-time, so a
    departed worker's gauges must NOT linger — callers pass
    ``include_gauges=False`` for retired snapshots."""
    for family in snapshot.get("families", []):
        name = family["name"]
        kind = family["kind"]
        if kind == "gauge" and not include_gauges:
            continue
        for series in family.get("series", []):
            if kind == "histogram":
                acc = hist.setdefault(name, [0.0, 0])
                acc[0] += series["sum"]
                acc[1] += series["count"]
            else:
                totals[name] = totals.get(name, 0.0) + series["value"]


class ClusterMetrics:
    """Latest snapshot per worker id, with TTL-based aging.

    Departure does not lose history: a removed/expired worker's last
    snapshot is *retired*, and ``aggregate()`` keeps counting its
    counters and histogram totals so the TensorBoard-bridged cluster
    totals stay monotonic across elastic resizes. Its labeled series
    still vanish from ``/metrics`` (Prometheus handles departures via
    staleness; the scalar bridge can't). The snapshot's registry
    ``instance`` token disambiguates a reappearing worker id: same
    token → the live process flapped past the TTL, its cumulative
    values continue (un-retire); different token → a replacement
    process whose counters restarted, the old values fold into a
    permanent base."""

    def __init__(self, ttl_secs: float = 60.0):
        self.ttl_secs = float(ttl_secs)
        self._lock = threading.Lock()
        # worker_id -> (snapshot, monotonic arrival time)
        self._snapshots: Dict[int, tuple] = {}
        # worker_id -> last snapshot at departure (counters still owed
        # to the aggregate until the id reappears and is reconciled).
        self._retired: Dict[int, dict] = {}
        # (worker_id, instance token) -> (totals, hist): the latest
        # folded counter/histogram contribution of each replaced
        # process generation. Keyed per generation and REPLACED (not
        # added) on re-fold, so a stalled-but-alive old process
        # alternating reports with its replacement stays bounded — the
        # base always holds each generation's latest values exactly
        # once, and a generation that reports again (its cumulative
        # values now ride its live snapshot) drops its fold entry.
        self._folds: Dict[tuple, tuple] = {}
        # Memory bound under elastic churn: only the newest
        # _MAX_FOLDS_PER_WORKER generations stay individually keyed;
        # older ones (long dead — only a generation resurrected after
        # that many successors could double count, and none can, since
        # instance tokens die with their process) compact into one
        # permanent base.
        self._compacted_totals: Dict[str, float] = {}
        self._compacted_hist: Dict[str, list] = {}
        # Tokens whose fold was compacted (dict for insertion-order
        # eviction): if such a generation turns out to be stalled-but-
        # alive and reports again, its compacted contribution is
        # cancelled approximately (see ingest) instead of double
        # counting forever.
        self._compacted_tokens: Dict[tuple, None] = {}

    _MAX_FOLDS_PER_WORKER = 4
    _MAX_COMPACTED_TOKENS = 4096

    def _fold_locked(self, worker_id: int, snapshot: dict):
        """Record a replaced generation's counters/histograms in the
        base, replacing any earlier fold of the same generation, then
        compact this worker's oldest generations past the cap."""
        totals: Dict[str, float] = {}
        hist: Dict[str, list] = {}
        _accumulate(snapshot, totals, hist, include_gauges=False)
        self._folds[(worker_id, snapshot["instance"])] = (totals, hist)
        keys = [k for k in self._folds if k[0] == worker_id]
        for oldest in keys[:-self._MAX_FOLDS_PER_WORKER]:
            old_totals, old_hist = self._folds.pop(oldest)
            for name, value in old_totals.items():
                self._compacted_totals[name] = (
                    self._compacted_totals.get(name, 0.0) + value
                )
            for name, (h_sum, h_count) in old_hist.items():
                acc = self._compacted_hist.setdefault(name, [0.0, 0])
                acc[0] += h_sum
                acc[1] += h_count
            self._compacted_tokens[oldest] = None
            while len(self._compacted_tokens) > self._MAX_COMPACTED_TOKENS:
                self._compacted_tokens.pop(
                    next(iter(self._compacted_tokens))
                )

    @staticmethod
    def _key(worker_id):
        """Reporter key: workers stay ints; named components (the
        serving router's snapshot piggyback reports as ``router-N``)
        key by string. Sorting mixed keys always goes through
        ``key=str``."""
        if isinstance(worker_id, str):
            return worker_id
        return int(worker_id)

    def ingest(self, worker_id, snapshot: dict,
               now: Optional[float] = None):
        if not snapshot:
            return
        if not isinstance(worker_id, str) and worker_id < 0:
            return
        now = time.monotonic() if now is None else now
        wid = self._key(worker_id)
        token = snapshot.get("instance")
        with self._lock:
            retired = self._retired.pop(wid, None)
            if retired is not None:
                old = retired.get("instance")
                if old and token and old != token:
                    self._fold_locked(wid, retired)
                # Same (or unknown) instance: the retired snapshot's
                # values live on inside the new one — just un-retire.
            live = self._snapshots.get(wid)
            if live is not None:
                old = live[0].get("instance")
                if old and token and old != token:
                    # A relaunched worker reusing a still-live name
                    # (died and came back inside the TTL, before the
                    # master noticed): the dead process's counters must
                    # fold into the base, not be silently overwritten —
                    # the aggregate would regress — and its stale
                    # snapshot must not survive the replacement's.
                    self._fold_locked(wid, live[0])
            if token:
                # This generation's cumulative values now ride its live
                # snapshot; an earlier fold of it (the stalled-old-
                # process flap, or a fold-then-reappear) must not keep
                # counting on top.
                self._folds.pop((wid, token), None)
                if (wid, token) in self._compacted_tokens:
                    del self._compacted_tokens[(wid, token)]
                    # A generation already compacted into the permanent
                    # base turned out to be stalled-but-alive. Its
                    # exact compacted amounts are gone; cancel with the
                    # snapshot's CURRENT values (counters only grow, so
                    # they bound the compacted ones) — the residual
                    # error is one stall-window of growth, versus a
                    # permanent full double count.
                    neg_t: Dict[str, float] = {}
                    neg_h: Dict[str, list] = {}
                    _accumulate(snapshot, neg_t, neg_h,
                                include_gauges=False)
                    for name, value in neg_t.items():
                        self._compacted_totals[name] = (
                            self._compacted_totals.get(name, 0.0)
                            - value
                        )
                    for name, (h_sum, h_count) in neg_h.items():
                        acc = self._compacted_hist.setdefault(
                            name, [0.0, 0]
                        )
                        acc[0] -= h_sum
                        acc[1] -= h_count
            self._snapshots[wid] = (snapshot, now)

    def remove_worker(self, worker_id):
        """Immediate removal (master recovered the worker's tasks /
        elastic resize scaled it away) — don't wait for the TTL."""
        with self._lock:
            self._retire_locked(self._key(worker_id))

    def _retire_locked(self, worker_id: int):
        entry = self._snapshots.pop(worker_id, None)
        if entry is not None:
            self._retired[worker_id] = entry[0]

    def worker_ids(self):
        return sorted(self.snapshots(), key=str)

    def snapshots(self, now: Optional[float] = None) -> Dict[int, dict]:
        """Live snapshots; expired workers are retired as a side effect."""
        return {
            wid: snap
            for wid, (snap, _ts) in self.snapshot_entries(now).items()
        }

    def snapshot_entries(self, now: Optional[float] = None) -> Dict:
        """Live ``{reporter: (snapshot, arrival time)}`` — the arrival
        time is the time-series sampler's *fingerprint*: a reporter
        whose snapshot hasn't re-arrived since the last sample is
        skipped there, so its series go stale instead of flat-lining
        at the last piggybacked value (the TTL then removes it from
        /metrics entirely)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            expired = [
                wid for wid, (_s, ts) in self._snapshots.items()
                if now - ts > self.ttl_secs
            ]
            for wid in expired:
                self._retire_locked(wid)
            return dict(self._snapshots)

    # ---- cross-worker scalar aggregates --------------------------------

    def aggregate(self) -> Dict[str, float]:
        """Sum counters/gauges and mean histograms across live workers,
        plus retired/replaced generations' counters/histograms (gauges
        excluded) — the scalar view the TensorBoard bridge mirrors."""
        live = self.snapshots()
        with self._lock:
            totals = dict(self._compacted_totals)
            hist = {
                k: list(v) for k, v in self._compacted_hist.items()
            }
            for fold_totals, fold_hist in self._folds.values():
                for name, value in fold_totals.items():
                    totals[name] = totals.get(name, 0.0) + value
                for name, (h_sum, h_count) in fold_hist.items():
                    acc = hist.setdefault(name, [0.0, 0])
                    acc[0] += h_sum
                    acc[1] += h_count
            retired = list(self._retired.values())
        for snapshot in retired:
            _accumulate(snapshot, totals, hist, include_gauges=False)
        for snapshot in live.values():
            _accumulate(snapshot, totals, hist, include_gauges=True)
        for name, (total, count) in hist.items():
            totals[f"{name}_count"] = totals.get(
                f"{name}_count", 0.0
            ) + count
            if count:
                totals[f"{name}_mean"] = total / count
        return totals


_NOT_PORTED = ("not ported yet (ROADMAP Queue 1, item 8: the rest of "
               "observability/)")


class MetricsPlane:
    """Master-side telemetry assembly: local registry + cluster view +
    exposition endpoint + TensorBoard bridge."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 ttl_secs: float = 60.0, summary_writer=None):
        from elasticdl_tpu_torch.observability.tracing import TraceCollector

        self.registry = registry or default_registry()
        self.cluster = ClusterMetrics(ttl_secs)
        # Distributed-tracing collection: spans piggyback inside the
        # same worker snapshots the cluster view merges (a "spans" key
        # next to "families"); the collector dedups by span id.
        self.traces = TraceCollector()
        # TensorboardService (write_dict_to_summary) or SummaryWriter
        # (add_scalars) — both are duck-typed below; None = no bridge.
        self._summary_writer = summary_writer
        self._last_published = None
        self._http: Optional[MetricsHTTPServer] = None
        # Extra JSON routes registered by subsystems that come up
        # around the plane: merged into _json_routes() and live-added
        # to an already started server.
        self._extra_routes: Dict[str, Callable] = {}
        # /healthz verdict callable: None keeps the exposition layer's
        # static "ok" liveness body.
        self._health_fn: Optional[Callable[[], dict]] = None

    # ---- ingest / render ----------------------------------------------

    def ingest(self, worker_id: int, snapshot: dict):
        spans = snapshot.pop("spans", None) if snapshot else None
        if spans:
            self.traces.ingest(spans)
        if snapshot and snapshot.get("profiles"):
            raise NotImplementedError(
                f"profile windows in a snapshot: the profile store is "
                f"{_NOT_PORTED}")
        self.cluster.ingest(worker_id, snapshot)

    def remove_worker(self, worker_id):
        """Deliberate departure (scale-down drain, recovery dropping a
        dead id): retire from the cluster view."""
        self.cluster.remove_worker(worker_id)

    def render(self) -> str:
        return render_prometheus(
            self.registry.snapshot(), self.cluster.snapshots()
        )

    def render_openmetrics(self) -> str:
        """The OpenMetrics form (histogram exemplars included) served
        when a scraper's Accept asks for it — exemplars are illegal in
        the classic 0.0.4 text the default render emits."""
        return render_prometheus(
            self.registry.snapshot(), self.cluster.snapshots(),
            exemplars=True,
        )

    def trace_spans(self) -> list:
        """Collected spans: piggybacked worker spans ∪ this process's
        own flight-recorder ring (master dispatch spans never ride a
        report RPC), deduped by span id."""
        from elasticdl_tpu_torch.observability import tracing

        merged = tracing.TraceCollector()
        merged.ingest(self.traces.spans())
        merged.ingest(tracing.recorder_spans())
        return merged.spans()

    def render_traces(self) -> dict:
        """JSON body for the ``/traces`` endpoint."""
        return {"spans": self.trace_spans()}

    # ---- HTTP ----------------------------------------------------------

    def _json_routes(self):
        def usage_route(params: dict):
            # /usage[?top=K]: fleet-wide per-principal usage folded
            # from the master's own registry plus every live reporter
            # snapshot (observability/usage.py).
            top = params.get("top")
            return self.usage(top_k=int(top) if top else 5)

        routes = {"/usage": usage_route}
        routes.update(self._extra_routes)
        return routes

    def add_json_route(self, path: str, fn: Callable[[dict], dict]):
        """Mount ``fn(params) -> dict`` at ``path``. Works before OR
        after ``serve()``: the running server's route table is shared
        by reference, so the mount is live."""
        self._extra_routes[str(path)] = fn
        if self._http is not None:
            self._http._json_routes[str(path)] = fn

    def set_health(self, fn: Optional[Callable[[], dict]]):
        """Mount the aggregated ``/healthz`` verdict (a zero-arg
        callable returning a dict with an ``ok`` key — unhealthy
        serves HTTP 503). Live on an already-running server, like
        ``add_json_route``."""
        self._health_fn = fn
        if self._http is not None:
            self._http.set_health(fn)

    def usage(self, top_k: int = 5) -> dict:
        """The ``/usage`` body (also callable in-process)."""
        from elasticdl_tpu_torch.observability.usage import summarize_usage

        snapshots = {"": self.registry.snapshot()}
        for wid, snap in self.cluster.snapshots().items():
            snapshots[str(wid)] = snap
        return summarize_usage(snapshots, top_k=top_k)

    def serve(self, port: int = 0, host: str = "") -> MetricsHTTPServer:
        self._http = MetricsHTTPServer(
            self.render, port=port, host=host,
            traces=self.render_traces,
            json_routes=self._json_routes(),
            render_openmetrics=self.render_openmetrics,
            health=self._health_fn,
        ).start()
        return self._http

    @property
    def http_port(self) -> Optional[int]:
        return self._http.port if self._http else None

    def stop(self):
        if self._http is not None:
            self._http.stop()
            self._http = None

    # ---- TensorBoard bridge -------------------------------------------

    def set_summary_writer(self, writer):
        self._summary_writer = writer

    def publish_tensorboard(self, step: int):
        """Mirror cluster scalar aggregates (prefixed ``metrics/``) into
        the SummaryWriter; called from the master run-loop tick."""
        if self._summary_writer is None:
            return
        scalars = {
            f"metrics/{name}": value
            for name, value in self.cluster.aggregate().items()
        }
        if not scalars:
            return
        # The master calls this every poll tick; during idle stretches
        # (eval phases, stalled workers) step and aggregates sit still —
        # re-writing the identical frame each tick only bloats tfevents.
        if self._last_published == (int(step), scalars):
            return
        self._last_published = (int(step), scalars)
        add = getattr(self._summary_writer, "write_dict_to_summary", None)
        if add is not None:
            add(scalars, int(step))
        else:
            self._summary_writer.add_scalars(scalars, int(step))
