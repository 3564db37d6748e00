"""Master-side time-series store: the telemetry plane's memory.

The metrics registry (PR 1) answers *now*, the tracing plane (PR 4)
answers *inside one task* — this module answers *over time*: a bounded
in-memory store that periodically samples the registries the master
already holds (its own ``MetricsRegistry`` plus every piggybacked
worker/router snapshot in ``ClusterMetrics``) and keeps the result in
ring buffers cheap enough to run forever:

- **counters** are stored as per-interval deltas (rendered as rates) —
  a restarted process's counter reset reads as a fresh delta, never a
  negative spike;
- **gauges** are stored as-is;
- **histograms** are stored as per-interval ``(count, sum, bucket)``
  deltas, from which rolling window quantiles (p50/p99/...) and
  fraction-over-threshold SLIs are derived on demand — the inputs the
  SLO engine's burn-rate rules (``observability/slo.py``) need.

Two retention tiers bound memory: a **hot** tier holding every sample
(default 720 points ≈ one hour at the 5 s cadence) and a **cold** tier
holding one downsampled point per ``cold_resolution_secs`` (default
1440 × 60 s = one day): gauges keep mean/min/max, counters keep the
summed delta, histograms keep the flushed interval's p50/p99.

Staleness is first-class: a reporter that stops piggybacking snapshots
must make its series go *stale*, not flat-line — ``ClusterMetrics``
keeps serving the last snapshot until the TTL retires it, so the
sampler skips any source whose snapshot *fingerprint* (arrival time)
has not advanced since the previous sample. ``last_seen`` therefore
freezes the moment the reporter goes silent, which is what the SLO
absence rules key on.

The master serves the store on ``GET /timeseries`` next to
``/metrics`` (``?name=<prefix>&window=<secs>&tier=hot|cold``);
``tools/dump_metrics.py --watch`` makes it terminal-friendly.
"""

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

# Sampling the whole cluster view is an O(series) python loop on the
# master tick — the unit-test pin (<1ms at default cadence) assumes the
# series population stays bounded. New series past the cap are dropped
# (counted on ``dropped_series``), never silently re-keyed.
DEFAULT_MAX_SERIES = 4096


def quantile_from_buckets(bucket_ubs: Tuple[float, ...],
                          bucket_deltas: List[float],
                          q: float,
                          total: Optional[float] = None) -> float:
    """Nearest-rank quantile estimate from per-bucket observation
    counts (NON-cumulative, matching ``registry`` snapshots): the
    upper bound of the bucket containing the q-th observation.

    ``total`` is the TRUE observation count (the histogram's ``count``
    delta) — observations above the top bucket land in no bucket at
    all, only in ``count``, so ranking against the in-bucket sum alone
    would blind the quantile to the overflow regime entirely (a
    300s-stale freshness histogram with a 120s top bucket would report
    p99=0). A rank past the buckets SATURATES at the last bucket
    bound: the honest reading is "at least this", and it stays
    JSON-safe (``json.dumps`` would emit the non-standard ``Infinity``
    token strict parsers reject)."""
    in_buckets = float(sum(bucket_deltas))
    total = in_buckets if total is None else max(float(total),
                                                in_buckets)
    if total <= 0 or not bucket_ubs:
        return 0.0
    rank = q * total
    seen = 0.0
    for ub, n in zip(bucket_ubs, bucket_deltas):
        seen += float(n)
        if seen >= rank:
            return float(ub)
    return float(bucket_ubs[-1])


class _Series:
    """One sampled series: hot ring of raw samples + cold ring of
    downsampled points + staleness bookkeeping.

    Hot point shapes (tuples, kept tiny on purpose):
      counter:   ``(t, dt, delta)``
      gauge:     ``(t, value)``
      histogram: ``(t, dt, count_d, sum_d, buckets_d)``

    The append path is the sampler's hot loop (every series of every
    reporter, every cadence) and is pinned <1ms per master tick by a
    unit test — per-point work is one ring append plus an integer
    bucket compare; cold-tier aggregation happens once per resolution
    bucket by scanning the hot ring's tail at flush time, never per
    point.
    """

    __slots__ = ("family", "kind", "labels", "source", "bucket_ubs",
                 "points", "cold", "prev", "last_seen", "_cold_bucket")

    def __init__(self, family: str, kind: str, labels: Dict[str, str],
                 source: str, bucket_ubs: Tuple[float, ...],
                 hot_capacity: int, cold_capacity: int):
        self.family = family
        self.kind = kind
        self.labels = labels
        self.source = source
        self.bucket_ubs = bucket_ubs
        self.points = deque(maxlen=hot_capacity)
        self.cold = deque(maxlen=cold_capacity)
        self.prev = None       # last raw cumulative (counter/histogram)
        self.last_seen = 0.0   # wall time of the newest appended point
        self._cold_bucket = None  # resolution bucket of the ring tail

    def key(self) -> str:
        label_text = ",".join(
            f"{k}={v}" for k, v in sorted(self.labels.items())
        )
        key = self.family
        if label_text:
            key += "{%s}" % label_text
        if self.source:
            key += f"@{self.source}"
        return key

    # ---- append --------------------------------------------------------

    def _maybe_flush_cold(self, t: float, resolution: float):
        """Called BEFORE appending a point: when ``t`` enters a new
        cold-resolution bucket, aggregate the previous bucket's points
        (still the ring tail) into one cold point."""
        bucket = int(t // resolution)
        prev_bucket = self._cold_bucket
        if bucket == prev_bucket:
            return
        self._cold_bucket = bucket
        if prev_bucket is None:
            return
        lo = prev_bucket * resolution
        tail = []
        for point in reversed(self.points):
            if point[0] < lo:
                break
            tail.append(point)
        if tail:
            self._flush_cold((prev_bucket + 1) * resolution, tail)

    def _flush_cold(self, t_end: float, tail: List[tuple]):
        if self.kind == GAUGE:
            values = [p[1] for p in tail]
            self.cold.append((
                t_end, sum(values) / len(values), min(values),
                max(values),
            ))
        elif self.kind == COUNTER:
            dt = sum(p[1] for p in tail)
            self.cold.append((t_end, dt, sum(p[2] for p in tail)))
        else:
            dt = sum(p[1] for p in tail)
            count_d = sum(p[2] for p in tail)
            sum_d = sum(p[3] for p in tail)
            buckets_d = [0.0] * len(self.bucket_ubs)
            for point in tail:
                for i, b in enumerate(point[4]):
                    buckets_d[i] += b
            self.cold.append((
                t_end, dt, count_d, sum_d,
                quantile_from_buckets(self.bucket_ubs, buckets_d, 0.50,
                                      total=count_d),
                quantile_from_buckets(self.bucket_ubs, buckets_d, 0.99,
                                      total=count_d),
            ))

    def append_scalar(self, t: float, value: float, dt: float,
                      cold_resolution: float):
        if self.kind == COUNTER:
            prev = self.prev
            self.prev = value
            if prev is None:
                self.last_seen = t
                return
            # dt must be PER-SERIES: a reporter piggybacking every 15s
            # against a 5s sampler is skipped on unchanged fingerprints,
            # so its delta spans since ITS last ingested sample — the
            # global inter-sample interval would inflate its rate 3x.
            if self.last_seen > 0 and t > self.last_seen:
                dt = t - self.last_seen
            delta = value - prev
            if delta < 0:
                # Counter reset (process restart): the new cumulative
                # value IS the growth since the reset.
                delta = value
            if delta == 0:
                # Idle counter: a zero-delta point adds nothing to any
                # window sum — skip it (liveness rides last_seen).
                self.last_seen = t
                return
            self._maybe_flush_cold(t, cold_resolution)
            self.points.append((t, dt, delta))
        else:
            self._maybe_flush_cold(t, cold_resolution)
            self.points.append((t, value))
        self.last_seen = t

    def append_hist(self, t: float, dt: float, count: float, total: float,
                    buckets: List[float], cold_resolution: float):
        prev = self.prev
        self.prev = (count, total, buckets)
        if prev is None:
            self.last_seen = t
            return
        # Per-series dt, same rationale as append_scalar.
        if self.last_seen > 0 and t > self.last_seen:
            dt = t - self.last_seen
        count_d = count - prev[0]
        if count_d == 0 and total == prev[1]:
            # Idle histogram (the steady-state majority): nothing to
            # add to any window — skip the point entirely.
            self.last_seen = t
            return
        if count_d < 0 or len(buckets) != len(prev[2]):
            # Histogram reset (process restart / bucket change): treat
            # the new cumulative values as the interval's growth.
            count_d, sum_d = count, total
            buckets_d = list(buckets)
        else:
            sum_d = total - prev[1]
            buckets_d = [b - p for b, p in zip(buckets, prev[2])]
        self._maybe_flush_cold(t, cold_resolution)
        self.points.append((t, dt, count_d, sum_d, buckets_d))
        self.last_seen = t

    # ---- render --------------------------------------------------------

    def render_points(self, window: Optional[float], now: float,
                      tier: str = "hot",
                      points: Optional[List[tuple]] = None,
                      cold: Optional[List[tuple]] = None) -> List[list]:
        """JSON-safe points. Hot: gauges ``[t, value]``, counters
        ``[t, rate]``, histograms ``[t, rate, mean]``. Cold: gauges
        ``[t, mean, min, max]``, counters ``[t, rate]``, histograms
        ``[t, rate, p50, p99]``.

        ``points``/``cold`` override the live deques — the store's
        ``render`` passes copies taken under its lock, because
        iterating the live deque races the sampler's appends
        (RuntimeError: deque mutated during iteration)."""
        hot_points = self.points if points is None else points
        cold_points = self.cold if cold is None else cold
        cutoff = (now - window) if window else None
        out = []
        if tier == "cold":
            for point in cold_points:
                if cutoff is not None and point[0] < cutoff:
                    continue
                if self.kind == GAUGE:
                    t, mean, mn, mx = point
                    out.append([t, mean, mn, mx])
                elif self.kind == COUNTER:
                    t, dt, delta = point
                    out.append([t, delta / dt if dt > 0 else 0.0])
                else:
                    t, dt, count_d, _sum_d, p50, p99 = point
                    out.append([
                        t, count_d / dt if dt > 0 else 0.0, p50, p99,
                    ])
            return out
        for point in hot_points:
            if cutoff is not None and point[0] < cutoff:
                continue
            if self.kind == GAUGE:
                out.append([point[0], point[1]])
            elif self.kind == COUNTER:
                t, dt, delta = point
                out.append([t, delta / dt if dt > 0 else 0.0])
            else:
                t, dt, count_d, sum_d, _buckets = point
                out.append([
                    t, count_d / dt if dt > 0 else 0.0,
                    sum_d / count_d if count_d > 0 else 0.0,
                ])
        return out


class TimeSeriesStore:
    """Bounded in-memory time series over registry snapshots.

    ``sample(sources)`` ingests ``{source: (snapshot, fingerprint)}``
    — source ``""`` is the master-local registry, others are cluster
    reporters keyed the way ``ClusterMetrics`` keys them (worker ids,
    ``router-N``). A source whose fingerprint matches the previous
    sample is skipped entirely: piggybacked snapshots linger in the
    cluster view until the TTL retires them, and re-appending the same
    snapshot would flat-line a dead reporter instead of letting its
    series go stale. ``fingerprint=None`` always samples (the local
    registry is live by definition).
    """

    def __init__(self, cadence_secs: float = 5.0,
                 hot_capacity: int = 720,
                 cold_resolution_secs: float = 60.0,
                 cold_capacity: int = 1440,
                 max_series: int = DEFAULT_MAX_SERIES,
                 clock: Callable[[], float] = time.time):
        self.cadence_secs = float(cadence_secs)
        self.hot_capacity = int(hot_capacity)
        self.cold_resolution_secs = float(cold_resolution_secs)
        self.cold_capacity = int(cold_capacity)
        self.max_series = int(max_series)
        self._clock = clock
        self._lock = threading.Lock()
        self._series: Dict[Tuple, _Series] = {}
        self._source_fingerprints: Dict[str, object] = {}
        self._last_sample_at: Optional[float] = None
        self.sample_count = 0
        self.dropped_series = 0
        self.last_sample_cost_secs = 0.0

    # ---- sampling ------------------------------------------------------

    def due(self, now: Optional[float] = None) -> bool:
        now = self._clock() if now is None else now
        return (self._last_sample_at is None
                or now - self._last_sample_at >= self.cadence_secs)

    def sample(self, sources: Dict[str, tuple],
               now: Optional[float] = None) -> int:
        now = self._clock() if now is None else now
        cost_t0 = time.monotonic()
        prev_at = self._last_sample_at
        dt = (now - prev_at) if prev_at is not None else self.cadence_secs
        if dt <= 0:
            dt = self.cadence_secs
        updated = 0
        with self._lock:
            self._last_sample_at = now
            for source, entry in sources.items():
                snapshot, fingerprint = entry
                if not snapshot:
                    continue
                if fingerprint is not None:
                    if self._source_fingerprints.get(source) \
                            == fingerprint:
                        continue
                    self._source_fingerprints[source] = fingerprint
                updated += self._ingest_snapshot_locked(
                    str(source), snapshot, now, dt
                )
        self.sample_count += 1
        self.last_sample_cost_secs = time.monotonic() - cost_t0
        return updated

    def _ingest_snapshot_locked(self, source: str, snapshot: dict,
                                now: float, dt: float) -> int:
        # The sampler's hot loop — every series of every reporter each
        # cadence, pinned <1ms per tick by a unit test. Keys come
        # straight from the snapshot's label-value list (registry
        # label values are already strings in declaration order), so
        # the steady state per series is one dict hit + one append.
        updated = 0
        series_map = self._series
        resolution = self.cold_resolution_secs
        for family in snapshot.get("families", ()):
            name = family.get("name")
            kind = family.get("kind")
            if not name or kind not in (COUNTER, GAUGE, HISTOGRAM):
                continue
            is_hist = kind == HISTOGRAM
            for series in family.get("series", ()):
                values = series.get("labels")
                skey = (name, source, tuple(values) if values else ())
                entry = series_map.get(skey)
                if entry is None:
                    if len(series_map) >= self.max_series:
                        self.dropped_series += 1
                        continue
                    entry = series_map[skey] = _Series(
                        name, kind,
                        dict(zip(family.get("labelnames", ()),
                                 values or ())),
                        source,
                        tuple(family.get("buckets", ()))
                        if is_hist else (),
                        self.hot_capacity, self.cold_capacity,
                    )
                if is_hist:
                    buckets = series.get("buckets", ())
                    if len(buckets) != len(entry.bucket_ubs):
                        # Bucket config changed across a process
                        # restart: keep quantile bounds in step with
                        # the new points.
                        entry.bucket_ubs = tuple(
                            family.get("buckets", ())
                        )
                    entry.append_hist(
                        now, dt, series.get("count", 0),
                        series.get("sum", 0.0), buckets, resolution,
                    )
                else:
                    entry.append_scalar(
                        now, series.get("value", 0.0), dt, resolution,
                    )
                updated += 1
        return updated

    def drop_source(self, source: str) -> int:
        """Forget every series of one reporter — the DELIBERATE
        departure path (autoscaler drain, master recovery dropping a
        dead id). Without this, a scaled-away worker's frozen series
        would trip the absence rules meant for reporters that died
        unexpectedly. Returns the number of series dropped."""
        source = str(source)
        with self._lock:
            keys = [k for k in self._series if k[1] == source]
            for key in keys:
                del self._series[key]
            self._source_fingerprints.pop(source, None)
        return len(keys)

    # ---- selection -----------------------------------------------------

    def _match_locked(self, family: str,
                      labels: Optional[Dict[str, str]] = None,
                      source: Optional[str] = None) -> List[_Series]:
        out = []
        for entry in self._series.values():
            if entry.family != family:
                continue
            if source is not None and entry.source != source:
                continue
            if labels and any(
                entry.labels.get(k) != str(v) for k, v in labels.items()
            ):
                continue
            out.append(entry)
        return out

    # ---- window reductions (the SLO engine's inputs) -------------------

    def window_hist(self, family: str, window_secs: float,
                    labels: Optional[Dict[str, str]] = None,
                    source: Optional[str] = None,
                    now: Optional[float] = None):
        """Summed histogram deltas over the trailing window across all
        matching series: ``(count, sum, bucket_deltas, bucket_ubs)``.
        ``bucket_deltas`` is None when no matching histogram exists."""
        now = self._clock() if now is None else now
        cutoff = now - float(window_secs)
        count = 0.0
        total = 0.0
        deltas: Optional[List[float]] = None
        ubs: Tuple[float, ...] = ()
        with self._lock:
            for entry in self._match_locked(family, labels, source):
                if entry.kind != HISTOGRAM:
                    continue
                if len(entry.bucket_ubs) > len(ubs):
                    ubs = entry.bucket_ubs
                for t, _dt, count_d, sum_d, buckets_d in entry.points:
                    if t < cutoff:
                        continue
                    count += count_d
                    total += sum_d
                    if deltas is None:
                        deltas = list(buckets_d)
                        continue
                    # Points in one window can carry different bucket
                    # counts: a process restarted with changed bucket
                    # config appends new-length points into the same
                    # ring (append_hist treats that as a reset). Grow
                    # and add up to each point's own length — the
                    # reduction must degrade, not IndexError the rule
                    # blind across the restart it should survive.
                    if len(buckets_d) > len(deltas):
                        deltas.extend(
                            [0.0] * (len(buckets_d) - len(deltas))
                        )
                    for i, b in enumerate(buckets_d):
                        deltas[i] += b
        return count, total, deltas, ubs

    def window_quantile(self, family: str, window_secs: float, q: float,
                        labels: Optional[Dict[str, str]] = None,
                        source: Optional[str] = None,
                        now: Optional[float] = None,
                        ) -> Tuple[float, float]:
        """(quantile estimate, observation count) over the window."""
        count, _total, deltas, ubs = self.window_hist(
            family, window_secs, labels, source, now
        )
        if not deltas or count <= 0:
            return 0.0, 0.0
        return quantile_from_buckets(ubs, deltas, q, total=count), count

    def window_counter_delta(self, family: str, window_secs: float,
                             labels: Optional[Dict[str, str]] = None,
                             source: Optional[str] = None,
                             now: Optional[float] = None,
                             ) -> Tuple[float, int]:
        """(summed counter delta, point count) over the window."""
        now = self._clock() if now is None else now
        cutoff = now - float(window_secs)
        delta = 0.0
        n = 0
        with self._lock:
            for entry in self._match_locked(family, labels, source):
                if entry.kind != COUNTER:
                    continue
                for t, _dt, d in entry.points:
                    if t < cutoff:
                        continue
                    delta += d
                    n += 1
        return delta, n

    def gauge_values(self, family: str, window_secs: float,
                     labels: Optional[Dict[str, str]] = None,
                     source: Optional[str] = None,
                     now: Optional[float] = None) -> List[float]:
        """Every gauge point in the window across matching series,
        in TIME order — the autoscaler's trend input, and what makes
        the threshold rule's ``last`` aggregation mean "newest
        observation", not "final point of whichever series the store
        happened to create last"."""
        now = self._clock() if now is None else now
        cutoff = now - float(window_secs)
        out = []
        with self._lock:
            for entry in self._match_locked(family, labels, source):
                if entry.kind != GAUGE:
                    continue
                out.extend(
                    (t, v) for t, v in entry.points if t >= cutoff
                )
        out.sort(key=lambda tv: tv[0])
        return [v for _t, v in out]

    def last_seen(self, family: str,
                  labels: Optional[Dict[str, str]] = None,
                  source: Optional[str] = None) -> Dict[str, float]:
        """series key -> wall time of its newest point (frozen once
        the reporter goes silent; the absence rules' input)."""
        with self._lock:
            return {
                entry.key(): entry.last_seen
                for entry in self._match_locked(family, labels, source)
                if entry.last_seen > 0
            }

    # ---- endpoint / bundle rendering -----------------------------------

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(e.key() for e in self._series.values())

    def render(self, name: Optional[str] = None,
               window_secs: Optional[float] = None,
               tier: str = "hot",
               now: Optional[float] = None) -> dict:
        """JSON body for ``GET /timeseries`` (and the incident bundle's
        series window): ``name`` is a family-name prefix filter."""
        now = self._clock() if now is None else now
        tier = tier if tier in ("hot", "cold") else "hot"
        series = {}
        # Deque copies taken under the lock: a /timeseries GET (or an
        # incident writer) rendering concurrently with the sampler's
        # appends must not iterate a mutating deque.
        with self._lock:
            entries = [
                (e, list(e.points), list(e.cold))
                for e in self._series.values()
                if not name or e.family.startswith(name)
            ]
        for entry, hot_copy, cold_copy in entries:
            points = entry.render_points(
                window_secs, now, tier, points=hot_copy, cold=cold_copy
            )
            if not points:
                continue
            series[entry.key()] = {
                "kind": entry.kind,
                "family": entry.family,
                "source": entry.source,
                "last_seen": entry.last_seen,
                "points": points,
            }
        return {
            "now": now,
            "tier": tier,
            "cadence_secs": self.cadence_secs,
            "window_secs": window_secs,
            "series": series,
        }
