"""Serving fleet front-end: route, hedge, and shed across replicas (port
of elasticdl_tpu/serving/router.py; it imports no torch and touches no
card).

N stateless predict replicas (``serving/server.py`` processes of either
package) stand in front of the one row service that remains the source
of truth (each replica's hot-row cache, ``serving/model_store.py``,
only memoizes reads of it).

- **Routing policies**: ``least_loaded`` (default) picks the healthy
  replica with the fewest router-tracked in-flight requests,
  round-robin among ties. ``hash`` is an opt-in consistent-hash ring
  over a routing key (``X-User-Id`` header, else a digest of the
  request body): one user's ids keep landing on one replica, so that
  replica's hot-row LRU holds their rows — higher cache hit rate,
  bought with worse load balance (docs/serving.md "Fleet").
  Removing a replica from the ring only remaps the keys that lived on
  it; everyone else's affinity (and cache) survives.
- **Request hedging**: after an adaptive delay (p95 of recent attempt
  latencies, clamped to [hedge_min_ms, hedge_max_ms]) a straggling
  request is re-issued to a DIFFERENT replica with ``X-Hedge: 1``;
  first answer wins, the loser's connection is closed (its replica
  sheds hedges first under pressure, so speculation never compounds an
  overload). The tracing plane's ``route``/``attempt`` spans land on a
  ``router`` track next to the replicas' ``queue_wait``/``predict``
  spans, so hedge wins are attributable end to end.
- **Tiered shedding**: the router tracks fleet load (in-flight /
  (healthy replicas x replica_concurrency)) and sheds in tiers —
  hedging stops first, then low-priority traffic 429s with
  ``Retry-After``, then everything. Replicas keep their own queue-depth
  tiers (serving/server.py) as the second line of defense.
- **Health**: a connection failure marks a replica unhealthy
  immediately (routing skips it); a background prober restores it when
  ``/healthz`` answers again.

The wire is the JAX router's: the predict request and reply pass
through unchanged, the ``X-Priority``, ``X-Hedge`` and ``X-User-Id``
headers, the 429's ``Retry-After`` and ``X-Shed-Tier``, and the
consistent-hash ring (blake2b ``_hash64``, 64 virtual nodes), so a port
router fronts JAX replicas and a JAX router fronts port replicas.

With ``--master_addr`` (``RouterServer(master_addr=)``) a
``ComponentMetricsReporter`` folds the router's registry into the
master's cluster view as ``router-<router_id>``; ``--profile_hz`` runs
the sampling profiler, whose windows ride those reports.
"""

import hashlib
import http.client
import json
import threading
import time
from bisect import bisect_right
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.observability import (
    default_registry,
    render_prometheus,
    tracing,
)
from elasticdl_tpu_torch.observability.slo import RollingWindow

logger = get_logger("router")


def _hash64(key: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(),
        "big",
    )


class Replica:
    """One backend ``serving/server.py`` process as the router sees it:
    address, router-tracked in-flight count, health, and a small
    keep-alive connection pool (per-request TCP setup would double the
    router's latency floor)."""

    def __init__(self, addr: str, index: int, pool_size: int = 16,
                 timeout: float = 30.0):
        self.addr = addr
        self.index = index
        self.inflight = 0  # guarded by the router core's lock
        self.healthy = True
        self.consecutive_failures = 0
        self._timeout = float(timeout)
        self._pool: List[http.client.HTTPConnection] = []
        self._pool_size = int(pool_size)
        self._pool_lock = threading.Lock()

    def _new_conn(self) -> http.client.HTTPConnection:
        host, _, port = self.addr.partition(":")
        return http.client.HTTPConnection(
            host, int(port or 80), timeout=self._timeout
        )

    def acquire_conn(self) -> http.client.HTTPConnection:
        with self._pool_lock:
            if self._pool:
                return self._pool.pop()
        return self._new_conn()

    def release_conn(self, conn: http.client.HTTPConnection):
        with self._pool_lock:
            if len(self._pool) < self._pool_size:
                self._pool.append(conn)
                return
        conn.close()

    def close_pool(self):
        with self._pool_lock:
            pool, self._pool = self._pool, []
        for conn in pool:
            conn.close()

    def state(self) -> dict:
        return {
            "addr": self.addr,
            "index": self.index,
            "healthy": self.healthy,
            "inflight": self.inflight,
            "consecutive_failures": self.consecutive_failures,
        }


class LeastLoadedPolicy:
    """Pick the healthy replica with the fewest in-flight requests;
    rotate among ties so an idle fleet still spreads."""

    name = "least_loaded"

    def __init__(self):
        self._tick = 0
        self._lock = threading.Lock()

    def pick(self, replicas: List[Replica], key: Optional[str] = None,
             exclude: Tuple[Replica, ...] = ()) -> Optional[Replica]:
        candidates = [
            r for r in replicas if r.healthy and r not in exclude
        ]
        if not candidates:
            # Everyone looks down: try any non-excluded replica —
            # the prober may lag a recovery, and a failed attempt
            # re-confirms unhealth anyway.
            candidates = [r for r in replicas if r not in exclude]
        if not candidates:
            return None
        with self._lock:
            self._tick += 1
            offset = self._tick
        n = len(replicas)
        return min(
            candidates,
            key=lambda r: (r.inflight, (r.index + offset) % n),
        )


class ConsistentHashPolicy:
    """Consistent-hash ring over a routing key, ``vnodes`` virtual
    nodes per replica. ``pick`` walks clockwise from the key's point,
    skipping unhealthy/excluded replicas — removing a replica only
    remaps the keys that lived on it (cache affinity elsewhere
    survives), which is the property the per-replica hot-row cache
    buys hit rate with."""

    name = "hash"

    def __init__(self, replicas: List[Replica], vnodes: int = 64):
        self._ring: List[Tuple[int, int]] = []  # (point, replica idx)
        for replica in replicas:
            for v in range(vnodes):
                self._ring.append(
                    (_hash64(f"{replica.addr}#{v}"), replica.index)
                )
        self._ring.sort()
        self._fallback = LeastLoadedPolicy()

    def pick(self, replicas: List[Replica], key: Optional[str] = None,
             exclude: Tuple[Replica, ...] = ()) -> Optional[Replica]:
        if key is None or not self._ring:
            return self._fallback.pick(replicas, exclude=exclude)
        by_index = {r.index: r for r in replicas}
        start = bisect_right(self._ring, (_hash64(key), len(replicas)))
        seen = set()
        for i in range(len(self._ring)):
            _, index = self._ring[(start + i) % len(self._ring)]
            if index in seen:
                continue
            seen.add(index)
            replica = by_index.get(index)
            if replica is None or replica in exclude:
                continue
            if replica.healthy:
                return replica
        # Ring exhausted healthy options; last resort like least-loaded.
        return self._fallback.pick(replicas, exclude=exclude)


class AdaptiveHedge:
    """Hedge-delay controller: fire the second attempt once a request
    has outlived the p95 of recent attempt latencies (clamped). Until
    ``min_samples`` attempts are observed the delay pins to the max —
    hedging stays shy until it knows what 'slow' means."""

    def __init__(self, min_ms: float = 5.0, max_ms: float = 1000.0,
                 window: int = 512, min_samples: int = 20):
        self.min_secs = float(min_ms) / 1e3
        self.max_secs = float(max_ms) / 1e3
        self._window = deque(maxlen=int(window))
        self._min_samples = int(min_samples)
        self._lock = threading.Lock()

    def observe(self, secs: float):
        with self._lock:
            self._window.append(float(secs))

    def delay_secs(self) -> float:
        with self._lock:
            if len(self._window) < self._min_samples:
                return self.max_secs
            ordered = sorted(self._window)
            p95 = ordered[min(
                len(ordered) - 1, int(0.95 * len(ordered))
            )]
        return min(self.max_secs, max(self.min_secs, p95))


class _Attempt:
    """One forwarded try of one request against one replica, run on
    its own thread so the router can race a hedge against it."""

    def __init__(self, core: "RouterCore", replica: Replica,
                 body: bytes, content_type: str, priority: str,
                 hedge: bool):
        self.core = core
        self.replica = replica
        self.body = body
        self.content_type = content_type
        self.priority = priority
        self.hedge = hedge
        self.outcome = None  # (status, raw, content_type, retry_after)
        self.error: Optional[Exception] = None
        self.elapsed = 0.0
        self.fired_at = 0.0
        self.done = threading.Event()
        # Invoked in run()'s finally BEFORE done is set: a hedge's
        # race.offer must be visible to anyone done.wait() wakes, or
        # the waiter can read winner=None and discard a good answer.
        self.on_done = None
        self._conn: Optional[http.client.HTTPConnection] = None
        self._cancelled = False
        self._lock = threading.Lock()

    def cancel(self):
        """Loser teardown: closing the socket aborts the blocked
        ``getresponse`` on the attempt thread — the replica-side
        handler finishes its batch slot, but this router thread stops
        waiting and the response bytes are discarded."""
        with self._lock:
            self._cancelled = True
            conn = self._conn
        if conn is not None:
            conn.close()

    def run(self):
        t0 = time.monotonic()
        conn = self.replica.acquire_conn()
        with self._lock:
            if self._cancelled:
                conn.close()
                self.error = RuntimeError("cancelled before send")
                self.core._finish_attempt(self)
                self.done.set()
                return
            self._conn = conn
        headers = {"Content-Type": self.content_type,
                   "X-Priority": self.priority}
        if self.hedge:
            headers["X-Hedge"] = "1"
        try:
            conn.request("POST", "/v1/predict", body=self.body,
                         headers=headers)
            resp = conn.getresponse()
            raw = resp.read()
            self.outcome = (
                resp.status, raw,
                resp.getheader("Content-Type", "application/json"),
                resp.getheader("Retry-After"),
            )
            self.elapsed = time.monotonic() - t0
            with self._lock:
                self._conn = None
                cancelled = self._cancelled
            if cancelled:
                conn.close()
            else:
                self.replica.release_conn(conn)
        except Exception as exc:  # transport failure or cancel
            self.elapsed = time.monotonic() - t0
            self.error = exc
            with self._lock:
                self._conn = None
            conn.close()
        finally:
            self.core._finish_attempt(self)
            if self.on_done is not None:
                try:
                    self.on_done()
                except Exception:
                    logger.exception("attempt on_done callback failed")
            self.done.set()


class _Race:
    """First-usable-answer-wins arbitration between a request's
    attempts."""

    __slots__ = ("winner", "lock", "done")

    def __init__(self):
        self.winner: Optional[_Attempt] = None
        self.lock = threading.Lock()
        self.done = threading.Event()

    def offer(self, attempt: _Attempt) -> bool:
        with self.lock:
            if self.winner is None:
                self.winner = attempt
                self.done.set()
                return True
            return False


class _HedgeScheduler:
    """ONE timer thread arming every pending hedge: the primary
    attempt runs INLINE on its handler thread (the fast path is a
    plain proxy — no thread handoff, no wakeup round trips), so
    something else must watch the clock. Entries fire in deadline
    order; cancellation is a flag (lazy removal)."""

    def __init__(self):
        import heapq

        self._heapq = heapq
        self._heap = []  # (fire_at, seq, entry)
        self._seq = 0
        self._cond = threading.Condition()
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="router-hedge",
            )
            self._thread.start()

    def stop(self):
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def schedule(self, fire_at: float, fn) -> dict:
        entry = {"fn": fn, "cancelled": False}
        with self._cond:
            self._seq += 1
            self._heapq.heappush(
                self._heap, (fire_at, self._seq, entry)
            )
            self._cond.notify_all()
        return entry

    @staticmethod
    def cancel(entry: dict):
        entry["cancelled"] = True

    def _loop(self):
        while True:
            with self._cond:
                while not self._stop:
                    if not self._heap:
                        self._cond.wait()
                        continue
                    delay = self._heap[0][0] - time.monotonic()
                    if delay <= 0:
                        break
                    self._cond.wait(timeout=delay)
                if self._stop:
                    return
                _, _, entry = self._heapq.heappop(self._heap)
            if entry["cancelled"]:
                continue
            try:
                entry["fn"]()
            except Exception:
                logger.exception("hedge fire failed")


class RouterCore:
    """Transport-agnostic routing brain (the HTTP front and the tests
    drive it directly): policy pick + hedging + tiered shedding +
    health bookkeeping."""

    class ShedError(RuntimeError):
        def __init__(self, message: str, tier: str,
                     retry_after: float = 1.0):
            super().__init__(message)
            self.tier = tier
            self.retry_after = retry_after

    class NoReplicaError(RuntimeError):
        pass

    def __init__(self, replica_addrs: List[str],
                 policy: str = "least_loaded",
                 replica_concurrency: int = 32,
                 hedge: bool = True,
                 hedge_min_ms: float = 5.0,
                 hedge_max_ms: float = 1000.0,
                 hedge_shed_frac: float = 0.5,
                 low_shed_frac: float = 0.75,
                 unhealthy_after: int = 1,
                 probe_secs: float = 1.0,
                 replica_timeout: float = 30.0,
                 slo_window_secs: float = 60.0,
                 slo_p95_ms: float = 500.0,
                 slo_error_ratio: float = 0.05,
                 metrics_registry=None):
        if not replica_addrs:
            raise ValueError("router needs at least one replica")
        self.replicas = [
            Replica(addr, i, timeout=replica_timeout)
            for i, addr in enumerate(replica_addrs)
        ]
        # Per-replica SLO status (the /v1/replicas "slo" field): a
        # rolling window of attempt outcomes per replica, judged
        # against a p95-latency + error-ratio objective.
        self.slo_p95_ms = float(slo_p95_ms)
        self.slo_error_ratio = float(slo_error_ratio)
        self._slo_windows = [
            RollingWindow(window_secs=slo_window_secs)
            for _ in self.replicas
        ]
        if policy == "hash":
            self.policy = ConsistentHashPolicy(self.replicas)
        elif policy == "least_loaded":
            self.policy = LeastLoadedPolicy()
        else:
            raise ValueError(
                f"unknown routing policy {policy!r} "
                "(least_loaded | hash)"
            )
        self.replica_concurrency = int(replica_concurrency)
        self.hedge_enabled = bool(hedge)
        self.hedge = AdaptiveHedge(hedge_min_ms, hedge_max_ms)
        self.hedge_shed_frac = float(hedge_shed_frac)
        self.low_shed_frac = float(low_shed_frac)
        self.unhealthy_after = max(1, int(unhealthy_after))
        self.probe_secs = float(probe_secs)
        self._lock = threading.Lock()
        self._inflight_requests = 0
        self._idle = threading.Condition(self._lock)
        self._tracer = tracing.Tracer("router")
        self._stop = threading.Event()
        self._prober: Optional[threading.Thread] = None
        # The PRIMARY attempt runs inline on the handler thread (the
        # fast path is a plain proxy); this pool only runs fired
        # hedges, and the scheduler thread is the only clock watcher.
        from concurrent.futures import ThreadPoolExecutor

        self._executor = ThreadPoolExecutor(
            max_workers=max(
                4, min(64, self.replica_concurrency)
            ),
            thread_name_prefix="router-hedge-attempt",
        )
        self._scheduler = _HedgeScheduler()

        registry = metrics_registry or default_registry()
        self.registry = registry
        self._m_requests = registry.counter(
            "router_requests_total",
            "Routed predict requests by final HTTP status",
            labelnames=("code",),
        )
        self._m_seconds = registry.histogram(
            "router_request_seconds",
            "Route latency (receive to winning reply)",
        )
        self._m_attempts = registry.counter(
            "router_attempts_total",
            "Forwarded attempts per replica",
            labelnames=("replica",),
        )
        self._m_retries = registry.counter(
            "router_failovers_total",
            "Attempts re-routed after a replica transport failure",
        )
        self._m_hedges = registry.counter(
            "router_hedges_total",
            "Hedged second attempts by outcome "
            "(fired / won / cancelled)",
            labelnames=("event",),
        )
        self._m_shed = registry.counter(
            "router_shed_total",
            "Requests shed at the router by tier",
            labelnames=("tier",),
        )
        self._m_unhealthy = registry.counter(
            "router_replica_unhealthy_total",
            "Replica transitions to unhealthy",
        )
        import weakref

        self_ref = weakref.ref(self)
        registry.gauge(
            "router_inflight",
            "Requests currently being routed",
        ).set_function(
            lambda: float(self_ref()._inflight_requests)
            if self_ref() else 0.0
        )
        registry.gauge(
            "router_replicas_healthy",
            "Replicas currently believed healthy",
        ).set_function(
            lambda: float(
                sum(r.healthy for r in self_ref().replicas)
            ) if self_ref() else 0.0
        )
        registry.gauge(
            "router_hedge_delay_seconds",
            "Current adaptive hedge delay (p95-based)",
        ).set_function(
            lambda: self_ref().hedge.delay_secs() if self_ref() else 0.0
        )

    # ---- health --------------------------------------------------------

    def _note_result(self, replica: Replica, ok: bool):
        with self._lock:
            if ok:
                replica.consecutive_failures = 0
                if not replica.healthy:
                    replica.healthy = True
                    logger.info(
                        "replica %s healthy again (request succeeded)",
                        replica.addr,
                    )
                return
            replica.consecutive_failures += 1
            if (replica.healthy
                    and replica.consecutive_failures
                    >= self.unhealthy_after):
                replica.healthy = False
                self._m_unhealthy.inc()
                logger.warning(
                    "replica %s marked unhealthy after %d failures",
                    replica.addr, replica.consecutive_failures,
                )
        if not replica.healthy:
            # Stale keep-alive conns to a dead process HANG (the
            # listener is gone but the kernel keeps the socket);
            # restore with fresh connections after /healthz answers.
            replica.close_pool()

    def _probe_once(self):
        for replica in self.replicas:
            if replica.healthy:
                continue
            try:
                conn = replica._new_conn()
                try:
                    conn.request("GET", "/healthz")
                    status = conn.getresponse().status
                finally:
                    conn.close()
            except Exception:
                continue
            if status == 200:
                with self._lock:
                    replica.healthy = True
                    replica.consecutive_failures = 0
                logger.info("replica %s healthy again (probe)",
                            replica.addr)

    def _probe_loop(self):
        while not self._stop.wait(self.probe_secs):
            try:
                self._probe_once()
            except Exception:
                logger.exception("replica probe failed")

    def start(self) -> "RouterCore":
        self._scheduler.start()
        if self._prober is None:
            self._prober = threading.Thread(
                target=self._probe_loop, daemon=True,
                name="router-probe",
            )
            self._prober.start()
        return self

    def stop(self):
        self._stop.set()
        self._scheduler.stop()
        if self._prober is not None:
            self._prober.join(timeout=5)
            self._prober = None
        self._executor.shutdown(wait=False)
        for replica in self.replicas:
            replica.close_pool()

    # ---- shedding ------------------------------------------------------

    def load_factor(self) -> float:
        healthy = sum(r.healthy for r in self.replicas)
        capacity = max(1, healthy) * self.replica_concurrency
        return self._inflight_requests / capacity

    def _admit(self, priority: str):
        """Tiered admission: everything sheds at capacity, low
        priority earlier; hedging is suppressed separately in
        ``handle`` (tier 'hedge' = speculation stops first)."""
        load = self.load_factor()
        if load >= 1.0:
            raise self.ShedError(
                f"router at capacity (load {load:.2f})",
                tier="capacity", retry_after=2.0,
            )
        if priority == "low" and load >= self.low_shed_frac:
            raise self.ShedError(
                f"low-priority shed (load {load:.2f})",
                tier="low", retry_after=1.0,
            )

    # ---- routing -------------------------------------------------------

    def _finish_attempt(self, attempt: _Attempt):
        with self._lock:
            attempt.replica.inflight -= 1
        if attempt.error is None and attempt.outcome is not None \
                and attempt.outcome[0] == 200:
            # Only served answers are service-time samples: a replica
            # shedding 429s answers in ~1ms, and feeding those into
            # the p95 window would collapse the hedge delay to its
            # floor exactly when the fleet is overloaded — doubling
            # attempt volume with zero headroom.
            self.hedge.observe(attempt.elapsed)
        if not attempt._cancelled:
            # A cancelled loser says nothing about replica health.
            ok = attempt.error is None
            self._note_result(attempt.replica, ok)
            # SLO sample: transport failures and 5xx count against the
            # replica. Sheds (429) are EXCLUDED entirely — same
            # discipline as the hedge window above: an overloaded
            # replica answering fast 429s would otherwise report a
            # collapsed p95 and a clean error ratio (ok=true) exactly
            # during the overload /v1/replicas exists to surface.
            if attempt.outcome is not None \
                    and attempt.outcome[0] == 429:
                return
            served_ok = ok and attempt.outcome is not None \
                and attempt.outcome[0] < 500
            self._slo_windows[attempt.replica.index].record(
                served_ok, attempt.elapsed
            )

    def _make_attempt(self, replica: Replica, body, content_type,
                      priority, hedge: bool) -> _Attempt:
        attempt = _Attempt(
            self, replica, body, content_type, priority, hedge
        )
        with self._lock:
            replica.inflight += 1
        self._m_attempts.labels(replica=str(replica.index)).inc()
        attempt.fired_at = time.monotonic()
        return attempt

    def _fire_hedge(self, race: _Race, primary: _Attempt, body,
                    content_type, priority, routing_key, hedge_box):
        """Scheduler callback at the hedge deadline: if the primary is
        still out and the fleet has headroom, race a second attempt on
        another replica. The winner cancels the loser — closing the
        primary's socket is what unblocks its inline handler thread."""
        if primary.done.is_set() or race.winner is not None:
            return
        if self.load_factor() >= self.hedge_shed_frac:
            return
        second = self.policy.pick(
            self.replicas, key=routing_key,
            exclude=(primary.replica,),
        )
        if second is None:
            return
        attempt = self._make_attempt(
            second, body, content_type, priority, hedge=True
        )

        def settle():
            if self._usable(attempt) and race.offer(attempt):
                primary.cancel()

        attempt.on_done = settle
        hedge_box.append(attempt)
        self._m_hedges.labels(event="fired").inc()
        self._executor.submit(attempt.run)

    def handle(self, body: bytes, content_type: str,
               priority: str = "normal",
               routing_key: Optional[str] = None,
               timeout: float = 30.0):
        """Route one predict request; returns (status, raw_body,
        content_type, headers). Raises ShedError / NoReplicaError."""
        t0 = time.monotonic()
        with self._lock:
            self._admit(priority)  # reads inflight under the lock
            self._inflight_requests += 1
        try:
            with self._tracer.span(
                "route", priority=priority,
                policy=self.policy.name,
            ) as route_span:
                result = self._handle_inner(
                    body, content_type, priority, routing_key,
                    timeout, route_span,
                )
            self._m_seconds.observe(time.monotonic() - t0)
            self._m_requests.labels(code=str(result[0])).inc()
            return result
        finally:
            with self._idle:  # same lock as self._lock
                self._inflight_requests -= 1
                self._idle.notify_all()

    @staticmethod
    def _usable(attempt: _Attempt) -> bool:
        """An answer the client can have. A hedge's own 429 is NOT
        one — that's the replica shedding the speculation (tier
        'hedge') while the primary still works."""
        return attempt.outcome is not None and not (
            attempt.hedge and attempt.outcome[0] == 429
        )

    def _record_attempt_span(self, route_span, attempt: _Attempt):
        if route_span.span_id is None:
            return
        tracing.record_span(
            "attempt",
            time.monotonic() - attempt.elapsed, attempt.elapsed,
            trace_id=route_span.trace_id,
            parent_id=route_span.span_id,
            role="router",
            replica=attempt.replica.index,
            hedge=attempt.hedge,
            status=(attempt.outcome[0]
                    if attempt.outcome else "error"),
        )

    def _handle_inner(self, body, content_type, priority, routing_key,
                      timeout, route_span):
        deadline = time.monotonic() + timeout
        primary_replica = self.policy.pick(self.replicas,
                                           key=routing_key)
        if primary_replica is None:
            raise self.NoReplicaError("no replica available")
        race = _Race()
        hedge_box: List[_Attempt] = []  # appended by the scheduler
        primary = self._make_attempt(
            primary_replica, body, content_type, priority, hedge=False
        )
        hedge_token = None
        if (self.hedge_enabled and len(self.replicas) > 1
                and self.load_factor() < self.hedge_shed_frac):
            hedge_token = self._scheduler.schedule(
                time.monotonic() + self.hedge.delay_secs(),
                lambda: self._fire_hedge(
                    race, primary, body, content_type, priority,
                    routing_key, hedge_box,
                ),
            )
        # The primary runs INLINE: the fast path is one proxied HTTP
        # round trip on this very thread. A winning hedge closes the
        # primary's socket, which is what unblocks this call early.
        primary.run()
        if hedge_token is not None:
            self._scheduler.cancel(hedge_token)
        if self._usable(primary):
            race.offer(primary)
        winner = race.winner
        if winner is None and hedge_box:
            # Primary failed (or returned a discarded answer) with a
            # hedge in flight: its result is the next best hope.
            hedge_box[0].done.wait(
                max(0.0, deadline - time.monotonic())
            )
            winner = race.winner
        if winner is None:
            # Nothing usable yet: one inline failover onto an
            # untried replica.
            tried = (primary.replica,) + tuple(
                a.replica for a in hedge_box
            )
            fallback = self.policy.pick(
                self.replicas, key=routing_key, exclude=tried
            )
            if fallback is not None \
                    and time.monotonic() < deadline:
                self._m_retries.inc()
                failover = self._make_attempt(
                    fallback, body, content_type, priority,
                    hedge=False,
                )
                failover.run()
                if self._usable(failover):
                    race.offer(failover)
                winner = race.winner
        if winner is None:
            for attempt in [primary] + hedge_box:
                if not attempt.done.is_set():
                    attempt.cancel()
            errors = [
                a.error for a in [primary] + hedge_box
                if a.error is not None
            ]
            if errors:
                raise errors[0]
            raise RuntimeError("no usable replica response")
        # Settle the race: cancel the in-flight loser, account wins.
        for attempt in [primary] + hedge_box:
            if attempt is winner:
                continue
            if not attempt.done.is_set():
                attempt.cancel()
                if attempt.hedge:
                    self._m_hedges.labels(event="cancelled").inc()
        if winner.hedge:
            self._m_hedges.labels(event="won").inc()
            if primary._cancelled:
                # A primary a hedge had to rescue is suspect: count a
                # failure so repeat offenders go unhealthy and the
                # /healthz prober must clear them (a merely slow
                # replica answers the probe and comes right back; a
                # dead one stays out instead of burning a hedge per
                # request until its socket timeout).
                self._note_result(primary.replica, ok=False)
        self._record_attempt_span(route_span, winner)
        route_span.set(
            replica=winner.replica.index, hedged=winner.hedge,
            status=winner.outcome[0],
        )
        status, raw, ctype, retry_after = winner.outcome
        headers = []
        if retry_after:
            headers.append(("Retry-After", retry_after))
        return status, raw, ctype, headers

    # ---- drain ---------------------------------------------------------

    def wait_idle(self, timeout: float) -> bool:
        """Block until no request is in flight (hedges included —
        every attempt decrements before its route returns)."""
        deadline = time.monotonic() + timeout
        with self._idle:
            while self._inflight_requests > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._idle.wait(timeout=min(remaining, 0.05))
        return True

    def replica_slo(self, index: int) -> dict:
        """Windowed per-replica SLO status: request count, error
        ratio, p95, and the ok verdict against the configured
        objective. ``ok`` is None (unknown) on an empty window — a
        just-started or idle replica has no evidence either way."""
        status = self._slo_windows[index].status()
        if status["requests"] == 0:
            status["ok"] = None
            return status
        status["ok"] = bool(
            status["error_ratio"] <= self.slo_error_ratio
            and (self.slo_p95_ms <= 0
                 or status["p95_ms"] <= self.slo_p95_ms)
        )
        return status

    def states(self) -> List[dict]:
        with self._lock:
            states = [r.state() for r in self.replicas]
        for state in states:
            state["slo"] = self.replica_slo(state["index"])
        return states


class _RouterHandler(BaseHTTPRequestHandler):
    server_ref = None  # type: Optional[RouterServer]

    protocol_version = "HTTP/1.1"

    def _reply(self, code: int, body: bytes, content_type: str,
               headers=()):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for name, value in headers:
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _reply_json_error(self, code: int, message: str, headers=()):
        self._reply(
            code, json.dumps({"error": message}).encode("utf-8"),
            "application/json", headers,
        )

    def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
        srv = type(self).server_ref
        core = srv.core
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = render_prometheus(core.registry.snapshot())
            self._reply(
                200, body.encode("utf-8"),
                "text/plain; version=0.0.4; charset=utf-8",
            )
        elif path == "/traces":
            body = json.dumps(
                {"spans": tracing.recorder_spans()}
            ).encode("utf-8")
            self._reply(200, body, "application/json")
        elif path == "/healthz":
            ok = any(r.healthy for r in core.replicas)
            self._reply(
                200 if ok else 503,
                b"ok\n" if ok else b"no healthy replica\n",
                "text/plain; charset=utf-8",
            )
        elif path == "/v1/replicas":
            body = json.dumps({
                "policy": core.policy.name,
                "load_factor": round(core.load_factor(), 4),
                "hedge_delay_ms": round(
                    core.hedge.delay_secs() * 1e3, 3
                ),
                "replicas": core.states(),
            }).encode("utf-8")
            self._reply(200, body, "application/json")
        elif path == "/v1/models":
            # Pass through to a healthy replica so clients discover
            # the feature signature through the router unchanged.
            replica = core.policy.pick(core.replicas)
            if replica is None:
                self._reply_json_error(503, "no replica available")
                return
            try:
                conn = replica.acquire_conn()
                try:
                    conn.request("GET", "/v1/models")
                    resp = conn.getresponse()
                    raw = resp.read()
                    self._reply(
                        resp.status, raw,
                        resp.getheader(
                            "Content-Type", "application/json"
                        ),
                    )
                finally:
                    replica.release_conn(conn)
            except Exception as exc:
                self._reply_json_error(502, f"replica error: {exc}")
        else:
            self.send_error(
                404, "try /v1/predict, /v1/replicas, /metrics"
            )

    def do_POST(self):  # noqa: N802
        srv = type(self).server_ref
        core = srv.core
        path = self.path.split("?", 1)[0]
        if path != "/v1/predict":
            self.send_error(404, "POST /v1/predict")
            return
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        content_type = self.headers.get(
            "Content-Type", "application/json"
        )
        priority = self.headers.get("X-Priority", "normal").lower()
        if priority not in ("high", "normal", "low"):
            priority = "normal"
        routing_key = self.headers.get(srv.routing_key_header)
        if routing_key is None and core.policy.name == "hash":
            # No explicit user id: key on the payload itself — the
            # same ids still land on the same replica's cache.
            routing_key = hashlib.blake2b(
                body, digest_size=8
            ).hexdigest()
        if srv.draining:
            core._m_shed.labels(tier="draining").inc()
            core._m_requests.labels(code="429").inc()
            self._reply_json_error(
                429, "router draining (SIGTERM)",
                headers=(("Retry-After", "2"),),
            )
            return
        try:
            status, raw, ctype, headers = core.handle(
                body, content_type, priority=priority,
                routing_key=routing_key, timeout=srv.request_timeout,
            )
        except RouterCore.ShedError as exc:
            core._m_shed.labels(tier=exc.tier).inc()
            core._m_requests.labels(code="429").inc()
            self._reply_json_error(
                429, str(exc),
                headers=(
                    ("Retry-After",
                     str(max(1, int(round(exc.retry_after))))),
                    ("X-Shed-Tier", exc.tier),
                ),
            )
            return
        except RouterCore.NoReplicaError as exc:
            core._m_requests.labels(code="503").inc()
            self._reply_json_error(503, str(exc))
            return
        except TimeoutError as exc:
            core._m_requests.labels(code="504").inc()
            self._reply_json_error(504, str(exc))
            return
        except Exception as exc:
            core._m_requests.labels(code="502").inc()
            self._reply_json_error(
                502, f"{type(exc).__name__}: {exc}"
            )
            return
        self._reply(status, raw, ctype, headers)

    def log_message(self, fmt, *args):
        logger.debug("router http: " + fmt, *args)


class RouterServer:
    """The assembled router process: core + HTTP front + drain."""

    def __init__(self, replica_addrs: List[str], port: int = 8600,
                 host: str = "", request_timeout: float = 30.0,
                 routing_key_header: str = "X-User-Id",
                 master_addr: str = "", router_id: int = 0,
                 metrics_report_secs: float = 15.0,
                 **core_kwargs):
        self.core = RouterCore(replica_addrs, **core_kwargs)
        self.request_timeout = float(request_timeout)
        self.routing_key_header = routing_key_header
        self.draining = False
        self._host = host
        self._requested_port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # Fold this router's telemetry into the training master's
        # cluster view (keyed router-<id>; same TTL aging and
        # time-series sampling as a worker's piggybacked snapshots).
        self._reporter = None
        if master_addr:
            from elasticdl_tpu_torch.observability.reporter import (
                ComponentMetricsReporter,
            )

            self._reporter = ComponentMetricsReporter(
                master_addr, "router", router_id,
                interval_secs=metrics_report_secs,
                registry=self.core.registry,
            )

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else 0

    def start(self) -> "RouterServer":
        self.core.start()
        handler = type("_BoundRouterHandler", (_RouterHandler,), {
            "server_ref": self,
        })
        self._httpd = ThreadingHTTPServer(
            (self._host, self._requested_port), handler,
            bind_and_activate=False,
        )
        # Same rationale as serving/server.py: the default backlog (5)
        # SYN-drops a client fleet connecting at once.
        self._httpd.request_queue_size = 128
        self._httpd.server_bind()
        self._httpd.server_activate()
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="router-http",
        )
        self._thread.start()
        if self._reporter is not None:
            self._reporter.start()
        logger.info(
            "Router on port %d over %d replica(s), policy=%s",
            self.port, len(self.core.replicas), self.core.policy.name,
        )
        return self

    def wait(self):
        self._thread.join()

    def stop(self):
        if self._reporter is not None:
            self._reporter.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.core.stop()

    def drain(self, grace: float = 25.0) -> bool:
        """Graceful SIGTERM shutdown mirroring serving/server.py:
        stop accepting, let in-flight (hedged) requests settle inside
        ``grace``, then tear down. The router must not be the fleet's
        new hard-kill point."""
        logger.info("draining router (grace %.1fs)", grace)
        self.draining = True
        if self._reporter is not None:
            self._reporter.stop()
        if self._httpd is not None:
            # Stop the accept loop; handler threads for accepted
            # requests keep running and block in core.handle().
            self._httpd.shutdown()
        settled = self.core.wait_idle(timeout=grace)
        if self._httpd is not None:
            self._httpd.server_close()
            self._httpd = None
        self.core.stop()
        logger.info(
            "router drained (%s)",
            "clean" if settled
            else "grace expired with requests in flight",
        )
        return settled


def main(argv=None) -> int:
    """``elasticdl_tpu_torch route`` entry: front a replica fleet.

    Minimal deployment: N ``serve`` replicas (each with
    ``--row_cache_capacity`` for row-service bundles) + one router:

        python -m elasticdl_tpu_torch route \\
            --replicas host1:8500,host2:8500 --port 8600
    """
    import argparse
    import os
    import signal

    from elasticdl_tpu_torch.serving.server import add_telemetry_flags

    parser = argparse.ArgumentParser("elasticdl_tpu_torch-route")
    parser.add_argument(
        "--replicas", required=True,
        help="Comma list of serving replica host:port addresses",
    )
    parser.add_argument("--port", type=int, default=8600)
    parser.add_argument(
        "--policy", default="least_loaded",
        choices=("least_loaded", "hash"),
        help="least_loaded balances; hash (consistent hash on "
             "X-User-Id, else a body digest) trades balance for "
             "per-replica row-cache hit rate",
    )
    parser.add_argument(
        "--routing_key_header", default="X-User-Id",
        help="Header carrying the consistent-hash routing key",
    )
    parser.add_argument("--request_timeout", type=float, default=30.0)
    parser.add_argument(
        "--replica_concurrency", type=int, default=32,
        help="Assumed per-replica in-flight capacity; fleet load "
             "factor = inflight / (healthy x this)",
    )
    parser.add_argument(
        "--no_hedge", action="store_true",
        help="Disable speculative second attempts",
    )
    parser.add_argument("--hedge_min_ms", type=float, default=5.0)
    parser.add_argument("--hedge_max_ms", type=float, default=1000.0)
    parser.add_argument(
        "--hedge_shed_frac", type=float, default=0.5,
        help="Load factor past which hedging stops (shed tier 1)",
    )
    parser.add_argument(
        "--low_shed_frac", type=float, default=0.75,
        help="Load factor past which low-priority sheds (tier 2)",
    )
    parser.add_argument(
        "--probe_secs", type=float, default=1.0,
        help="Unhealthy-replica /healthz probe interval",
    )
    parser.add_argument(
        "--drain_grace", type=float, default=25.0,
        help="SIGTERM drain budget for in-flight hedged requests",
    )
    parser.add_argument(
        "--flight_recorder", type=int, default=0,
        help="Install a span flight recorder of this many entries "
             "(route/attempt spans on the router track, served on "
             "/traces). 0 (default) = off",
    )
    parser.add_argument(
        "--replica_slo_window_secs", type=float, default=60.0,
        help="Rolling window for the per-replica SLO status on "
             "/v1/replicas",
    )
    parser.add_argument(
        "--replica_slo_p95_ms", type=float, default=500.0,
        help="Per-replica p95 latency objective (ms); <=0 disables "
             "the latency clause",
    )
    parser.add_argument(
        "--replica_slo_error_ratio", type=float, default=0.05,
        help="Per-replica windowed error-ratio objective",
    )
    add_telemetry_flags(parser, "router", "router_id")
    args = parser.parse_args(argv)

    from elasticdl_tpu_torch.observability import principal

    principal.set_process_principal(
        job=os.environ.get("ELASTICDL_JOB_NAME", ""),
        component="router", purpose="serving_read",
    )
    if args.flight_recorder > 0:
        tracing.set_process_role("router")
        tracing.install_recorder(
            tracing.FlightRecorder(args.flight_recorder))
    from elasticdl_tpu_torch.observability import profiler as _profiler

    _profiler.maybe_start_from_args(args, "router", str(args.router_id))

    addrs = [a.strip() for a in args.replicas.split(",") if a.strip()]
    server = RouterServer(
        addrs, port=args.port,
        request_timeout=args.request_timeout,
        routing_key_header=args.routing_key_header,
        policy=args.policy,
        replica_concurrency=args.replica_concurrency,
        hedge=not args.no_hedge,
        hedge_min_ms=args.hedge_min_ms,
        hedge_max_ms=args.hedge_max_ms,
        hedge_shed_frac=args.hedge_shed_frac,
        low_shed_frac=args.low_shed_frac,
        probe_secs=args.probe_secs,
        master_addr=args.master_addr,
        router_id=args.router_id,
        metrics_report_secs=args.metrics_report_secs,
        slo_window_secs=args.replica_slo_window_secs,
        slo_p95_ms=args.replica_slo_p95_ms,
        slo_error_ratio=args.replica_slo_error_ratio,
    ).start()
    logger.info(
        "Routing :%d -> %s (policy=%s, hedge=%s)",
        server.port, ",".join(addrs), args.policy,
        "off" if args.no_hedge else "adaptive-p95",
    )
    stop_evt = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda *_: stop_evt.set())
        signal.signal(signal.SIGINT, lambda *_: stop_evt.set())
    except ValueError:
        server.wait()
        return 0
    stop_evt.wait()
    server.drain(grace=args.drain_grace)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
