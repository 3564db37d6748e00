"""Overload controls: priority admission, retry budgets, circuit
breakers, and hedged calls (docs/fault_tolerance.md "Graceful
degradation").

A copy of elasticdl_tpu/comm/overload.py: the port keeps its own.

Every robustness mechanism before this plane handled *death* — SIGKILL
then WAL replay, fenced failover, task re-queue. Nothing handled
*degradation*: a slow-but-alive shard (gray failure) produces
unbounded queueing, priority inversion (background migration starving
serving reads), and client retry amplification. These four primitives
are the brownout answer; ``chaos/brownout_drill.py`` proves them
against a no-control baseline that demonstrably inverts priorities.

- ``AdmissionController`` — a bounded concurrency gate in front of a
  service's handlers. Requests classify by the PR 16 principal
  purpose into priority tiers; tier N is admitted only while the
  total in-flight count is under its (shrinking) share of the limit,
  so as a shard saturates, canary work sheds first, then background
  (migration / replica refresh / checkpoint / replay), then training
  — serving reads and control traffic keep the full limit. Sheds are
  retryable RESOURCE_EXHAUSTED with a retry-after hint in the detail
  string (``format_shed_detail`` / ``parse_retry_after``).
- ``RetryBudget`` — a client-side token bucket shared per service:
  each retry spends one token, successes and wall time refill it.
  Replaces "N retries per call" (which multiplies under fan-out: 100
  concurrent calls x 5 retries = 500 extra requests at the worst
  moment) with "this client may add at most ``capacity`` extra
  requests, then ``refill_per_sec``" — the amplification cap the
  brownout drill gates at 2x offered load.
- ``CircuitBreaker`` — per-target transport-failure breaker: trips
  open after ``failure_threshold`` CONSECUTIVE transport failures,
  fails fast (UNAVAILABLE) while open, half-opens one probe after a
  jittered cooldown. Only transport-dead codes trip it; sheds and
  deadline misses mean the server is alive and deciding.
- ``hedged_call`` — tail-tolerant read hedging for idempotent pulls:
  fire a second attempt after a p99-derived delay
  (``HedgeTimer.delay``), first response wins, the loser is
  abandoned (best-effort cancellation — unary gRPC cannot be
  recalled off the wire).

Observability: ``edl_tpu_overload_shed_total{purpose}``,
``edl_tpu_overload_queue_depth``,
``edl_tpu_rpc_retry_budget_exhausted_total{service}``,
``edl_tpu_rpc_breaker_state{target}`` (0 closed / 1 open / 2
half-open), ``edl_tpu_rpc_hedge_attempts_total`` /
``edl_tpu_rpc_hedge_wins_total{service,method}``; default SLO rules
in ``observability/slo.py`` burn on shed rate and breaker state.
"""

import random as _random
import re
import threading
import time
from concurrent import futures
from typing import Callable, Dict, Optional

# ---- priority ladder ----------------------------------------------------

# Purpose -> tier (lower = more important). Mirrors the closed enum in
# observability/principal.py; anything unlisted (including the
# "unknown" fallback) rides with training: ordinary work, sheddable
# before serving but after background.
PRIORITY_TIERS: Dict[str, int] = {
    "serving_read": 0,
    "control": 0,
    "training": 1,
    "streaming_ingest": 1,
    "migration": 2,
    "replica_refresh": 2,
    "checkpoint": 2,
    "replay": 2,
    "canary": 3,
}
DEFAULT_TIER = 1

# Tier N is admitted while inflight < limit * TIER_FRACTIONS[N]. Tier
# 0 keeps the full limit: a saturated shard serves reads until it
# physically cannot.
TIER_FRACTIONS = (1.0, 0.85, 0.70, 0.50)

# Purposes the brownout drill (and check_overload) count as
# background: sheddable ahead of training, invisible to the serving
# SLO.
BACKGROUND_PURPOSES = (
    "migration", "replica_refresh", "checkpoint", "replay", "canary",
)

_RETRY_AFTER_RE = re.compile(r"retry after ([0-9.]+)s")


def tier_of(purpose: Optional[str]) -> int:
    return PRIORITY_TIERS.get(purpose or "", DEFAULT_TIER)


def format_shed_detail(purpose: str, tier: int,
                       retry_after: float) -> str:
    """The RESOURCE_EXHAUSTED detail string. Clients recover the hint
    with ``parse_retry_after`` — a detail-string contract rather than
    trailing metadata because the msgpack RPC layer surfaces only
    (code, details) through ``RpcError``."""
    return (f"overloaded: shed {purpose or 'unknown'} (tier {tier}); "
            f"retry after {retry_after:.3f}s")


def parse_retry_after(detail: str) -> Optional[float]:
    """The server's retry-after hint out of a shed detail string, or
    None when the error is not a shed (plain RESOURCE_EXHAUSTED from
    elsewhere backs off normally)."""
    m = _RETRY_AFTER_RE.search(detail or "")
    return float(m.group(1)) if m else None


def _registry():
    from elasticdl_tpu_torch.observability import default_registry

    return default_registry()


class AdmissionController:
    """Bounded, priority-tiered admission in front of a service.

    One shared in-flight counter; tier N admits only while the count
    is under ``limit * TIER_FRACTIONS[N]``. No queue on purpose: a
    shed is an immediate, cheap, RETRYABLE rejection with a hint, and
    the client's budgeted backoff IS the queue — queueing shed work
    server-side would hold the very threads the shed exists to free.

    ``try_acquire`` / ``release`` bracket the handler (the RPC server
    wrap calls them); both are O(1) under one lock.
    """

    def __init__(self, limit: int, retry_after_base: float = 0.1,
                 tag: str = ""):
        if int(limit) <= 0:
            raise ValueError(f"admission limit must be > 0, got {limit}")
        self.limit = int(limit)
        self._retry_after_base = float(retry_after_base)
        self._tag = tag
        # Tier thresholds, precomputed. Every tier admits at least one
        # request on an idle server (a tiny limit must not starve
        # canaries outright).
        self._thresholds = tuple(
            max(1, int(self.limit * frac)) for frac in TIER_FRACTIONS
        )
        self._lock = threading.Lock()
        self._inflight = 0
        registry = _registry()
        self._m_shed = registry.counter(
            "overload_shed_total",
            "Requests shed by priority admission control",
            ["purpose"],
        )
        self._m_depth = registry.gauge(
            "overload_queue_depth",
            "Requests currently admitted and in flight behind the "
            "admission gate",
        )

    def threshold(self, tier: int) -> int:
        return self._thresholds[min(max(tier, 0),
                                    len(self._thresholds) - 1)]

    def try_acquire(self, purpose: Optional[str]) -> bool:
        """Admit (True; caller MUST ``release()``) or shed (False)."""
        tier = tier_of(purpose)
        with self._lock:
            if self._inflight < self.threshold(tier):
                self._inflight += 1
                depth = self._inflight
                shed = False
            else:
                shed = True
        if shed:
            self._m_shed.labels(purpose or "unknown").inc()
            return False
        self._m_depth.set(float(depth))
        return True

    def release(self):
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            depth = self._inflight
        self._m_depth.set(float(depth))

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def retry_after_hint(self, purpose: Optional[str]) -> float:
        """Lower tiers are told to stay away longer — the server-side
        half of priority backoff (clients jitter around the hint)."""
        return self._retry_after_base * (tier_of(purpose) + 1)

    def shed_verdict(self, purpose: Optional[str]):
        """The (code, detail) the RPC wrap aborts a shed call with."""
        hint = self.retry_after_hint(purpose)
        return ("RESOURCE_EXHAUSTED",
                format_shed_detail(purpose or "unknown",
                                   tier_of(purpose), hint))


# ---- retry budget -------------------------------------------------------


class RetryBudget:
    """Token-bucket retry budget, shared per service per process.

    Retries spend one token; tokens refill with wall time
    (``refill_per_sec``) and a little with each success
    (``success_refill``) so a mostly-healthy client regains headroom.
    The defaults sustain a patient ride-out loop (one retry every
    couple of seconds, e.g. a worker riding out a master failover:
    spend rate well under refill rate) while cutting a retry storm off
    after ``capacity`` fast-fail retries — bounding amplification at
    roughly ``1 + capacity/offered + refill/rate`` instead of ``1 +
    max_retries``.
    """

    def __init__(self, capacity: float = 32.0,
                 refill_per_sec: float = 1.0,
                 success_refill: float = 0.05,
                 key: str = ""):
        self.capacity = float(capacity)
        self.refill_per_sec = float(refill_per_sec)
        self.success_refill = float(success_refill)
        self.key = key or "default"
        self._lock = threading.Lock()
        self._tokens = self.capacity
        self._last_refill = time.monotonic()

    def _refill_locked(self, now: float):
        elapsed = now - self._last_refill
        self._last_refill = now
        if elapsed > 0:
            self._tokens = min(self.capacity,
                               self._tokens + elapsed * self.refill_per_sec)

    def try_spend(self) -> bool:
        """Spend one token for a retry; False = budget exhausted (the
        caller must give up instead of retrying, and the exhaustion is
        metered)."""
        now = time.monotonic()
        with self._lock:
            self._refill_locked(now)
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
        _registry().counter(
            "rpc_retry_budget_exhausted_total",
            "Retries suppressed because the per-service retry budget "
            "ran dry (the retry-storm amplification guard)",
            ["service"],
        ).labels(self.key).inc()
        return False

    def on_success(self):
        now = time.monotonic()
        with self._lock:
            self._refill_locked(now)
            self._tokens = min(self.capacity,
                               self._tokens + self.success_refill)

    def tokens(self) -> float:
        with self._lock:
            self._refill_locked(time.monotonic())
            return self._tokens


_budget_lock = threading.Lock()
_budgets: Dict[str, RetryBudget] = {}


def retry_budget_for(service: str, **kwargs) -> RetryBudget:
    """The process-wide shared budget for one service name. Shared on
    purpose: amplification is a property of ALL of a client process's
    traffic at a service, not of one call site."""
    with _budget_lock:
        budget = _budgets.get(service)
        if budget is None:
            budget = _budgets[service] = RetryBudget(key=service,
                                                     **kwargs)
        return budget


def reset_retry_budgets():
    """Tests only: forget every shared budget (full buckets again)."""
    with _budget_lock:
        _budgets.clear()


# ---- circuit breaker ----------------------------------------------------

BREAKER_CLOSED = 0
BREAKER_OPEN = 1
BREAKER_HALF_OPEN = 2


class CircuitBreaker:
    """Per-target transport breaker.

    CLOSED counts CONSECUTIVE transport failures; at
    ``failure_threshold`` it OPENs and ``allow()`` fails fast until a
    jittered cooldown elapses, then HALF_OPENs exactly one probe: the
    probe's success re-CLOSEs, its failure re-OPENs with a fresh
    jittered cooldown. Jitter matters: every client of a dead shard
    opened at the same instant, and un-jittered probes would re-herd
    on the recovering server (the decorrelated-jitter rationale,
    applied to probes).

    Only transport-dead failures should be recorded (``UNAVAILABLE``
    — the channel, not the handler): a shed (RESOURCE_EXHAUSTED) or a
    blown deadline is a live server making a decision, and tripping
    on those would turn a brownout into a blackout.
    """

    def __init__(self, target: str, failure_threshold: int = 8,
                 cooldown_secs: float = 1.0, rand=None):
        self.target = target
        self.failure_threshold = int(failure_threshold)
        self.cooldown_secs = float(cooldown_secs)
        self._rand = rand if rand is not None else _random.random
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._consecutive_failures = 0
        self._probe_at = 0.0
        self._set_gauge(BREAKER_CLOSED)

    def _set_gauge(self, state: int):
        _registry().gauge(
            "rpc_breaker_state",
            "Circuit breaker state per target (0 closed, 1 open, "
            "2 half-open probing)",
            ["target"],
        ).labels(self.target).set(float(state))

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a send attempt go out now? While OPEN, exactly one
        caller per cooldown is admitted as the half-open probe."""
        now = time.monotonic()
        with self._lock:
            if self._state == BREAKER_CLOSED:
                return True
            if self._state == BREAKER_OPEN and now >= self._probe_at:
                self._state = BREAKER_HALF_OPEN
                self._set_gauge(BREAKER_HALF_OPEN)
                return True  # this caller is the probe
            return False

    def on_success(self):
        with self._lock:
            self._consecutive_failures = 0
            if self._state != BREAKER_CLOSED:
                self._state = BREAKER_CLOSED
                self._set_gauge(BREAKER_CLOSED)

    def on_failure(self):
        now = time.monotonic()
        with self._lock:
            self._consecutive_failures += 1
            tripping = (
                self._state == BREAKER_HALF_OPEN
                or (self._state == BREAKER_CLOSED
                    and self._consecutive_failures
                    >= self.failure_threshold)
            )
            if tripping:
                self._state = BREAKER_OPEN
                self._probe_at = now + self.cooldown_secs * (
                    0.5 + self._rand()
                )
                self._set_gauge(BREAKER_OPEN)


_breaker_lock = threading.Lock()
_breakers: Dict[str, CircuitBreaker] = {}
_controls_enabled = True


def breaker_for(target: str, **kwargs) -> CircuitBreaker:
    with _breaker_lock:
        breaker = _breakers.get(target)
        if breaker is None:
            breaker = _breakers[target] = CircuitBreaker(target,
                                                         **kwargs)
        return breaker


def set_controls_enabled(enabled: bool) -> bool:
    """Kill-switch for the CLIENT-side controls — retry budgets and
    circuit breakers — mirroring ``principal.set_enabled``. The
    uncontrolled baseline of the brownout drill turns them off to
    reproduce the pre-overload-plane retry-storm behavior; operators
    get the same escape hatch. Returns the previous setting."""
    global _controls_enabled
    with _breaker_lock:
        prev = _controls_enabled
        _controls_enabled = bool(enabled)
        return prev


def controls_enabled() -> bool:
    return _controls_enabled


def reset_breakers():
    """Tests only: forget every breaker (all closed again)."""
    with _breaker_lock:
        _breakers.clear()


# ---- hedged calls -------------------------------------------------------


class HedgeTimer:
    """Sliding-window latency tracker that derives the hedge delay:
    fire the second attempt only once the first has outlived the
    tracked p99 (clamped to [floor, cap]) — hedging sooner doubles
    load for no tail win, later wins nothing."""

    def __init__(self, window: int = 128, percentile: float = 0.99,
                 floor: float = 0.01, cap: float = 1.0):
        self._window = int(window)
        self._percentile = float(percentile)
        self._floor = float(floor)
        self._cap = float(cap)
        self._lock = threading.Lock()
        self._samples = []
        self._idx = 0

    def observe(self, secs: float):
        with self._lock:
            if len(self._samples) < self._window:
                self._samples.append(float(secs))
            else:
                self._samples[self._idx] = float(secs)
                self._idx = (self._idx + 1) % self._window

    def delay(self) -> float:
        with self._lock:
            if not self._samples:
                return self._cap
            ordered = sorted(self._samples)
            k = min(len(ordered) - 1,
                    int(self._percentile * len(ordered)))
            p = ordered[k]
        return min(self._cap, max(self._floor, p))


_hedge_lock = threading.Lock()
_hedge_pool: Optional[futures.ThreadPoolExecutor] = None


def _pool() -> futures.ThreadPoolExecutor:
    global _hedge_pool
    with _hedge_lock:
        if _hedge_pool is None:
            _hedge_pool = futures.ThreadPoolExecutor(
                max_workers=16, thread_name_prefix="rpc-hedge"
            )
        return _hedge_pool


def hedged_call(primary: Callable, secondary: Optional[Callable],
                delay_secs: float, service: str = "",
                method: str = ""):
    """Run ``primary``; if it has not answered after ``delay_secs``,
    ALSO run ``secondary`` and return the first success. ONLY for
    idempotent reads — a hedged write is a duplicate write.

    First-response-wins with best-effort cancellation: the loser's
    future is cancelled if still queued; once on the wire a unary gRPC
    attempt cannot be recalled, so an in-flight loser just completes
    into the void (its result is dropped). Both failing re-raises the
    primary's error. ``secondary=None`` degrades to a plain call.
    """
    if secondary is None:
        return primary()
    registry = _registry()
    m_attempts = registry.counter(
        "rpc_hedge_attempts_total",
        "Hedged second attempts fired after the p99-derived delay",
        ["service", "method"],
    )
    m_wins = registry.counter(
        "rpc_hedge_wins_total",
        "Hedged calls answered by the SECOND attempt",
        ["service", "method"],
    )
    pool = _pool()
    first = pool.submit(primary)
    try:
        return first.result(timeout=delay_secs)
    except futures.TimeoutError:
        pass
    except Exception:
        # Primary failed fast: the hedge is a straight fallback.
        m_attempts.labels(service, method).inc()
        result = secondary()
        m_wins.labels(service, method).inc()
        return result
    m_attempts.labels(service, method).inc()
    second = pool.submit(secondary)
    done, _pending = futures.wait(
        (first, second), return_when=futures.FIRST_COMPLETED
    )
    # Prefer a finished SUCCESS; tolerate one loser's failure.
    for preferred in (first, second):
        if preferred in done and preferred.exception() is None:
            if preferred is second:
                m_wins.labels(service, method).inc()
            (second if preferred is first else first).cancel()
            return preferred.result()
    # Whichever finished, failed; wait the other out.
    other = second if first in done else first
    try:
        result = other.result()
        if other is second:
            m_wins.labels(service, method).inc()
        return result
    except Exception:
        # Both lost: surface the primary's error.
        return first.result()
