"""Ambient request deadlines: the propagation half of the overload
plane (docs/fault_tolerance.md "Graceful degradation").

A copy of elasticdl_tpu/comm/deadline.py: the port keeps its own.

A deadline is an ABSOLUTE wall-clock instant (``time.time()`` domain)
by which the caller stops caring about the answer. It rides the same
ambient thread-local discipline as the workload principal
(``observability/principal.py``) and the same wire piggyback seam
(``comm/rpc.py`` carries it as a ``_deadline`` request field next to
``_trace_ctx``/``_principal``):

- A caller opens a scope with ``with running_out(budget_secs):``.
  Nested scopes can only SHRINK the deadline (min with the parent) —
  a callee must never outlive its caller's patience.
- ``RpcStub.call`` derives each hop's gRPC timeout from
  ``remaining()`` (min with any explicit per-call timeout) and stamps
  the absolute instant on the wire, so a three-hop fan-out under one
  500 ms budget spends ONE budget, not three.
- The server wrap re-establishes the wire deadline as the handler's
  ambient scope — internal fan-outs (row-service client waves,
  migration pushes, replica refreshes) inherit it with no plumbing —
  and rejects already-expired work before the handler (and therefore
  before the service lock) with a non-retryable DEADLINE_EXCEEDED:
  work nobody is waiting for must not queue behind work somebody is.

Wall clock, not monotonic, on purpose: the instant must be meaningful
across process boundaries. Cross-host clock skew therefore shifts
budgets by the skew; that is the standard deadline-propagation trade
(gRPC's own deadline propagation makes it too) and is bounded by NTP
in any fleet this runs on. Skew never *extends* a budget beyond the
client's own per-hop timeout, which is derived client-side.

Thread pools do not inherit thread-locals: capture-and-rebind with
``bind(fn)`` (or ``snapshot()`` + ``running_at()``) when fanning work
out, exactly as ``row_service._run_jobs`` does.
"""

import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional

# Minimum per-hop timeout handed to gRPC when a deadline is nearly
# (but not yet) expired: a 2 ms budget still sends one attempt rather
# than tripping grpc's own zero-timeout edge cases.
MIN_HOP_TIMEOUT_SECS = 1e-3

_local = threading.local()


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def current() -> Optional[float]:
    """The ambient absolute deadline (seconds since the epoch), or
    None when no scope is open."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def remaining(now: Optional[float] = None) -> Optional[float]:
    """Seconds left on the ambient deadline (may be <= 0 once
    expired); None when no scope is open."""
    instant = current()
    if instant is None:
        return None
    return instant - (time.time() if now is None else now)


def expired(now: Optional[float] = None) -> bool:
    left = remaining(now)
    return left is not None and left <= 0.0


@contextmanager
def running_at(instant: Optional[float]):
    """Open a deadline scope at an ABSOLUTE instant. Nested scopes
    take the min with the parent — a child can tighten the budget,
    never extend it. ``None`` is a no-op scope (keeps call sites
    branch-free when a wire field may be absent)."""
    if instant is None:
        yield None
        return
    stack = _stack()
    parent = stack[-1] if stack else None
    effective = instant if parent is None else min(instant, parent)
    stack.append(effective)
    try:
        yield effective
    finally:
        # Out-of-order-exit safe (the principal stack's discipline):
        # remove OUR entry, wherever a misnested exit left it.
        try:
            stack.remove(effective)
        except ValueError:
            pass


def running_out(budget_secs: float):
    """Open a deadline scope ``budget_secs`` from now (the common
    entry point: ``with deadline.running_out(0.5): ...``)."""
    return running_at(time.time() + float(budget_secs))


def wire() -> Optional[float]:
    """The value the RPC client piggybacks (absolute seconds), or
    None when no scope is open."""
    return current()


def snapshot() -> Optional[float]:
    """Capture the ambient deadline for re-establishment on another
    thread (thread pools do not inherit thread-locals)."""
    return current()


def bind(fn: Callable) -> Callable:
    """Wrap ``fn`` so it runs under the CURRENT thread's ambient
    deadline when later invoked on a pool thread — the fan-out
    inheritance helper (``row_service._run_jobs``)."""
    instant = current()
    if instant is None:
        return fn

    def bound(*args, **kwargs):
        with running_at(instant):
            return fn(*args, **kwargs)

    return bound


def hop_timeout(explicit: Optional[float] = None) -> Optional[float]:
    """The per-hop gRPC timeout for one send attempt: the smaller of
    the explicit per-call timeout and the ambient remaining budget
    (floored at MIN_HOP_TIMEOUT_SECS so an almost-spent budget still
    gets one attempt). None when neither bounds the call."""
    left = remaining()
    if left is None:
        return explicit
    left = max(left, MIN_HOP_TIMEOUT_SECS)
    if explicit is None:
        return left
    return min(float(explicit), left)
