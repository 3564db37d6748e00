"""Workload principals: who an RPC is *for*, threaded through the fleet.

A copy of elasticdl_tpu/observability/principal.py: the port keeps its own.

Every metric/span/profile in the stack is per-component (worker 3,
rowservice 0) — useful for "where is the time going", useless for "who
is spending it" once several workloads share one row tier. A
**principal** is the attribution identity ``{job, component, purpose}``:

- ``job``        — the workload name ("mnist-train", "ranker-serve");
                   free-form, so metering folds overflow to
                   ``__other__`` (``usage.fold_job``) to bound label
                   cardinality;
- ``component``  — which part of the job issued the call ("worker",
                   "router", "master");
- ``purpose``    — WHY the bytes moved, from the closed enum
                   ``PURPOSES``: client training pushes vs serving
                   reads vs the system's own internal traffic
                   (migration streams, replica refresh, WAL replay,
                   checkpoint capture, control-plane chatter).

Propagation mirrors tracing (``tracing.py``): an ambient thread-local
stack, a process-wide default (``set_process_principal`` — analogous
to ``set_process_role``), and a ``_principal`` piggyback field that
``RpcStub.call`` injects next to ``_trace_ctx`` and the server wrap
strips before the handler runs. Internal fan-outs self-tag by wrapping
their loop in ``pushed(purpose=...)`` — migration chunks, replica
refresh threads, and WAL replay inherit job/component from the ambient
principal and override only the purpose, so no per-call-site plumbing.

Unlike tracing, principals flow even with no flight recorder
installed: attribution is always-on metering, not sampling. The cost
with no ambient principal set is one thread-local read per RPC. The
``set_enabled(False)`` kill-switch (used by the attribution drill's
baseline phase) turns both the piggyback and the usage meters into
no-ops so overhead can be measured against a true off state.
"""

import threading
from contextlib import contextmanager
from typing import Optional

# Closed purpose enum. "unknown" is the absence value — never sent on
# the wire, only synthesized server-side when a request carried no (or
# a malformed) principal — so the attribution drill's ">=95% of handler
# time is non-unknown" gate is measurable from the labels alone.
PURPOSES = (
    "training",
    "serving_read",
    "migration",
    "replica_refresh",
    "replay",
    "checkpoint",
    "control",
    "streaming_ingest",
    "canary",
)
UNKNOWN = "unknown"

_local = threading.local()  # .stack: [Principal]
_PROCESS_DEFAULT: Optional["Principal"] = None
_ENABLED = True


class Principal:
    """Immutable attribution identity. ``purpose`` outside ``PURPOSES``
    is coerced to ``unknown`` (the wire is untrusted; the label set is
    closed)."""

    __slots__ = ("job", "component", "purpose")

    def __init__(self, job: str = UNKNOWN, component: str = UNKNOWN,
                 purpose: str = UNKNOWN):
        object.__setattr__(self, "job", str(job) or UNKNOWN)
        object.__setattr__(self, "component", str(component) or UNKNOWN)
        purpose = str(purpose)
        if purpose not in PURPOSES and purpose != UNKNOWN:
            purpose = UNKNOWN
        object.__setattr__(self, "purpose", purpose)

    def __setattr__(self, name, value):
        raise AttributeError("Principal is immutable")

    def __repr__(self):
        return (f"Principal(job={self.job!r}, "
                f"component={self.component!r}, "
                f"purpose={self.purpose!r})")

    def __eq__(self, other):
        return (isinstance(other, Principal)
                and self.job == other.job
                and self.component == other.component
                and self.purpose == other.purpose)

    def __hash__(self):
        return hash((self.job, self.component, self.purpose))

    def wire(self) -> dict:
        """The ``_principal`` piggyback payload."""
        return {"job": self.job, "component": self.component,
                "purpose": self.purpose}

    def replace(self, job: Optional[str] = None,
                component: Optional[str] = None,
                purpose: Optional[str] = None) -> "Principal":
        return Principal(
            self.job if job is None else job,
            self.component if component is None else component,
            self.purpose if purpose is None else purpose,
        )


NOBODY = Principal()  # the all-unknown principal (absence value)


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> bool:
    """Attribution kill-switch: off disables the RPC piggyback and all
    usage metering (``usage.py``). The drill's overhead gate compares
    enabled vs disabled p99 — disabled must be a true zero-cost path,
    not 'enabled but discarded'. Returns the previous state."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    return prev


def set_process_principal(job: Optional[str] = None,
                          component: Optional[str] = None,
                          purpose: Optional[str] = None):
    """Process-wide fallback for threads with no pushed principal —
    process mains set this once (worker → purpose=training, serving →
    serving_read, master → control), like ``tracing.set_process_role``.
    ``None`` for every field clears it."""
    global _PROCESS_DEFAULT
    if job is None and component is None and purpose is None:
        _PROCESS_DEFAULT = None
    else:
        _PROCESS_DEFAULT = Principal(job or UNKNOWN,
                                     component or UNKNOWN,
                                     purpose or UNKNOWN)


def current() -> Optional["Principal"]:
    """Innermost pushed principal, else the process default, else
    None."""
    stack = getattr(_local, "stack", None)
    if stack:
        return stack[-1]
    return _PROCESS_DEFAULT


def current_wire() -> Optional[dict]:
    """What ``RpcStub.call`` injects as ``_principal`` — None when
    attribution is off or nothing is ambient (the server then meters
    the request as ``unknown``)."""
    if not _ENABLED:
        return None
    principal = current()
    return principal.wire() if principal is not None else None


def from_wire(payload) -> Optional["Principal"]:
    """Parse a ``_principal`` piggyback dict; malformed fields coerce
    to ``unknown`` (the Principal constructor enforces the closed
    purpose enum), non-dicts to None."""
    if not isinstance(payload, dict):
        return None
    return Principal(
        payload.get("job") or UNKNOWN,
        payload.get("component") or UNKNOWN,
        payload.get("purpose") or UNKNOWN,
    )


@contextmanager
def pushed(job: Optional[str] = None, component: Optional[str] = None,
           purpose: Optional[str] = None,
           principal: Optional["Principal"] = None):
    """Push a principal for the dynamic extent of a block. Unset
    fields inherit from the current ambient principal, so internal
    fan-outs override only what changed::

        with principal.pushed(purpose="migration"):
            transport.call("ingest_rows", ...)  # rides as migration

    ``principal=`` pushes an explicit Principal verbatim (the server
    wrap re-establishing the caller's wire identity)."""
    if principal is None:
        base = current() or NOBODY
        principal = base.replace(job=job, component=component,
                                 purpose=purpose)
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    stack.append(principal)
    try:
        yield principal
    finally:
        # Remove OUR entry even if a generator finalized out of order
        # (same discipline as tracing.Span.__exit__).
        if stack and stack[-1] is principal:
            stack.pop()
        else:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] is principal:
                    del stack[i]
                    break


def span_attrs(principal: Optional["Principal"]) -> dict:
    """Principal fields as span attributes (``principal_job`` /
    ``principal_component`` / ``principal_purpose``) — what the server
    wrap tags onto ``serve/*`` spans so ``critical_path.py`` and
    ``/profile`` can filter by workload. Empty when nothing to tag."""
    if principal is None:
        return {}
    return {
        "principal_job": principal.job,
        "principal_component": principal.component,
        "principal_purpose": principal.purpose,
    }
