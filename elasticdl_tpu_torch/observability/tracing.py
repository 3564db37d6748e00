"""Distributed tracing: spans, flight recorder, cross-RPC context (copy
of elasticdl_tpu/observability/tracing.py; the port keeps its own).

The metrics plane (registry/aggregator) answers *how much / how often*;
this module answers *where the time went for one task or one request*.
A ``Tracer`` produces **spans** — named intervals with a ``trace_id``
(the tree they belong to), ``span_id``, ``parent_id``, attributes, and
monotonic ``t0``/``dur`` — into a bounded per-process ring buffer, the
**flight recorder**. Trace context rides thread-locally within a
process and as a ``_trace_ctx`` field on the framework's RPCs
(``comm/rpc.py``), so one task's tree spans master dispatch → worker
step phases → row-service pulls in a single connected tree.

Cost discipline (same as the chaos seams): with **no recorder
installed** every ``span()`` call is one module-global read returning a
shared no-op span — the instrumented step loop pays nothing measurable
(the JAX package's tests/test_tracing.py guards that). Span ids come
from ``uuid4`` (urandom), never wall-clock, so installing a recorder
cannot perturb chaos determinism (same-seed reports stay
byte-identical; the recorder is only *dumped* into red reports).

Collection piggybacks on the worker-snapshot RPCs the metrics
aggregator uses: ``spans_since`` gives each reporter an incremental
cursor into the ring, and the master's ``TraceCollector`` dedups by
span id (several in-process workers may share one recorder). Export
to Chrome/Perfetto JSON lives in ``trace_export.py``; critical-path /
straggler attribution in ``critical_path.py``.
"""

import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

# ---- process-global recorder seam (None = tracing off) ------------------

_RECORDER: Optional["FlightRecorder"] = None
_PROCESS_ROLE: Tuple[str, str] = ("process", "0")
_local = threading.local()  # .stack: [(trace_id, span_id, role, instance)]


def enabled() -> bool:
    return _RECORDER is not None


def install_recorder(rec: "FlightRecorder") -> "FlightRecorder":
    """Install (or replace) the process flight recorder; spans start
    recording on the next ``span()`` call."""
    global _RECORDER
    _RECORDER = rec
    return rec


def uninstall_recorder():
    global _RECORDER
    _RECORDER = None


def recorder() -> Optional["FlightRecorder"]:
    return _RECORDER


def recorder_spans() -> List[dict]:
    """Current ring contents, oldest first; [] when tracing is off."""
    rec = _RECORDER
    return rec.snapshot() if rec is not None else []


def spans_since(cursor: int) -> Tuple[List[dict], int]:
    """Incremental ring read for piggyback reporters: spans recorded
    after ``cursor`` plus the new cursor. ([], cursor) when off."""
    rec = _RECORDER
    if rec is None:
        return [], cursor
    return rec.since(cursor)


def set_process_role(role: str, instance: str = "0"):
    """Default (role, instance) for spans opened with no enclosing
    context — process mains set this once (master / worker / serving)."""
    global _PROCESS_ROLE
    _PROCESS_ROLE = (str(role), str(instance))


def current_ctx() -> Optional[dict]:
    """Wire form of the innermost open span, or None — what
    ``RpcStub.call`` injects as ``_trace_ctx``."""
    stack = getattr(_local, "stack", None)
    if not stack:
        return None
    trace_id, span_id, _role, _instance = stack[-1]
    return {"trace_id": trace_id, "span_id": span_id}


def current_trace_id() -> Optional[str]:
    """Trace id of the innermost open span, or None — what
    exemplar-enabled histograms stamp onto sampled observations
    (``registry.py``): two thread-local reads, cheap enough for any
    hot path."""
    stack = getattr(_local, "stack", None)
    return stack[-1][0] if stack else None


def _new_id() -> str:
    # uuid4 = urandom: identity never derives from wall-clock (chaos
    # same-seed byte-identity must survive a recorder being installed).
    return uuid.uuid4().hex[:16]


class _NullSpan:
    """Shared no-op span returned whenever no recorder is installed —
    the entire disabled-path cost of an instrumented region."""

    __slots__ = ()
    trace_id = None
    span_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def discard(self):
        return self

    def ctx(self):
        return None


NULL_SPAN = _NullSpan()


class Span:
    """One named interval; a context manager that records itself into
    the flight recorder on exit (unless ``discard()``-ed)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "role",
                 "instance", "attrs", "t0", "dur", "tid", "_recorder",
                 "_discard", "_stack")

    def __init__(self, rec: "FlightRecorder", name: str, trace_id: str,
                 parent_id: Optional[str], role: str, instance: str,
                 attrs: dict):
        self._recorder = rec
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.role = role
        self.instance = instance
        self.attrs = attrs
        self.t0 = 0.0
        self.dur = 0.0
        self.tid = 0
        self._discard = False
        self._stack = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def discard(self) -> "Span":
        """Drop this span at exit (e.g. a task-cycle that turned out to
        be a WAIT poll — recording it would pollute latency stats)."""
        self._discard = True
        return self

    def ctx(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def __enter__(self) -> "Span":
        self.t0 = time.monotonic()
        self.tid = threading.get_ident()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append((self.trace_id, self.span_id, self.role,
                      self.instance))
        # Remember WHICH stack we pushed onto: a span held open across
        # a generator yield can be finalized on a different thread
        # (GeneratorExit during GC) — exiting must remove our own entry
        # from the entering thread's stack, never blind-pop whatever is
        # innermost on the finalizing thread.
        self._stack = stack
        return self

    def __exit__(self, exc_type, exc, tb):
        self.dur = time.monotonic() - self.t0
        stack = self._stack
        if stack:
            if stack[-1][1] == self.span_id:
                stack.pop()
            else:
                for i in range(len(stack) - 1, -1, -1):
                    if stack[i][1] == self.span_id:
                        del stack[i]
                        break
        if self._discard:
            return False
        if exc_type is not None and "error" not in self.attrs:
            self.attrs["error"] = exc_type.__name__
        self._recorder.add(self.to_dict())
        return False

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "role": self.role,
            "instance": self.instance,
            "tid": int(self.tid),
            "t0": float(self.t0),
            "dur": float(self.dur),
            "attrs": self.attrs,
        }


class Tracer:
    """Span factory pinned to one (role, instance) — e.g.
    ``Tracer("worker", "3")``. Parenthood comes from the thread's
    innermost open span; a span opened with no parent starts a new
    trace."""

    __slots__ = ("role", "instance")

    def __init__(self, role: str, instance: str = "0"):
        self.role = str(role)
        self.instance = str(instance)

    def span(self, name: str, **attrs):
        rec = _RECORDER
        if rec is None:
            return NULL_SPAN
        stack = getattr(_local, "stack", None)
        if stack:
            trace_id, parent_id = stack[-1][0], stack[-1][1]
        else:
            trace_id, parent_id = _new_id(), None
        return Span(rec, name, trace_id, parent_id, self.role,
                    self.instance, attrs)


def span(name: str, **attrs):
    """Span under the ambient context: role/instance inherit from the
    enclosing span (so e.g. an RPC retry span inside a worker's task
    tree lands on the worker track), falling back to the process
    role."""
    rec = _RECORDER
    if rec is None:
        return NULL_SPAN
    stack = getattr(_local, "stack", None)
    if stack:
        trace_id, parent_id, role, instance = stack[-1]
        return Span(rec, name, trace_id, parent_id, role, instance, attrs)
    role, instance = _PROCESS_ROLE
    return Span(rec, name, _new_id(), None, role, instance, attrs)


def child_span(name: str, ctx: Optional[dict], **attrs):
    """Span with an EXPLICIT parent context — for work fanned out to a
    pool thread whose thread-local stack does not carry the caller's
    open span (the in-process analogue of ``server_span``; e.g. the
    host engine's per-table pull futures). Role/instance come from the
    calling thread's innermost span when one is open (same-thread
    callers keep their track), else the process role. ``ctx`` of None
    starts a fresh trace."""
    rec = _RECORDER
    if rec is None:
        return NULL_SPAN
    stack = getattr(_local, "stack", None)
    if stack:
        role, instance = stack[-1][2], stack[-1][3]
    else:
        role, instance = _PROCESS_ROLE
    if ctx and ctx.get("trace_id"):
        return Span(rec, name, str(ctx["trace_id"]),
                    str(ctx.get("span_id") or "") or None,
                    role, instance, attrs)
    return Span(rec, name, _new_id(), None, role, instance, attrs)


def server_span(name: str, wire_ctx: Optional[dict], role: str,
                instance: str = "0", **attrs):
    """Server-side child of a propagated ``_trace_ctx`` (or a fresh
    root when the caller sent none) — what the RPC handler wrap opens."""
    rec = _RECORDER
    if rec is None:
        return NULL_SPAN
    if wire_ctx and wire_ctx.get("trace_id"):
        return Span(rec, name, str(wire_ctx["trace_id"]),
                    str(wire_ctx.get("span_id") or "") or None,
                    role, instance, attrs)
    return Span(rec, name, _new_id(), None, role, instance, attrs)


def record_span(name: str, t0: float, dur: float, *,
                trace_id: Optional[str] = None,
                parent_id: Optional[str] = None,
                role: Optional[str] = None, instance: str = "0",
                tid: Optional[int] = None, **attrs):
    """Retro-record a span whose interval was measured elsewhere (e.g.
    serving queue-wait: enqueue happened on the handler thread, the
    wait is known only when the batcher pops the request)."""
    rec = _RECORDER
    if rec is None:
        return None
    if role is None:
        role = _PROCESS_ROLE[0]
    entry = {
        "name": name,
        "trace_id": trace_id or _new_id(),
        "span_id": _new_id(),
        "parent_id": parent_id,
        "role": str(role),
        "instance": str(instance),
        "tid": int(tid if tid is not None else threading.get_ident()),
        "t0": float(t0),
        "dur": float(dur),
        "attrs": attrs,
    }
    rec.add(entry)
    return entry


class FlightRecorder:
    """Bounded ring of finished spans (oldest evicted first) with a
    monotonic sequence number for incremental piggyback reads."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring = deque(maxlen=self.capacity)
        self._seq = 0

    def add(self, span_dict: dict):
        with self._lock:
            self._seq += 1
            span_dict["seq"] = self._seq
            self._ring.append(span_dict)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def since(self, cursor: int) -> Tuple[List[dict], int]:
        """Spans with seq > cursor (bounded by what the ring still
        holds) and the new cursor."""
        with self._lock:
            return (
                [s for s in self._ring if s.get("seq", 0) > cursor],
                self._seq,
            )

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


class TraceCollector:
    """Master-side span accumulator: ingests piggybacked span batches,
    dedups by span id (in-process workers share one recorder, so the
    same span can arrive on two reporters' cursors), bounded FIFO."""

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._spans: "OrderedDict[str, dict]" = OrderedDict()

    def ingest(self, spans) -> int:
        if not spans:
            return 0
        added = 0
        with self._lock:
            for entry in spans:
                if not isinstance(entry, dict):
                    continue
                sid = entry.get("span_id")
                if not sid or sid in self._spans:
                    continue
                self._spans[sid] = entry
                added += 1
            while len(self._spans) > self.capacity:
                self._spans.popitem(last=False)
        return added

    def spans(self) -> List[dict]:
        with self._lock:
            return list(self._spans.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)
