"""Msgpack-over-gRPC control-plane RPC.

The reference ships protobuf messages over gRPC (elasticdl.proto Master /
Pserver services). This framework's control messages (tasks, versions,
metrics) are tiny dicts, so instead of generated proto classes it uses
gRPC's generic handler API with the framework's msgpack serde
(common/tensor_utils.py) — same wire substrate, no codegen step, and
ndarrays (eval raw outputs) ride the same encoding as checkpoints.

Server: ``RpcServer(addr, {service_name: {method: handler}})``.
Client: ``RpcStub(addr, service_name).call(method, **fields)``.
Handlers take and return plain dicts. Errors raise ``RpcError`` client-side.

Transient transport failures (UNAVAILABLE / DEADLINE_EXCEEDED) retry
inside ``RpcStub.call`` with jittered exponential backoff and a small
attempt cap, counted by ``edl_tpu_rpc_retries_total`` — a server
restart blip must not surface as a hard job failure. Layers with their
own (longer) retry budget, e.g. the row-service client riding out a
pod relaunch, construct stubs with ``max_retries=0``.

Chaos seam: ``set_chaos_hooks`` installs client/server interceptors
(``chaos/interceptors.py``) that can delay, drop, or error any call on
a scripted schedule; ``None`` hooks (the default) cost one attribute
read per call.

Tracing seam (``observability/tracing.py``, same cost discipline):
when a flight recorder is installed, ``RpcStub.call`` opens a client
span per call, injects its context as a ``_trace_ctx`` request field,
and records a span per backoff sleep (so retries are visible as their
own intervals); the server handler wrap pops ``_trace_ctx`` and opens
the server span as its child. With no recorder installed the whole
machinery is one module-global ``None`` check.

Attribution seam (``observability/principal.py`` + ``usage.py``):
the ambient workload principal rides each request as a ``_principal``
field next to ``_trace_ctx``; the server wrap strips it, re-establishes
it as the handler's ambient principal, tags it onto the server span,
and meters the request per principal (``edl_tpu_usage_*``). Unlike
tracing this is always-on; ``principal.set_enabled(False)`` disables
both halves.

Client-side latency telemetry: ``edl_tpu_rpc_client_seconds`` (one
histogram observation per send *attempt*, labeled service/method) and
``edl_tpu_rpc_inflight`` (gauge) — attempt-scoped on purpose, so a
call that spent 3s in backoff sleeps and 2ms on the wire reads as
retries + fast attempts, not as a slow server.

Overload plane (``comm/deadline.py`` + ``comm/overload.py``,
docs/fault_tolerance.md "Graceful degradation"):

- **Deadline propagation** — the ambient deadline rides each request
  as a ``_deadline`` field (absolute wall-clock seconds) next to
  ``_trace_ctx``/``_principal``; the client derives each hop's gRPC
  timeout from the remaining budget, refuses to send (and to retry)
  once the budget is spent, and the server wrap re-establishes the
  wire deadline as the handler's ambient scope — then rejects
  already-EXPIRED work with a non-retryable DEADLINE_EXCEEDED before
  the handler runs (and therefore before any service lock).
- **Priority admission** — ``RpcServer(..., admission=...)`` installs
  an ``overload.AdmissionController`` in front of every handler:
  requests classify by the piggybacked principal's purpose, and a
  saturated server sheds lowest-priority-first with a retryable
  RESOURCE_EXHAUSTED carrying a retry-after hint in the detail.
- **Retry budget** — a stub with ``max_retries > 0`` spends one token
  of the process-wide per-service ``overload.RetryBudget`` per retry;
  an empty bucket ends the retry loop (metered as
  ``rpc_retry_budget_exhausted_total``). Shed responses honor the
  server's retry-after hint instead of the exponential schedule.
- **Circuit breaker** — per-target ``overload.CircuitBreaker``: after
  consecutive transport (UNAVAILABLE) failures the stub fails fast
  without touching the wire until a jittered half-open probe
  succeeds.

A copy of elasticdl_tpu/comm/rpc.py: the same wire fields, status
codes, retry and backoff rules, circuit breaker and chaos hooks. One
difference: ``grpc`` is imported only by what touches the wire
(``RpcServer``, ``build_channel``, ``RpcStub``'s calls,
``wait_for_channel_ready`` and the handler class, which is built in a
function), so ``RpcError``, ``InvalidRequest``, ``RETRYABLE_CODES`` and
``decorrelated_jitter`` import on a host without ``grpcio``, where the
in-process master still runs.
"""

import random as _random
import threading
import time
from concurrent import futures
from typing import Callable, Dict, Optional

from elasticdl_tpu_torch.comm import deadline as _deadline
from elasticdl_tpu_torch.comm import overload as _overload
from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.common.constants import GRPC
from elasticdl_tpu_torch.observability import principal as _principal
from elasticdl_tpu_torch.observability import tracing as _tracing
from elasticdl_tpu_torch.observability import usage as _usage

_CHANNEL_OPTIONS = [
    ("grpc.max_send_message_length", GRPC.MAX_SEND_MESSAGE_LENGTH),
    ("grpc.max_receive_message_length", GRPC.MAX_RECEIVE_MESSAGE_LENGTH),
    # Without a local pool, grpc shares subchannels across channels to
    # the same target: a "fresh" channel built by RpcStub.reconnect()
    # silently reuses the old refused subchannel still sitting in
    # connect-backoff, so reconnect() cannot actually un-wedge a stub
    # — the one job it exists to do. Costs one TCP connection per
    # channel instead of per (process, target); stubs here are
    # long-lived and registry-shared, so that is noise.
    ("grpc.use_local_subchannel_pool", 1),
]

# Codes worth a client-side retry: the transport (not the handler)
# failed, and every control RPC here is safe to re-send — get_task
# re-asks the dispatcher, reports are idempotent per task id at the
# servicer, row pushes dedup by (client, seq). RESOURCE_EXHAUSTED is
# an admission shed: explicitly retryable (the server said "later",
# with a retry-after hint in the detail), subject to the retry budget
# like every other retry. A DEADLINE_EXCEEDED is retryable only while
# the AMBIENT deadline (if any) still has budget — see call().
RETRYABLE_CODES = ("UNAVAILABLE", "DEADLINE_EXCEEDED",
                   "RESOURCE_EXHAUSTED")

# Detail marker for the server-side expired-on-arrival rejection:
# clients must NOT retry it (resending work whose deadline passed can
# only waste server capacity), even though the code itself is
# transient for the transport-timeout case.
EXPIRED_DETAIL = "deadline expired before handling"


class RpcError(RuntimeError):
    """Client-side RPC failure; ``code`` is the grpc StatusCode name
    (e.g. "UNAVAILABLE") so callers can distinguish transient transport
    failures from permanent handler errors."""

    def __init__(self, message: str, code: str = "UNKNOWN"):
        super().__init__(message)
        self.code = code


class InvalidRequest(ValueError):
    """Handler-side request validation failure: the payload itself is
    malformed (wrong shape, wrong dtype, unknown table). Surfaces to
    the client as INVALID_ARGUMENT — non-retryable, distinct from the
    INTERNAL a handler *bug* produces — so e.g. a push whose gradient
    block disagrees with the table's dim is rejected cleanly before it
    can reach the native apply kernels (which would trust the shape
    and read out of bounds)."""


# ---- chaos injection seam (chaos/interceptors.py installs) -------------
#
# _client_hook(service, method, request) -> None
#   runs in RpcStub.call before each send attempt; may sleep (delay
#   fault) or raise (RpcError for drop faults — retried like a real
#   transport failure — or chaos.ChaosKill to simulate pod death).
# _server_hook(tag, service, method, request) -> None | (code, detail)
#   runs in the handler wrap; may sleep; a returned (code, detail)
#   aborts the call with that grpc status.

_client_hook: Optional[Callable] = None
_server_hook: Optional[Callable] = None


def set_chaos_hooks(client: Optional[Callable] = None,
                    server: Optional[Callable] = None):
    """Install (or, with Nones, remove) the chaos interceptors."""
    global _client_hook, _server_hook
    _client_hook = client
    _server_hook = server


def _serialize(obj: dict) -> bytes:
    return tensor_utils.dumps(obj)


def _deserialize(data: bytes) -> dict:
    return tensor_utils.loads(data)


# Trace track per service: server spans land on the role's Perfetto
# process row. Unknown services trace under their own name.
_SERVICE_ROLES = {
    "elasticdl_tpu.Master": "master",
    "RowService": "rowservice",
}


def _server_trace_identity(service_name: str, tag: str):
    role = _SERVICE_ROLES.get(service_name, service_name)
    # Tags look like "rowservice/1": the part after the slash is the
    # shard/instance; a bare tag (or none) is instance 0.
    instance = tag.rsplit("/", 1)[-1] if tag else "0"
    return role, instance or "0"


def _generic_service(service_name: str, handlers: Dict[str, Callable],
                     tag: str = "", admission=None):
    """The grpc handler of one service (its class is built here, so
    that importing this module needs no grpc)."""
    import grpc

    class _GenericService(grpc.GenericRpcHandler):
        def __init__(self, service_name: str, handlers: Dict[str, Callable],
                     tag: str = "", admission=None):
            self._service_name = service_name
            self._handlers = handlers
            # Chaos identity: several servers of the SAME service can run in
            # one process (e.g. N row-service shards in tests); the tag lets
            # a fault plan target one of them ("rowservice/1").
            self._tag = tag
            # Priority admission gate (overload.AdmissionController or
            # None): consulted before ANY per-request work — a shed must
            # cost the saturated server one counter bump and an abort,
            # nothing more.
            self._admission = admission

        def service(self, handler_call_details):
            # Path format: /<service_name>/<method>
            parts = handler_call_details.method.lstrip("/").split("/")
            if len(parts) != 2 or parts[0] != self._service_name:
                return None
            method = parts[1]
            handler = self._handlers.get(method)
            if handler is None:
                return None

            def unary_unary(request: dict, context):
                # Always strip the piggyback fields (handlers must never
                # see them as payload): the trace context, the workload
                # principal riding next to it, and the propagated absolute
                # deadline. The principal becomes the handler's ambient
                # attribution identity (so internal fan-outs it triggers
                # self-tag) and the usage meter's label source; a request
                # carrying neither meters as ``unknown``. The deadline
                # becomes the handler's ambient deadline scope, so
                # internal fan-outs inherit the caller's remaining budget.
                if isinstance(request, dict):
                    wire_ctx = request.pop("_trace_ctx", None)
                    who = _principal.from_wire(
                        request.pop("_principal", None)
                    )
                    wire_deadline = request.pop("_deadline", None)
                else:
                    wire_ctx = None
                    who = None
                    wire_deadline = None
                if wire_deadline is not None:
                    try:
                        wire_deadline = float(wire_deadline)
                    except (TypeError, ValueError):
                        wire_deadline = None
                # Priority admission: classify by the principal's purpose
                # and shed BEFORE opening spans or touching the handler
                # (and therefore before any service lock). The shed is a
                # retryable RESOURCE_EXHAUSTED with a retry-after hint in
                # the detail; the admitted slot is released in the finally
                # below.
                admission = self._admission
                if admission is not None:
                    purpose = who.purpose if who is not None else None
                    if not admission.try_acquire(purpose):
                        code, detail = admission.shed_verdict(purpose)
                        context.abort(
                            getattr(grpc.StatusCode, code), detail
                        )
                metered = _principal.enabled()
                if _tracing.enabled():
                    role, instance = _server_trace_identity(
                        self._service_name, self._tag
                    )
                    span = _tracing.server_span(
                        f"serve/{method}", wire_ctx, role, instance,
                        service=self._service_name,
                        **_principal.span_attrs(who),
                    )
                else:
                    span = _tracing.NULL_SPAN
                handle_t0 = time.monotonic()
                try:
                    with span, _principal.pushed(
                        principal=who or _principal.NOBODY
                    ), _deadline.running_at(wire_deadline):
                        hook = _server_hook
                        if hook is not None:
                            verdict = hook(
                                self._tag, self._service_name, method,
                                request
                            )
                            if verdict is not None:
                                code, detail = verdict
                                span.set(error=code)
                                context.abort(
                                    getattr(grpc.StatusCode, code,
                                            grpc.StatusCode.UNKNOWN),
                                    detail,
                                )
                        # Expired-on-arrival rejection — AFTER the chaos
                        # hook (an injected server-site delay models queue
                        # time and must count against the budget), BEFORE
                        # the handler (work nobody is waiting for must not
                        # queue for the service lock). Non-retryable by
                        # detail contract: see EXPIRED_DETAIL.
                        if _deadline.expired():
                            span.set(error="DEADLINE_EXCEEDED")
                            context.abort(
                                grpc.StatusCode.DEADLINE_EXCEEDED,
                                f"{EXPIRED_DETAIL}: "
                                f"{self._service_name}.{method} arrived "
                                "with no budget left",
                            )
                        try:
                            response = handler(request)
                            return response if response is not None else {}
                        except InvalidRequest as exc:
                            # Malformed payload, not a server fault:
                            # reject with the argument-validation status
                            # so clients neither retry it nor read it as
                            # a handler bug.
                            span.set(error="INVALID_ARGUMENT")
                            context.abort(
                                grpc.StatusCode.INVALID_ARGUMENT, str(exc)
                            )
                        except Exception as exc:
                            # surface handler errors to the client
                            context.abort(
                                grpc.StatusCode.INTERNAL,
                                f"{type(exc).__name__}: {exc}",
                            )
                finally:
                    if admission is not None:
                        admission.release()
                    if metered:
                        # Qualified Service.method: bare method names
                        # collide across services in the shared families.
                        _usage.meter_request(
                            who, f"{self._service_name}.{method}",
                            time.monotonic() - handle_t0,
                        )

            return grpc.unary_unary_rpc_method_handler(
                unary_unary,
                request_deserializer=_deserialize,
                response_serializer=_serialize,
            )

    return _GenericService(service_name, handlers, tag=tag,
                           admission=admission)


class RpcServer:
    def __init__(
        self,
        addr: str,
        services: Dict[str, Dict[str, Callable]],
        max_workers: int = 64,
        tag: str = "",
        admission=None,
    ):
        """``services`` maps service name -> {method name -> handler}.
        ``tag`` identifies this server instance to chaos fault plans.
        ``admission`` (an ``overload.AdmissionController``) gates every
        handler of every service on this server by principal purpose —
        one shared gate per server, because the thing being protected
        (the worker pool, the service lock) is per-server."""
        import grpc

        self.admission = admission
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            handlers=[
                _generic_service(name, handlers, tag=tag,
                                 admission=admission)
                for name, handlers in services.items()
            ],
            options=_CHANNEL_OPTIONS,
        )
        self.port = self._server.add_insecure_port(addr)
        if self.port == 0:
            raise RuntimeError(f"Could not bind RPC server to {addr}")

    def start(self):
        self._server.start()
        return self

    def stop(self, grace: Optional[float] = None):
        """Returns grpc's termination event — set once in-flight
        handlers have fully drained/cancelled, so callers can fence
        teardown of resources those handlers still use."""
        return self._server.stop(grace)

    def wait(self):
        self._server.wait_for_termination()


def build_channel(addr: str):
    import grpc

    return grpc.insecure_channel(addr, options=_CHANNEL_OPTIONS)


def decorrelated_jitter(prev: float, base: float = 0.05,
                        cap: float = 2.0, rand=None) -> float:
    """Next reconnect/retry delay, AWS-style decorrelated jitter:
    ``min(cap, uniform(base, prev * 3))``. Unlike fixed or plainly
    exponential backoff, two clients that failed at the same instant
    (a master failover fails the WHOLE fleet at once) decorrelate
    within a round or two instead of hammering the new server in
    lockstep forever — the thundering-herd fix the failover drill
    leans on. ``prev <= 0`` (first failure) returns ``base`` so the
    first retry stays fast."""
    if prev <= 0.0:
        return float(base)
    rand = rand if rand is not None else _random.random
    lo, hi = float(base), max(float(base), prev * 3.0)
    return min(float(cap), lo + (hi - lo) * rand())


def _retry_counter():
    from elasticdl_tpu_torch.observability import default_registry

    return default_registry().counter(
        "rpc_retries_total",
        "Transient RPC failures retried by RpcStub.call",
        ["service", "method", "code"],
    )


def _client_metrics():
    """(latency histogram, in-flight gauge) for RpcStub.call. Fetched
    per call (like _retry_counter) so a test's registry reset can't
    leave a stale family behind; the registry lookup is a dict hit."""
    from elasticdl_tpu_torch.observability import default_registry

    registry = default_registry()
    return (
        registry.histogram(
            "rpc_client_seconds",
            "RPC client send-attempt latency (per attempt: excludes "
            "backoff sleeps, so retried calls read as N fast attempts "
            "rather than one slow server)",
            ["service", "method"],
            # Observations happen inside the rpc/<method> span, so the
            # ambient trace id stamps each sampled slow attempt — the
            # burn-rate rule's exemplar source (docs/observability.md).
            exemplars=True,
        ),
        registry.gauge(
            "rpc_inflight",
            "RPC send attempts currently in flight",
            ["service", "method"],
        ),
    )


class RpcStub:
    """Client for one service on one channel; thread-safe.

    ``max_retries`` re-send attempts on RETRYABLE_CODES with jittered
    exponential backoff (base doubling to cap, ×[0.5, 1.5) jitter so a
    worker fleet doesn't retry in lockstep). 0 disables — callers with
    their own retry policy (row_service._call_with_retry) must not
    multiply budgets."""

    def __init__(self, target, service_name: str, max_retries: int = 2,
                 backoff_base: float = 0.05, backoff_cap: float = 2.0):
        if isinstance(target, str):
            # Re-resolve list: a comma-separated target names every
            # address the service may answer on (e.g. a primary
            # master and its hot standbys). Calls go to ONE address;
            # reconnect() rotates to the next — the client-side half
            # of master failover (docs/fault_tolerance.md "Hot
            # standby & failover").
            self._targets = [
                a.strip() for a in target.split(",") if a.strip()
            ]
            if not self._targets:
                raise ValueError(f"empty RPC target {target!r}")
            self._target_idx = 0
            self._target = self._targets[0]
            self._channel = build_channel(self._target)
            self._owns_channel = True
        else:
            self._targets = []
            self._target_idx = 0
            self._target = None
            self._channel = target
            self._owns_channel = False
        self._service_name = service_name
        self._max_retries = int(max_retries)
        self._backoff_base = float(backoff_base)
        self._backoff_cap = float(backoff_cap)
        self._methods = {}
        # method -> (latency series, inflight series): labels are fixed
        # for a stub's lifetime, so resolve the registry families and
        # label tuples once instead of on every hot-path call. Keyed to
        # the registry generation so a test's registry.reset() doesn't
        # leave the stub observing into detached series forever.
        self._method_metrics = {}
        self._metrics_generation = -1
        self._lock = threading.Lock()

    def _method(self, name: str):
        with self._lock:
            if name not in self._methods:
                self._methods[name] = self._channel.unary_unary(
                    f"/{self._service_name}/{name}",
                    request_serializer=_serialize,
                    response_deserializer=_deserialize,
                )
            return self._methods[name]

    def reconnect(self):
        """Drop the channel and build a fresh one — the same remedy
        MasterClient.reconnect applies on the worker's master
        ride-out: a gRPC channel whose connection attempts were
        REFUSED for a few seconds (server not up yet, or relaunching)
        can wedge its subchannel permanently, while a fresh channel to
        the now-listening server connects immediately. With a
        multi-address target the rebuild also ROTATES to the next
        address (re-resolve): after a master failover the old address
        refuses forever while a standby answers on the next one. Long
        external retry loops (row_service._call_with_retry) call this
        between attempts. No-op for stubs wrapping a caller-owned
        channel."""
        if not self._owns_channel or self._target is None:
            return
        with self._lock:
            try:
                self._channel.close()
            except Exception:  # a half-dead channel must not block retry
                pass
            if len(self._targets) > 1:
                self._target_idx = (
                    (self._target_idx + 1) % len(self._targets)
                )
                self._target = self._targets[self._target_idx]
            self._channel = build_channel(self._target)
            self._methods = {}

    @property
    def target(self) -> Optional[str]:
        """The address calls currently go to (telemetry/tests)."""
        return self._target

    def _metrics_for(self, method: str):
        from elasticdl_tpu_torch.observability import default_registry

        generation = default_registry().generation
        if generation != self._metrics_generation:
            with self._lock:
                self._method_metrics = {}
                self._metrics_generation = generation
        series = self._method_metrics.get(method)
        if series is None:
            latency, inflight = _client_metrics()
            series = (
                latency.labels(self._service_name, method),
                inflight.labels(self._service_name, method),
            )
            with self._lock:
                self._method_metrics[method] = series
        return series

    def call(self, method: str, timeout: Optional[float] = None, **fields):
        import grpc

        traced = _tracing.enabled()
        if traced:
            call_span = _tracing.span(
                f"rpc/{method}", service=self._service_name
            )
        else:
            call_span = _tracing.NULL_SPAN
        m_latency, m_inflight = self._metrics_for(method)
        with call_span:
            if traced:
                ctx = call_span.ctx()
                if ctx is not None:
                    # Propagated next to the payload; the server wrap
                    # strips it before the handler runs.
                    fields["_trace_ctx"] = ctx
            # Workload principal rides next to the trace context but
            # independently of it — attribution is always-on metering,
            # not sampling (None when nothing is ambient or the
            # attribution kill-switch is off).
            who = _principal.current_wire()
            if who is not None:
                fields["_principal"] = who
            # Ambient deadline: stamped on the wire as an absolute
            # instant, and the source of each attempt's per-hop gRPC
            # timeout — a multi-hop fan-out under one budget spends
            # ONE budget, not one per hop.
            ambient_deadline = _deadline.wire()
            if ambient_deadline is not None:
                fields["_deadline"] = ambient_deadline
            # Per-target circuit breaker (skipped for caller-owned
            # channels — the stub cannot name the endpoint — and while
            # the overload kill-switch is off).
            breaker = None
            if (self._target is not None
                    and _overload.controls_enabled()):
                breaker = _overload.breaker_for(self._target)
            budget = None
            delay = self._backoff_base
            attempt = 0
            while True:
                if _deadline.expired():
                    # The caller's budget is spent: sending (or
                    # re-sending) is wasted server capacity.
                    err = RpcError(
                        f"{self._service_name}.{method} not sent: "
                        "ambient deadline expired",
                        code="DEADLINE_EXCEEDED",
                    )
                    if traced:
                        call_span.set(error=err.code,
                                      attempts=attempt)
                    raise err
                breaker_open = breaker is not None and not breaker.allow()
                attempt_t0 = time.monotonic()
                m_inflight.inc()
                try:
                    try:
                        if breaker_open:
                            raise RpcError(
                                f"{self._service_name}.{method} not "
                                f"sent: breaker open for "
                                f"{self._target}",
                                code="UNAVAILABLE",
                            )
                        hook = _client_hook
                        if hook is not None:
                            # May raise RpcError (injected drop —
                            # retried below like a real one) or
                            # ChaosKill (BaseException: simulated pod
                            # death, never caught here).
                            hook(self._service_name, method, fields)
                        result = self._method(method)(
                            fields,
                            timeout=_deadline.hop_timeout(timeout),
                        )
                        m_latency.observe(
                            time.monotonic() - attempt_t0
                        )
                        if breaker is not None:
                            breaker.on_success()
                        if budget is not None:
                            budget.on_success()
                        return result
                    except grpc.RpcError as exc:
                        err = RpcError(
                            f"{self._service_name}.{method} failed: "
                            f"{exc.code().name}: {exc.details()}",
                            code=exc.code().name,
                        )
                        err.__cause__ = exc
                    except RpcError as exc:
                        err = exc
                    m_latency.observe(time.monotonic() - attempt_t0)
                finally:
                    m_inflight.dec()
                # Only a dead TRANSPORT trips the breaker: sheds and
                # deadline misses are a live server deciding, and a
                # breaker-open synthetic must not feed back into
                # itself.
                if (breaker is not None and not breaker_open
                        and err.code == "UNAVAILABLE"):
                    breaker.on_failure()
                retryable = (err.code in RETRYABLE_CODES
                             and EXPIRED_DETAIL not in str(err)
                             and not _deadline.expired())
                if not retryable or attempt >= self._max_retries:
                    if traced:
                        call_span.set(error=err.code, attempts=attempt + 1)
                    raise err
                # Retries spend the process-wide per-service budget —
                # the retry-storm amplification cap. An empty bucket
                # ends the loop with the LAST real error.
                if budget is None and _overload.controls_enabled():
                    budget = _overload.retry_budget_for(
                        self._service_name
                    )
                if budget is not None and not budget.try_spend():
                    if traced:
                        call_span.set(error=err.code,
                                      attempts=attempt + 1,
                                      budget_exhausted=True)
                    raise err
                attempt += 1
                _retry_counter().labels(
                    self._service_name, method, err.code
                ).inc()
                # A shed carries the server's retry-after hint; honor
                # it (jittered) instead of the exponential schedule —
                # the server knows its own drain rate. Either way the
                # sleep never overshoots the ambient deadline.
                hint = None
                if err.code == "RESOURCE_EXHAUSTED":
                    hint = _overload.parse_retry_after(str(err))
                sleep_for = (hint if hint is not None else delay) * (
                    0.5 + _random.random()
                )
                left = _deadline.remaining()
                if left is not None:
                    sleep_for = min(sleep_for, max(0.0, left))
                # The backoff sleep is its own span so a retried call
                # reads as [attempt][backoff][attempt], not one opaque
                # interval (and server time stays distinguishable from
                # client-side waiting).
                with _tracing.span(
                    "rpc.backoff", code=err.code, attempt=attempt
                ) if traced else _tracing.NULL_SPAN:
                    time.sleep(sleep_for)
                if hint is None:
                    delay = min(delay * 2.0, self._backoff_cap)

    def close(self):
        if self._owns_channel:
            self._channel.close()


def wait_for_channel_ready(addr: str, timeout: float = 300.0,
                           retries: int = 3):
    """Block until the server is reachable (reference worker/main.py:8-59
    connects master with 3×300s retries)."""
    import grpc

    last_exc = None
    for _ in range(retries):
        channel = build_channel(addr)
        try:
            grpc.channel_ready_future(channel).result(timeout=timeout)
            return channel
        except grpc.FutureTimeoutError as exc:
            last_exc = exc
            channel.close()
    raise TimeoutError(f"Channel to {addr} not ready: {last_exc}")
