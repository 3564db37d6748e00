"""Online inference server: adaptive micro-batching over a bundle (port of
elasticdl_tpu/serving/server.py).

Request handler threads enqueue; one batcher thread drains, so the
model sees one predict at a time.

- **Transport**: stdlib ``ThreadingHTTPServer``. ``POST /v1/predict``
  takes msgpack (``application/x-msgpack``, the same ndarray wire
  format as the JAX server) or JSON (lists, coerced to the bundle's
  recorded feature signature). ``GET /v1/models`` lists resident
  versions, ``POST /v1/models/rollback`` swaps back one version,
  ``GET /healthz`` says whether a model is loaded.
- **Adaptive micro-batching**: requests accumulate until
  ``max_batch_size`` examples wait or the oldest has waited
  ``batch_deadline_ms``.
- **Bucketed shapes**: the combined batch pads to a power-of-two
  bucket (clamped to ``max_batch_size``) by repeating row 0.
- **Tiered backpressure**: the bounded queue sheds with 429 and a
  ``Retry-After``, cheapest traffic first: hedged attempts
  (``X-Hedge: 1``, a router's speculative second try) past
  ``hedge_shed_frac`` of the queue, ``X-Priority: low`` past
  ``low_shed_frac``, everything at a full queue or while draining or
  stopped. The 429 carries its tier in ``X-Shed-Tier``.
- **Stop**: ``InferenceServer.stop()`` tears down as a dead process
  would: it closes the listener and cuts the open connections, and
  requests still queued answer 429 (tier ``draining``). ``drain()`` is
  the graceful SIGTERM path.
- **Telemetry**: the ``serving_*`` families on ``GET /metrics`` (the
  process registry, Prometheus text); with a flight recorder installed
  (``--flight_recorder N``) the ``request``, ``queue_wait``,
  ``batch_assembly`` and ``predict`` spans on ``GET /traces``.

Not ported yet (ROADMAP Queue 1, item 8): the master telemetry reporter
(``--master_addr``, ``--metrics_report_secs``) and the sampling profiler
(``--profile_hz``, ``--profile_window_secs``), and ``--replica_id``,
which only those two read; each flag raises when set.
"""

import collections
import json
import socket
import sys
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.observability import (
    default_registry,
    render_prometheus,
    tracing,
)

logger = get_logger("serving")

MSGPACK_CONTENT_TYPE = "application/x-msgpack"

# Batch-occupancy buckets: powers of two up to the largest batch any
# config uses (the registry's default buckets are latency-shaped).
_BATCH_BUCKETS = tuple(float(2 ** i) for i in range(13))

_ITEM_8 = "is not ported yet (ROADMAP Queue 1, item 8)"


def not_ported_flags(id_flag: str) -> dict:
    """Flags of JAX code that is not ported, each of which raises when
    set: the reporter's and the profiler's, and the process's id
    (``replica_id`` or ``router_id``), which only those two read."""
    return {
        "master_addr": "the metrics reporter to the master",
        "metrics_report_secs": "the metrics reporter to the master",
        "profile_hz": "the sampling profiler",
        "profile_window_secs": "the sampling profiler",
        id_flag: "the process id the reporter and the profiler read",
    }


def add_not_ported_flags(parser, flags: dict):
    for flag, what in flags.items():
        parser.add_argument(f"--{flag}", default=None,
                            help=f"Not ported yet (ROADMAP Queue 1, "
                                 f"item 8): {what}")


def raise_on_not_ported_flags(args, flags: dict):
    for flag, what in flags.items():
        if getattr(args, flag) is not None:
            raise NotImplementedError(f"--{flag}: {what} {_ITEM_8}")


# ---- trees: dicts / lists / tuples of arrays --------------------------

def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _tree_leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _tree_structure(tree):
    if isinstance(tree, dict):
        return ("dict", tuple(sorted(
            (k, _tree_structure(v)) for k, v in tree.items()
        )))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,
                tuple(_tree_structure(v) for v in tree))
    return None


def _batch_dim(features) -> int:
    leaves = _tree_leaves(features)
    if not leaves or np.ndim(leaves[0]) == 0:
        raise ValueError("features must carry a leading batch dim")
    n = int(np.shape(leaves[0])[0])
    for leaf in leaves:
        if np.ndim(leaf) == 0 or int(np.shape(leaf)[0]) != n:
            raise ValueError(
                "all feature leaves must share the leading batch dim"
            )
    return n


def _concat_trees(trees):
    return _tree_map(
        lambda *xs: np.concatenate([np.asarray(x) for x in xs], axis=0),
        *trees,
    )


def _pad_tree(features, target: int, n: int):
    """Pad the batch dim from ``n`` to ``target`` by repeating row 0."""
    if target == n:
        return features

    def pad(x):
        x = np.asarray(x)
        reps = np.repeat(x[:1], target - n, axis=0)
        return np.concatenate([x, reps], axis=0)

    return _tree_map(pad, features)


def _slice_tree(outputs, lo: int, hi: int):
    return _tree_map(lambda x: np.asarray(x)[lo:hi], outputs)


def _coerce_signature(features, signature):
    """Cast a payload onto the bundle's recorded dtypes: JSON arrives as
    nested lists, and a msgpack client's stray int64 leaf must not widen
    the batch. Dicts recurse key by key; anything else is one array."""
    if isinstance(features, dict):
        return {
            k: _coerce_signature(
                v, None if signature is None else signature[k]
            )
            for k, v in features.items()
        }
    arr = np.asarray(features)
    if isinstance(signature, dict) and "dtype" in signature:
        arr = arr.astype(signature["dtype"])
    return arr


class _Request:
    __slots__ = ("features", "n", "event", "outputs", "error",
                 "version", "enqueued_at", "cancelled", "trace_ctx")

    def __init__(self, features, n: int):
        self.features = features
        self.n = n
        self.event = threading.Event()
        self.outputs = None
        self.error: Optional[Exception] = None
        self.version = 0
        self.enqueued_at = time.monotonic()
        # Set when the submitting handler gave up (timeout): the batcher
        # drops it instead of computing dead work.
        self.cancelled = False
        # (trace_id, span_id) of the handler's request span when tracing
        # is on: the batcher retro-records queue-wait and batch spans
        # against it.
        self.trace_ctx = None


class BatchingPredictor:
    """The queue + batcher half of the server. ``submit`` blocks the
    calling handler thread until its slice of a flushed batch returns;
    ``QueueFullError`` is the load-shed signal (HTTP 429).

    ``batch_occupancy`` counts flushed batches by each real example
    count (before padding), which the ``serving_batch_occupancy``
    histogram's power-of-two buckets cannot tell apart."""

    class QueueFullError(RuntimeError):
        """Load-shed signal (HTTP 429): ``retry_after`` is the suggested
        backoff in seconds, ``tier`` the shed tier that fired."""

        def __init__(self, message: str, tier: str = "capacity",
                     retry_after: float = 1.0):
            super().__init__(message)
            self.tier = tier
            self.retry_after = float(retry_after)

    def __init__(self, store, max_batch_size: int = 64,
                 batch_deadline_ms: float = 5.0, max_queue: int = 256,
                 hedge_shed_frac: float = 0.5,
                 low_shed_frac: float = 0.75,
                 metrics_registry=None):
        self._store = store
        self._tracer = tracing.Tracer("serving")
        self.max_batch_size = int(max_batch_size)
        self.batch_deadline = float(batch_deadline_ms) / 1e3
        self.max_queue = int(max_queue)
        # Shed tiers, fractions of max_queue: hedged attempts first (the
        # primary is in flight elsewhere), then low priority, then, at a
        # full queue, everything.
        self.hedge_shed_frac = float(hedge_shed_frac)
        self.low_shed_frac = float(low_shed_frac)
        self._queue: List[_Request] = []
        self._cond = threading.Condition()
        self._stop = False
        # Draining (SIGTERM grace): new submits are refused with
        # QueueFullError while queued work keeps flushing. _busy marks a
        # popped batch still inside model.predict.
        self._draining = False
        self._busy = False
        self._thread: Optional[threading.Thread] = None
        self.batch_occupancy = collections.Counter()

        registry = metrics_registry or default_registry()
        self._m_requests = registry.counter(
            "serving_requests_total", "Predict requests by HTTP status code",
            labelnames=("code",),
        )
        self._m_latency = registry.histogram(
            "serving_request_seconds",
            "End-to-end predict latency (enqueue to reply)",
            exemplars=True,
        )
        self._m_batch_seconds = registry.histogram(
            "serving_batch_seconds", "Predict-call latency per flushed batch",
        )
        self._m_batch_size = registry.histogram(
            "serving_batch_occupancy",
            "Real examples per flushed batch (pre-padding)",
            buckets=_BATCH_BUCKETS,
        )
        self._m_flushes = registry.counter(
            "serving_batch_flushes_total", "Batch flushes by trigger",
            labelnames=("reason",),
        )
        self._m_shed = registry.counter(
            "serving_load_shed_total",
            "Requests shed with 429, by tier (hedge < low < capacity)",
            labelnames=("tier",),
        )
        self._m_padded = registry.counter(
            "serving_padded_examples_total",
            "Padding examples added to reach the shape bucket",
        )
        self._m_errors = registry.counter(
            "serving_batch_errors_total", "Batches whose predict call raised",
        )
        # A weak reference: the registry outlives predictors, and a
        # strong closure would pin every resident model's weights.
        self_ref = weakref.ref(self)
        registry.gauge(
            "serving_queue_depth", "Requests waiting for a batch slot",
        ).set_function(
            lambda: float(len(self_ref()._queue)) if self_ref() else 0.0
        )

    # ---- client side ---------------------------------------------------

    def _shed_locked(self, priority: str, hedge: bool):
        """Raise QueueFullError when the queue's depth crosses the tier
        this request belongs to. Called under ``_cond``."""
        depth = len(self._queue)
        if self._draining or self._stop:
            raise self.QueueFullError("server draining or stopped",
                                      tier="draining", retry_after=2.0)
        if depth >= self.max_queue:
            raise self.QueueFullError(
                f"queue full ({self.max_queue} requests waiting)",
                tier="capacity", retry_after=2.0,
            )
        if hedge and depth >= self.hedge_shed_frac * self.max_queue:
            raise self.QueueFullError(
                f"hedge shed at queue depth {depth}", tier="hedge",
                retry_after=1.0,
            )
        if priority == "low" and depth >= self.low_shed_frac * self.max_queue:
            raise self.QueueFullError(
                f"low-priority shed at queue depth {depth}", tier="low",
                retry_after=1.0,
            )

    def submit(self, features, timeout: float = 30.0,
               priority: str = "normal", hedge: bool = False):
        """Enqueue one request; returns (outputs, model_version).

        ``priority`` ("high"/"normal"/"low") and ``hedge`` select the
        shed tier."""
        model = self._store.current()
        if model is None:
            raise RuntimeError("no model loaded")
        n = _batch_dim(features)
        limit = max(self._effective_limit(), model.static_batch_size or 0)
        if n > limit:
            raise ValueError(
                f"request batch {n} exceeds the server's max batch "
                f"size {limit}; split the request"
            )
        request = _Request(features, n)
        with self._tracer.span("request", n=n) as req_span:
            if req_span.span_id is not None:
                request.trace_ctx = (req_span.trace_id, req_span.span_id)
            with self._cond:
                try:
                    self._shed_locked(priority, hedge)
                except self.QueueFullError as exc:
                    self._m_shed.labels(tier=exc.tier).inc()
                    raise
                self._queue.append(request)
                self._cond.notify_all()
            if not request.event.wait(timeout):
                request.cancelled = True
                raise TimeoutError("predict timed out")
            self._m_latency.observe(time.monotonic() - request.enqueued_at)
            if request.error is not None:
                raise request.error
            return request.outputs, request.version

    # ---- batcher side --------------------------------------------------

    def _effective_limit(self) -> int:
        """Flush/pad ceiling: a non-polymorphic bundle caps the batch at
        its one exported size."""
        model = self._store.current()
        static = model.static_batch_size if model is not None else None
        if static:
            return min(self.max_batch_size, static)
        return self.max_batch_size

    def _take_batch(self) -> List[_Request]:
        """Block until a flushable batch exists, then pop it: flush when
        the queued examples reach the limit or the oldest has waited
        batch_deadline."""
        with self._cond:
            while True:
                if self._stop:
                    return []
                if not self._queue:
                    self._cond.wait(timeout=0.1)
                    continue
                self._queue = [r for r in self._queue if not r.cancelled]
                if not self._queue:
                    continue
                limit = self._effective_limit()
                deadline = self._queue[0].enqueued_at + self.batch_deadline
                total = 0
                take = 0
                for request in self._queue:
                    if total + request.n > limit:
                        break
                    total += request.n
                    take += 1
                if take == 0:
                    # The head request alone exceeds the limit (a static
                    # bundle larger than max_batch_size): it goes alone.
                    take, total = 1, self._queue[0].n
                full = total >= limit or take < len(self._queue)
                now = time.monotonic()
                if full or now >= deadline:
                    batch = self._queue[:take]
                    del self._queue[:take]
                    # Atomic with the pop: drain waits on (queue empty
                    # and not busy).
                    self._busy = True
                    self._m_flushes.labels(
                        reason="size" if full else "deadline").inc()
                    return batch
                self._cond.wait(timeout=deadline - now)

    @staticmethod
    def bucket_batch(n: int, limit: int) -> int:
        """Padded batch size: next power of two >= n, clamped to the
        limit."""
        bucket = 1
        while bucket < n:
            bucket *= 2
        return min(bucket, max(limit, n))

    def _trace_batch(self, batch: List[_Request], record_wait: bool):
        """Retro-record each request's queue-wait span (enqueue to pop)
        and return the context the shared batch spans hang off (the
        head request's); None when tracing is off."""
        if not tracing.enabled():
            return None
        now = time.monotonic()
        head_ctx = None
        for request in batch:
            if request.trace_ctx is None:
                continue
            trace_id, span_id = request.trace_ctx
            if head_ctx is None:
                head_ctx = request.trace_ctx
            if record_wait:
                tracing.record_span(
                    "queue_wait", request.enqueued_at,
                    now - request.enqueued_at,
                    trace_id=trace_id, parent_id=span_id, role="serving",
                )
        return head_ctx

    def _run_batch(self, batch: List[_Request], _record_wait=True):
        model = self._store.current()
        total = sum(r.n for r in batch)
        head_ctx = self._trace_batch(batch, _record_wait)
        try:
            assembly_t0 = time.monotonic()
            structure = _tree_structure(batch[0].features)
            for request in batch[1:]:
                if _tree_structure(request.features) != structure:
                    raise ValueError(
                        "requests in one batch disagree on feature "
                        "structure"
                    )
            features = _concat_trees([r.features for r in batch])
            if model.static_batch_size:
                target = model.static_batch_size
            else:
                target = self.bucket_batch(total, self._effective_limit())
            features = _pad_tree(features, target, total)
            self._m_padded.inc(target - total)
            t0 = time.monotonic()
            if head_ctx is not None:
                tracing.record_span(
                    "batch_assembly", assembly_t0, t0 - assembly_t0,
                    trace_id=head_ctx[0], parent_id=head_ctx[1],
                    role="serving", requests=len(batch),
                    examples=int(total), bucket=int(target),
                )
            outputs = model.predict(features)
            predict_dur = time.monotonic() - t0
            if head_ctx is not None:
                tracing.record_span(
                    "predict", t0, predict_dur,
                    trace_id=head_ctx[0], parent_id=head_ctx[1],
                    role="serving", requests=len(batch),
                    examples=int(total), bucket=int(target),
                )
            self._m_batch_seconds.observe(predict_dur)
            self._m_batch_size.observe(total)
            self.batch_occupancy[total] += 1
            lo = 0
            for request in batch:
                request.outputs = _slice_tree(outputs, lo, lo + request.n)
                request.version = model.version
                lo += request.n
        except Exception as exc:
            self._m_errors.inc()
            if len(batch) > 1:
                # Isolate the poison request: one bad payload must not
                # fail the innocent requests sharing its flush (their
                # queue-wait is already recorded).
                for request in batch:
                    self._run_batch([request], _record_wait=False)
                return
            batch[0].error = exc
        finally:
            for request in batch:
                request.event.set()

    def _loop(self):
        while True:
            batch = self._take_batch()  # sets _busy with the pop
            if not batch:
                return
            try:
                self._run_batch(batch)
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def start(self) -> "BatchingPredictor":
        if self._thread is None:
            self._stop = False
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="serving-batcher"
            )
            self._thread.start()
        return self

    def stop(self, join_timeout: float = 5.0) -> bool:
        """Stop the batcher; False if its thread (an in-flight predict)
        outlived ``join_timeout``. Requests still queued, and any
        submitted later, answer QueueFullError (tier "draining")."""
        with self._cond:
            self._stop = True
            stranded, self._queue = self._queue, []
            self._cond.notify_all()
        for request in stranded:
            self._m_shed.labels(tier="draining").inc()
            request.error = self.QueueFullError(
                "server stopped", tier="draining", retry_after=2.0)
            request.event.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=join_timeout)
            return not thread.is_alive()
        return True

    def drain(self, timeout: float = 30.0) -> bool:
        """Refuse new submits, flush every queued micro-batch including
        the one mid-predict, then stop the batcher. False if the work
        did not finish inside ``timeout``."""
        deadline = time.monotonic() + float(timeout)
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        drained = True
        while True:
            with self._cond:
                if not self._queue and not self._busy:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    drained = False
                    break
                self._cond.wait(timeout=min(remaining, 0.05))
        remaining = max(0.1, deadline - time.monotonic())
        return self.stop(join_timeout=remaining) and drained

    def record_status(self, code: int):
        self._m_requests.labels(code=str(code)).inc()


class _Handler(BaseHTTPRequestHandler):
    server_ref = None  # type: Optional[InferenceServer]

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

    def _reply_json(self, code: int, payload):
        self._reply(code, json.dumps(payload).encode("utf-8"),
                    "application/json")

    def _reply_error(self, code: int, message: str, as_msgpack: bool,
                     headers=()):
        type(self).server_ref.predictor.record_status(code)
        if as_msgpack:
            from elasticdl_tpu_torch.common import tensor_utils

            body = tensor_utils.dumps({"error": message})
            self._reply(code, body, MSGPACK_CONTENT_TYPE, headers)
        else:
            body = json.dumps({"error": message}).encode("utf-8")
            self._reply(code, body, "application/json", headers)

    def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
        srv = type(self).server_ref
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = render_prometheus(srv.registry.snapshot())
            self._reply(200, body.encode("utf-8"),
                        "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/traces":
            # The flight recorder's spans; empty until the server runs
            # with --flight_recorder N.
            self._reply_json(200, {"spans": tracing.recorder_spans()})
        elif path == "/healthz":
            ok = srv.store.current() is not None
            self._reply(200 if ok else 503,
                        b"ok\n" if ok else b"no model\n",
                        "text/plain; charset=utf-8")
        elif path == "/v1/models":
            current = srv.store.current()
            self._reply_json(200, {
                "versions": srv.store.versions(),
                "current": current.version if current else None,
                "meta": current.meta if current else None,
            })
        else:
            self.send_error(404, "try /v1/predict, /v1/models, /metrics")

    def do_POST(self):  # noqa: N802
        srv = type(self).server_ref
        path = self.path.split("?", 1)[0]
        if path == "/v1/models/rollback":
            try:
                model = srv.store.rollback()
            except RuntimeError as exc:
                self._reply_error(409, str(exc), as_msgpack=False)
                return
            self._reply_json(200, {"current": model.version})
            return
        if path != "/v1/predict":
            self.send_error(404, "POST /v1/predict")
            return
        length = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(length)
        as_msgpack = self.headers.get(
            "Content-Type", ""
        ).startswith(MSGPACK_CONTENT_TYPE)
        try:
            if as_msgpack:
                from elasticdl_tpu_torch.common import tensor_utils

                payload = tensor_utils.loads(raw)
            else:
                payload = json.loads(raw.decode("utf-8"))
            features = payload["features"]
            model = srv.store.current()
            features = _coerce_signature(
                features,
                model.meta.get("feature_signature") if model else None,
            )
        except Exception as exc:
            self._reply_error(400, f"bad request: {exc}",
                              as_msgpack=as_msgpack)
            return
        # Router-set scheduling hints: X-Priority selects the shed tier,
        # X-Hedge marks a speculative second attempt (shed first).
        priority = self.headers.get("X-Priority", "normal").lower()
        if priority not in ("high", "normal", "low"):
            priority = "normal"
        hedge = self.headers.get("X-Hedge", "") == "1"
        try:
            outputs, version = srv.predictor.submit(
                features, timeout=srv.request_timeout,
                priority=priority, hedge=hedge,
            )
        except BatchingPredictor.QueueFullError as exc:
            self._reply_error(
                429, str(exc), as_msgpack=as_msgpack,
                headers=(("Retry-After",
                          str(max(1, int(round(exc.retry_after))))),
                         ("X-Shed-Tier", exc.tier)),
            )
            return
        except TimeoutError as exc:
            self._reply_error(504, str(exc), as_msgpack=as_msgpack)
            return
        except (ValueError, TypeError) as exc:
            self._reply_error(400, str(exc), as_msgpack=as_msgpack)
            return
        except RuntimeError as exc:
            self._reply_error(503, str(exc), as_msgpack=as_msgpack)
            return
        except Exception as exc:
            self._reply_error(500, f"{type(exc).__name__}: {exc}",
                              as_msgpack=as_msgpack)
            return
        srv.predictor.record_status(200)
        if as_msgpack:
            from elasticdl_tpu_torch.common import tensor_utils

            body = tensor_utils.dumps(
                {"predictions": outputs, "model_version": version}
            )
            self._reply(200, body, MSGPACK_CONTENT_TYPE)
        else:
            self._reply_json(200, {
                "predictions": _tree_map(
                    lambda x: np.asarray(x).tolist(), outputs
                ),
                "model_version": version,
            })

    def log_message(self, fmt, *args):
        logger.debug("serving http: " + fmt, *args)


class _ServingHTTPServer(ThreadingHTTPServer):
    """Keeps its open connections, so ``cut_connections`` can end them
    as a dead process's would end."""

    daemon_threads = True
    # socketserver's default listen backlog (5) SYN-drops a client fleet
    # connecting at once.
    request_queue_size = 128

    def __init__(self, *args, **kwargs):
        self._conns = set()
        self._conns_lock = threading.Lock()
        super().__init__(*args, **kwargs)

    def process_request(self, request, client_address):
        with self._conns_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def cut_connections(self):
        """Refuse new connections and end the open ones, at once."""
        with self._conns_lock:
            conns = list(self._conns)
        for conn in [self.socket] + conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def handle_error(self, request, client_address):
        # A handler answering into a connection that stop() cut.
        if isinstance(sys.exc_info()[1], ConnectionError):
            return
        super().handle_error(request, client_address)


class InferenceServer:
    """The assembled serving process: store + batcher + HTTP front.

    ``port=0`` binds an ephemeral port; ``start()`` returns at once
    (daemon threads), ``wait()`` blocks for a process-main lifetime."""

    def __init__(self, store, max_batch_size: int = 64,
                 batch_deadline_ms: float = 5.0, max_queue: int = 256,
                 port: int = 8500, host: str = "",
                 request_timeout: float = 30.0,
                 hedge_shed_frac: float = 0.5,
                 low_shed_frac: float = 0.75,
                 metrics_registry=None):
        self.store = store
        self.registry = metrics_registry or default_registry()
        self.predictor = BatchingPredictor(
            store, max_batch_size=max_batch_size,
            batch_deadline_ms=batch_deadline_ms, max_queue=max_queue,
            hedge_shed_frac=hedge_shed_frac, low_shed_frac=low_shed_frac,
            metrics_registry=self.registry,
        )
        self.request_timeout = float(request_timeout)
        self._host = host
        self._requested_port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else 0

    def start(self) -> "InferenceServer":
        self.predictor.start()
        handler = type("_BoundHandler", (_Handler,), {"server_ref": self})
        self._httpd = _ServingHTTPServer(
            (self._host, self._requested_port), handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="serving-http",
        )
        self._thread.start()
        logger.info("Inference server on port %d", self.port)
        return self

    def wait(self):
        self._thread.join()

    def stop(self):
        """Tear down now, as a dead process would: the listener and the
        open connections close (a request in flight fails at its
        client), then the batcher stops."""
        if self._httpd is not None:
            self._httpd.cut_connections()
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.predictor.stop()
        self.store.stop()

    def drain(self, grace: float = 25.0) -> bool:
        """Graceful SIGTERM shutdown: stop accepting, flush in-flight
        micro-batches (new submits get 429), then tear down."""
        logger.info("draining inference server (grace %.1fs)", grace)
        if self._httpd is not None:
            self._httpd.shutdown()
        drained = self.predictor.drain(timeout=grace)
        if self._httpd is not None:
            self._httpd.server_close()
            self._httpd = None
        self.store.stop()
        logger.info(
            "inference server drained (%s)",
            "clean" if drained else "grace expired with queued work",
        )
        return drained


def main(argv=None) -> int:
    """``elasticdl_tpu_torch serve`` entry: serve an export directory."""
    import argparse
    import os
    import signal

    parser = argparse.ArgumentParser("elasticdl_tpu_torch-serve")
    parser.add_argument(
        "--model_dir", required=True,
        help="A bundle directory, or a directory of versioned bundle "
             "subdirectories (hot reload polls it)",
    )
    parser.add_argument("--port", type=int, default=8500)
    parser.add_argument("--max_batch_size", type=int, default=64)
    parser.add_argument(
        "--batch_deadline_ms", type=float, default=5.0,
        help="Max time the oldest queued request waits before a "
             "partial batch flushes",
    )
    parser.add_argument("--max_queue", type=int, default=256,
                        help="Queued requests beyond this shed with 429")
    parser.add_argument(
        "--row_service_addr", default="",
        help="Comma list of HostRowService shard addresses: required "
             "for bundles exported in row-service mode (host_id_keys)",
    )
    parser.add_argument(
        "--model_zoo", default="",
        help="Zoo directory: build the module from the bundle's "
             "model_def there instead of from its recorded config",
    )
    parser.add_argument("--poll_seconds", type=float, default=2.0)
    parser.add_argument("--retain_versions", type=int, default=1)
    parser.add_argument("--request_timeout", type=float, default=30.0)
    parser.add_argument(
        "--row_cache_capacity", type=int, default=0,
        help="Hot-row LRU size (rows) for row-service bundles; 0 "
             "(default) = no cache",
    )
    parser.add_argument(
        "--row_cache_version_check_ms", type=float, default=50.0,
        help="How often the cache re-reads the row service's per-table "
             "update counters. 0 = every request (read-your-writes); "
             "negative = never (immutable tables)",
    )
    parser.add_argument(
        "--hedge_shed_frac", type=float, default=0.5,
        help="Queue fraction past which hedged requests shed with 429",
    )
    parser.add_argument(
        "--low_shed_frac", type=float, default=0.75,
        help="Queue fraction past which low-priority requests shed "
             "with 429",
    )
    parser.add_argument(
        "--drain_grace", type=float, default=25.0,
        help="SIGTERM drain budget for in-flight micro-batches",
    )
    parser.add_argument(
        "--flight_recorder", type=int, default=0,
        help="Install a span flight recorder of this many entries "
             "(request / queue-wait / batch-assembly / predict spans, "
             "served on /traces). 0 (default) = off",
    )
    parser.add_argument(
        "--device", default=None,
        help="cuda (default) or cpu; with no GPU the default raises",
    )
    unported = not_ported_flags("replica_id")
    add_not_ported_flags(parser, unported)
    args = parser.parse_args(argv)
    raise_on_not_ported_flags(args, unported)

    from elasticdl_tpu_torch.observability import principal
    from elasticdl_tpu_torch.serving.model_store import ModelStore

    # This replica's row pulls meter as serving reads at the row tier.
    principal.set_process_principal(
        job=os.environ.get("ELASTICDL_JOB_NAME", ""),
        component="serving", purpose="serving_read",
    )
    if args.flight_recorder > 0:
        tracing.set_process_role("serving")
        tracing.install_recorder(
            tracing.FlightRecorder(args.flight_recorder))
    model_fn = None
    if args.model_zoo:
        from elasticdl_tpu_torch.core.model_spec import load_model_zoo_module
        from elasticdl_tpu_torch.serving.export import META_FILE

        meta_path = os.path.join(args.model_dir, META_FILE)
        model_def = ""
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                model_def = json.load(f).get("model_def", "")
        if model_def:
            module, fn_name = load_model_zoo_module(args.model_zoo,
                                                    model_def)

            def model_fn():
                return getattr(module, fn_name)(device="cpu")
    store = ModelStore(
        args.model_dir, device=args.device, model_fn=model_fn,
        row_service_addr=args.row_service_addr,
        retain=args.retain_versions, poll_seconds=args.poll_seconds,
        row_cache_capacity=args.row_cache_capacity,
        row_cache_version_check_secs=(
            args.row_cache_version_check_ms / 1e3
            if args.row_cache_version_check_ms >= 0 else -1.0),
    )
    store.load_initial()
    store.start_polling()
    server = InferenceServer(
        store, max_batch_size=args.max_batch_size,
        batch_deadline_ms=args.batch_deadline_ms,
        max_queue=args.max_queue, port=args.port,
        request_timeout=args.request_timeout,
        hedge_shed_frac=args.hedge_shed_frac,
        low_shed_frac=args.low_shed_frac,
    ).start()
    logger.info(
        "Serving %s on :%d (device=%s, max_batch=%d, deadline=%.1fms)",
        args.model_dir, server.port, store.device, args.max_batch_size,
        args.batch_deadline_ms,
    )
    stop_evt = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda *_: stop_evt.set())
        signal.signal(signal.SIGINT, lambda *_: stop_evt.set())
    except ValueError:
        # Not the main thread (embedded use): callers drain themselves.
        server.wait()
        return 0
    stop_evt.wait()
    server.drain(grace=args.drain_grace)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
