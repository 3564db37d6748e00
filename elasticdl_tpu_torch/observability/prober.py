"""Synthetic canary plane: black-box probes measuring every SLO from
the outside (copy of elasticdl_tpu/observability/prober.py; the port
keeps its own).

Every other telemetry layer — tracing, SLO burn rates, continuous
profiling, workload attribution — is white-box: it reports what the
components *say* about themselves. A wedged handler, a stale ShardMap
client, or a serving tier silently returning old rows stays green in
white-box metrics until a user notices. This module closes that gap
with **outside-in SLIs**: a ``ProbeScheduler`` runs named black-box
probes on intervals, each exercising a user-visible contract end to
end through the public wire surface (RPC stubs, the serving router's
HTTP API, the stream producer API), never through in-process
shortcuts.

Canary keyspace contract
------------------------
Synthetic traffic must never perturb real training state. Probes write
only to the **reserved canary id range** — ``[CANARY_ID_BASE,
CANARY_ID_BASE + CANARY_ID_SPAN)``, the top of the int64 id space,
far above any hashed feature id — and to the dedicated canary stream
partition (``CANARY_STREAM_PARTITION``). Rows in the canary range live
in the ordinary tables (pushes to unknown tables are rejected as
INVALID_ARGUMENT), so canary writes exercise the exact same apply /
WAL / reshard / serving-cache machinery as real rows while staying
disjoint from every trained embedding. All probe traffic is tagged
with the closed principal purpose ``canary`` so ``/usage`` accounts
synthetic load separately from every real tenant.

Probe catalog (the five shipped probes):

- ``row_ryw``            durable push -> immediate pull, byte-equal:
                         read-your-writes plus measured RPO=0 against
                         the row tier, from outside.
- ``serving_freshness``  push a canary row -> poll the serving router
                         until the prediction for the canary id
                         changes: the outside-in twin of the
                         push-to-servable SLO.
- ``reshard_convergence`` a FRESH client (no cached map) rides
                         REDIRECTs to a converged pull; its latency is
                         the convergence time across live splits.
- ``stream_watermark``   append a canary stream record -> the
                         committed watermark advances past it.
- ``dispatch_roundtrip`` get_task / report_task_result against the
                         master's dispatch plane.

Failures carry a bounded reason label (``REASONS``); a probe turning
red (``unhealthy_after`` consecutive failures) captures a black-box
incident bundle carrying the probe's trace id, and the SLO engine's
default rules burn on the probe failure ratio
(``probe-failure-burn`` in observability/slo.py). The master mounts
``render()`` on ``/probes`` and ``healthz()`` as the aggregated
``/healthz`` verdict, and registers the prober as a low-priority
gang-scheduler tenant (``PROBER_TENANT``) so it survives — and
observes — preemption. With no SLO engine (``--timeseries_secs 0``) the
master passes ``incident_recorder=None``, as the JAX master does.
"""

import logging
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

# Reserved canary keyspace: the top 2^20 ids of the non-negative int64
# range. Real ids come from feature hashing / vocab enumeration and
# stay far below this; the drill's fsck validator and the tests pin
# the constant so it cannot silently move.
CANARY_ID_BASE = 1 << 62
CANARY_ID_SPAN = 1 << 20

# Dedicated stream partition for the stream_watermark probe: canary
# records never share a partition (or watermark accounting) with real
# ingest traffic.
CANARY_STREAM_PARTITION = "canary"

# The prober's principal job label and its gang-scheduler tenant id.
CANARY_JOB = "canary-prober"
PROBER_TENANT = "__prober__"

# Closed failure-reason vocabulary — the ``reason`` label on
# ``probe_failures_total`` stays bounded no matter what a probe body
# raises (anything off-vocabulary is folded to "exception").
REASONS = (
    "timeout",      # deadline elapsed waiting on the contract
    "rpc_error",    # transport/stub error against an RPC surface
    "http_error",   # non-200 from an HTTP surface (serving router)
    "mismatch",     # byte-inequality where the contract demands equal
    "stale",        # the write never became visible / fenced answer
    "exception",    # probe body raised something unclassified
)

# Probe latencies span sub-ms in-process roundtrips to multi-second
# convergence waits; the tail bucket must hold a slow-but-green
# freshness poll.
PROBE_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

DEFAULT_INTERVAL_SECS = 15.0


def canary_id(slot: int = 0) -> int:
    """The ``slot``-th reserved canary id (wraps within the span)."""
    return CANARY_ID_BASE + (int(slot) % CANARY_ID_SPAN)


def is_canary_id(row_id: int) -> bool:
    return CANARY_ID_BASE <= int(row_id) < CANARY_ID_BASE + CANARY_ID_SPAN


class ProbeFailure(RuntimeError):
    """A probe's contract check failed. ``reason`` must come from
    ``REASONS`` (off-vocabulary reasons are folded to "exception" at
    record time so the metric label set stays closed)."""

    def __init__(self, reason: str, message: str = ""):
        super().__init__(message or reason)
        self.reason = str(reason)


class ProbeScheduler:
    """Runs registered black-box probes on their intervals.

    Each run is wrapped in the ``canary`` principal purpose (so every
    RPC the probe makes is attributed to synthetic load), traced (the
    span's trace id lands as the ``probe_seconds`` exemplar and in the
    incident bundle on a red transition), and recorded into the
    ``probe_attempts_total{probe}`` / ``probe_failures_total{probe,
    reason}`` / ``probe_seconds{probe}`` families.

    Drive it either with the background thread (``start``/``stop``,
    the master wiring) or deterministically via ``run_pending(now)`` /
    ``run_once(name)`` (tests and the chaos drill's twin).
    """

    def __init__(self, registry=None, incident_recorder=None,
                 job: str = CANARY_JOB, unhealthy_after: int = 2,
                 clock: Callable[[], float] = time.time):
        from elasticdl_tpu_torch.observability import default_registry

        registry = registry or default_registry()
        self._registry = registry
        self._incidents = incident_recorder
        self._job = str(job)
        self._default_unhealthy_after = max(1, int(unhealthy_after))
        self._clock = clock
        self._lock = threading.RLock()
        self._probes: Dict[str, dict] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # Gang-scheduler tenancy observation (note_* are wired as the
        # tenant's preempt/resume callbacks): the prober KEEPS probing
        # through its own preemption — black-box monitoring of a busy
        # fleet is the point — but records what the arbiter did to it.
        self._tenant = {"registered": False, "state": "unregistered",
                        "preemptions": 0, "resumes": 0,
                        "last_event_ts": 0.0}
        self._m_attempts = registry.counter(
            "probe_attempts_total",
            "Black-box probe runs, by probe name", ["probe"],
        )
        self._m_failures = registry.counter(
            "probe_failures_total",
            "Black-box probe failures, by probe name and bounded "
            "reason", ["probe", "reason"],
        )
        self._m_seconds = registry.histogram(
            "probe_seconds",
            "Black-box probe end-to-end latency (exemplars carry the "
            "probe run's trace id)", ["probe"],
            buckets=PROBE_BUCKETS, exemplars=True,
        )
        self._m_up = registry.gauge(
            "probe_up",
            "1 while the probe's most recent run succeeded, 0 after "
            "a failure", ["probe"],
        )

    # ---- registration ---------------------------------------------------

    def register(self, name: str, fn: Callable[[], Optional[dict]],
                 interval_secs: float = DEFAULT_INTERVAL_SECS,
                 unhealthy_after: Optional[int] = None,
                 description: str = "") -> None:
        """Add a named probe. ``fn`` is a zero-arg callable that
        raises ``ProbeFailure`` (or anything — folded to reason
        "exception") on contract violation and may return a JSON-able
        detail dict on success."""
        name = str(name)
        if not name:
            raise ValueError("probe name must be non-empty")
        with self._lock:
            if name in self._probes:
                raise ValueError(f"probe {name!r} already registered")
            self._probes[name] = {
                "fn": fn,
                "interval_secs": float(interval_secs),
                "unhealthy_after": max(1, int(
                    self._default_unhealthy_after
                    if unhealthy_after is None else unhealthy_after
                )),
                "description": str(description),
                "status": "init",
                "attempts": 0,
                "failures": 0,
                "consecutive_failures": 0,
                "reds": 0,
                "next_due": 0.0,   # first tick runs every probe once
                "last_run_ts": 0.0,
                "last_ok_ts": 0.0,
                "last_failure_ts": 0.0,
                "last_reason": "",
                "last_error": "",
                "last_latency_secs": 0.0,
                "last_trace_id": "",
                "last_detail": {},
            }

    def probe_names(self) -> List[str]:
        with self._lock:
            return list(self._probes)

    # ---- execution ------------------------------------------------------

    def run_once(self, name: str, now: Optional[float] = None) -> dict:
        """Run one probe immediately; returns its result record."""
        from elasticdl_tpu_torch.observability import principal, tracing

        with self._lock:
            ent = self._probes[name]
            fn = ent["fn"]
        if now is None:
            now = self._clock()
        span = tracing.span(f"probe/{name}", probe=name)
        reason, detail, ok = "", {}, True
        with principal.pushed(job=self._job, component="prober",
                              purpose="canary"):
            t0 = time.perf_counter()
            try:
                with span:
                    out = fn()
                if isinstance(out, dict):
                    detail = out
            except ProbeFailure as exc:
                ok = False
                reason = (exc.reason if exc.reason in REASONS
                          else "exception")
                detail = {"error": str(exc)}
            except Exception as exc:  # a probe bug must not kill the plane
                ok = False
                reason = "exception"
                detail = {"error": f"{type(exc).__name__}: {exc}"}
                logger.exception("probe %s raised", name)
            elapsed = time.perf_counter() - t0
        trace_id = span.trace_id or ""
        self._m_attempts.labels(name).inc()
        self._m_seconds.labels(name).observe(
            elapsed, trace_id=trace_id or None
        )
        went_red = False
        with self._lock:
            ent["attempts"] += 1
            ent["last_run_ts"] = now
            ent["last_latency_secs"] = elapsed
            ent["last_trace_id"] = trace_id
            ent["next_due"] = now + ent["interval_secs"]
            if ok:
                ent["consecutive_failures"] = 0
                ent["last_ok_ts"] = now
                ent["status"] = "green"
                ent["last_detail"] = detail
                self._m_up.labels(name).set(1.0)
            else:
                self._m_failures.labels(name, reason).inc()
                self._m_up.labels(name).set(0.0)
                ent["failures"] += 1
                ent["consecutive_failures"] += 1
                ent["last_failure_ts"] = now
                ent["last_reason"] = reason
                ent["last_error"] = str(detail.get("error", ""))
                if (ent["consecutive_failures"] >= ent["unhealthy_after"]
                        and ent["status"] != "red"):
                    ent["status"] = "red"
                    ent["reds"] += 1
                    went_red = True
            record = {
                "probe": name, "ok": ok, "reason": reason,
                "status": ent["status"], "latency_secs": elapsed,
                "trace_id": trace_id, "detail": detail,
            }
            consecutive = ent["consecutive_failures"]
            description = ent["description"]
        if went_red:
            # Red TRANSITION only (the recorder also rate-limits per
            # rule): one bundle per outage, carrying the failing run's
            # trace id so the flight-recorder timeline and the
            # probe_seconds exemplars resolve to the same trace.
            self._capture_incident(name, reason, trace_id, consecutive,
                                   description, now)
        return record

    def run_pending(self, now: Optional[float] = None) -> List[dict]:
        """Run every probe whose interval elapsed; returns their
        result records (deterministic tick for tests/drills)."""
        if now is None:
            now = self._clock()
        with self._lock:
            due = [name for name, ent in self._probes.items()
                   if now >= ent["next_due"]]
        return [self.run_once(name, now=now) for name in due]

    def start(self, poll_secs: float = 0.25) -> None:
        """Background mode: tick ``run_pending`` on a daemon thread."""
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()

            def loop():
                while not self._stop.wait(poll_secs):
                    try:
                        self.run_pending()
                    except Exception:
                        logger.exception("probe tick failed")

            self._thread = threading.Thread(
                target=loop, name="probe-scheduler", daemon=True
            )
            self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        with self._lock:
            thread = self._thread
            self._thread = None
        if thread is not None:
            self._stop.set()
            thread.join(timeout=timeout)

    # ---- incident capture ----------------------------------------------

    def _capture_incident(self, name: str, reason: str, trace_id: str,
                          consecutive: int, description: str,
                          now: float) -> None:
        rec = self._incidents
        if rec is None:
            return
        # Same alert-state shape the SLO engine hands the recorder;
        # series names the exemplar-linked family so the bundle's
        # exemplars.json resolves the probe's trace id.
        state = {
            "rule": f"probe-{name}",
            "state": "firing",
            "since": now,
            "kind": "probe",
            "series": "edl_tpu_probe_seconds",
            "labels": {"probe": name},
            "probe": name,
            "reason": reason,
            "trace_id": trace_id,
            "value": float(consecutive),
            "description": description or (
                f"black-box probe {name} red ({reason})"
            ),
        }
        try:
            rec.capture(state, now=now)
        except Exception:
            logger.exception("probe %s incident capture failed", name)

    # ---- gang-scheduler tenancy ----------------------------------------

    def note_registered(self) -> None:
        with self._lock:
            self._tenant["registered"] = True
            self._tenant["state"] = "submitted"

    def note_preempted(self, job_id=None, entry=None) -> None:
        """Wired as the tenant's ``preempt_cb``: probing continues —
        an observer that stops observing under pressure is useless —
        but the eviction is recorded and rendered."""
        with self._lock:
            self._tenant["preemptions"] += 1
            self._tenant["state"] = "preempted"
            self._tenant["last_event_ts"] = self._clock()

    def note_resumed(self, job_id=None, entry=None) -> None:
        with self._lock:
            self._tenant["resumes"] += 1
            self._tenant["state"] = "running"
            self._tenant["last_event_ts"] = self._clock()

    # ---- rendering ------------------------------------------------------

    def render(self) -> dict:
        """The ``/probes`` endpoint body."""
        with self._lock:
            probes = {}
            for name, ent in self._probes.items():
                probes[name] = {
                    key: ent[key] for key in (
                        "status", "attempts", "failures",
                        "consecutive_failures", "reds",
                        "interval_secs", "unhealthy_after",
                        "last_run_ts", "last_ok_ts", "last_failure_ts",
                        "last_reason", "last_error",
                        "last_latency_secs", "last_trace_id",
                        "description",
                    )
                }
            return {
                "job": self._job,
                "purpose": "canary",
                "canary_id_base": CANARY_ID_BASE,
                "canary_id_span": CANARY_ID_SPAN,
                "tenant": dict(self._tenant),
                "probes": probes,
            }

    def healthz(self) -> dict:
        """Aggregated outside-in verdict: ok while no probe is red.
        Probes that never ran ("init") do not fail the verdict — a
        just-started master must not report unhealthy before the first
        probe interval elapses."""
        with self._lock:
            statuses = {
                name: ent["status"] for name, ent in self._probes.items()
            }
        red = sorted(n for n, s in statuses.items() if s == "red")
        ok = not red
        return {
            "ok": ok,
            "status": "ok" if ok else "degraded",
            "red": red,
            "probes": statuses,
        }


# ---------------------------------------------------------------------------
# Transport helpers + the five shipped probe factories. Every factory
# takes injectable callables (or addresses it builds repo-standard
# clients over), so the master wiring, the chaos drill, and the fast
# tests share one probe body each.
# ---------------------------------------------------------------------------


def _probe_guard(fn):
    """Run ``fn`` mapping transport errors onto the bounded reason
    vocabulary; ``ProbeFailure`` passes through untouched."""
    from elasticdl_tpu_torch.comm.rpc import RpcError

    try:
        return fn()
    except ProbeFailure:
        raise
    except TimeoutError as exc:
        raise ProbeFailure("timeout", f"{exc}")
    except RpcError as exc:
        text = str(exc)
        low = text.lower()
        if "deadline" in low or "timeout" in low or "timed out" in low:
            raise ProbeFailure("timeout", text)
        raise ProbeFailure("rpc_error", text)
    except (ConnectionError, OSError) as exc:
        raise ProbeFailure("rpc_error", f"{type(exc).__name__}: {exc}")


class RowCanaryClient:
    """A remote-engine client pinned to the canary id range. Lazily
    connects (the fleet may come up after the prober) with a SHORT
    retry budget — a probe must fail fast and red the SLI, not ride a
    four-minute reconnect loop."""

    def __init__(self, addrs: str, table: Optional[str] = None,
                 retries: int = 2, backoff_secs: float = 0.2):
        self._addrs = addrs
        self._configured_table = table
        self._retries = int(retries)
        self._backoff = float(backoff_secs)
        self._engine = None
        self._table_name = None
        self._lock = threading.Lock()

    def _resolve(self):
        from elasticdl_tpu_torch.embedding.row_service import (
            make_remote_engine,
        )

        with self._lock:
            if self._engine is None:
                engine = make_remote_engine(
                    self._addrs, {}, retries=self._retries,
                    backoff_secs=self._backoff,
                )
                if self._configured_table is not None:
                    name = self._configured_table
                    if name not in engine.tables:
                        raise ProbeFailure(
                            "rpc_error",
                            f"canary table {name!r} not served "
                            f"(fleet has {sorted(engine.tables)})",
                        )
                else:
                    name = sorted(engine.tables)[0]
                self._engine, self._table_name = engine, name
            return self._engine, self._table_name

    def reset(self):
        """Drop the cached engine (fresh bootstrap on next use)."""
        with self._lock:
            self._engine = None

    @property
    def table_name(self) -> Optional[str]:
        return self._table_name

    def dim(self) -> int:
        engine, name = self._resolve()
        return int(engine.tables[name].dim)

    def pull(self, ids) -> np.ndarray:
        def body():
            engine, name = self._resolve()
            return np.asarray(
                engine.tables[name].get(np.asarray(ids, np.int64)),
                np.float32,
            )

        return _probe_guard(body)

    def push(self, ids, grads) -> None:
        def body():
            engine, name = self._resolve()
            engine.optimizer.apply_gradients(
                engine.tables[name], np.asarray(ids, np.int64),
                np.asarray(grads, np.float32),
            )

        _probe_guard(body)

    def map_version(self) -> int:
        with self._lock:
            engine = self._engine
        if engine is None:
            return 0
        cmap = getattr(engine, "shard_map", None)
        try:
            return int(cmap.version) if cmap is not None else 0
        except AttributeError:
            return 0


def make_row_ryw_probe(client: RowCanaryClient, slot: int = 0,
                       eps: float = 1e-3,
                       expect_fn: Optional[Callable] = None):
    """Read-your-writes against the row tier: durable push, immediate
    pull, byte-equality. With ``expect_fn(before, grads) -> expected``
    (the deployment knows its optimizer rule) the pulled bytes must
    EQUAL the expected bytes; without it the pull must differ from the
    pre-push bytes (the write is visible). The push sign alternates so
    the canary row stays bounded forever."""
    state = {"sign": 1.0}

    def probe():
        ids = np.array([canary_id(slot)], np.int64)
        before = client.pull(ids)
        grads = np.full((1, before.shape[1]), state["sign"] * eps,
                        np.float32)
        state["sign"] = -state["sign"]
        client.push(ids, grads)        # durable-ack on a WAL'd fleet
        after = client.pull(ids)
        if expect_fn is not None:
            expected = np.asarray(expect_fn(before, grads), np.float32)
            if not np.array_equal(after, expected):
                raise ProbeFailure(
                    "mismatch",
                    "pull after durable push is not byte-equal to the "
                    "expected applied row",
                )
        elif np.array_equal(after, before):
            raise ProbeFailure(
                "stale",
                "read-your-writes violated: pull after durable push "
                "returned the pre-push bytes",
            )
        return {"table": client.table_name, "id": int(ids[0])}

    return probe


def make_reshard_convergence_probe(addrs: str,
                                   table: Optional[str] = None,
                                   slots=(0, 1, 2, 3),
                                   retries: int = 2,
                                   backoff_secs: float = 0.2):
    """A FRESH client every run — no cached shard map — bootstraps,
    adopts the newest installed map, and pulls canary ids across the
    whole fleet, riding any REDIRECT a live split throws at it. The
    probe's own ``probe_seconds`` observation IS the fresh-client
    convergence time."""
    ids = np.array([canary_id(s) for s in slots], np.int64)

    def probe():
        client = RowCanaryClient(addrs, table=table, retries=retries,
                                 backoff_secs=backoff_secs)
        rows = client.pull(ids)
        return {
            "rows": int(rows.shape[0]),
            "map_version": client.map_version(),
        }

    return probe


def fingerprint_predictions(tree) -> bytes:
    """Stable byte fingerprint of a prediction output tree (dict /
    list / array nests) — the freshness probe's change detector."""
    parts = []

    def walk(node):
        if isinstance(node, dict):
            for key in sorted(node):
                parts.append(str(key).encode())
                walk(node[key])
        elif isinstance(node, (list, tuple)):
            for item in node:
                walk(item)
        else:
            arr = np.asarray(node)
            parts.append(arr.dtype.str.encode())
            parts.append(arr.tobytes())

    walk(tree)
    return b"|".join(parts)


def make_router_predictor(router_addr: str, feature_key: str, ids,
                          timeout: float = 2.0):
    """Predict callable over the serving router's public HTTP surface
    (msgpack ``/v1/predict``), returning the predictions tree."""
    ids = np.asarray(ids, np.int64)

    def predict():
        import http.client

        from elasticdl_tpu_torch.common import tensor_utils

        host, _, port = router_addr.rpartition(":")
        body = tensor_utils.dumps({"features": {feature_key: ids}})
        conn = http.client.HTTPConnection(host or "localhost",
                                          int(port), timeout=timeout)
        try:
            try:
                conn.request(
                    "POST", "/v1/predict", body=body,
                    headers={"Content-Type": "application/x-msgpack"},
                )
                resp = conn.getresponse()
                raw = resp.read()
            except (TimeoutError, OSError) as exc:
                raise ProbeFailure(
                    "timeout" if isinstance(exc, TimeoutError)
                    else "http_error",
                    f"router predict: {type(exc).__name__}: {exc}",
                )
            if resp.status != 200:
                raise ProbeFailure(
                    "http_error",
                    f"router /v1/predict -> HTTP {resp.status}",
                )
            return tensor_utils.loads(raw).get("predictions")
        finally:
            conn.close()

    return predict


def make_serving_freshness_probe(predict_fn, push_fn,
                                 deadline_secs: float = 5.0,
                                 poll_secs: float = 0.05):
    """Outside-in push-to-servable: snapshot the canary prediction,
    push a canary row grad, poll the router until the prediction
    CHANGES. ``push_fn(sign)`` pushes a bounded alternating-sign grad
    to the canary row; ``predict_fn()`` returns the predictions tree
    for the canary id."""
    state = {"sign": 1.0}

    def probe():
        base = fingerprint_predictions(predict_fn())
        push_fn(state["sign"])
        state["sign"] = -state["sign"]
        deadline = time.monotonic() + deadline_secs
        polls = 0
        while True:
            polls += 1
            if fingerprint_predictions(predict_fn()) != base:
                return {"polls": polls}
            if time.monotonic() >= deadline:
                raise ProbeFailure(
                    "stale",
                    f"canary write not servable within "
                    f"{deadline_secs}s ({polls} polls)",
                )
            time.sleep(poll_secs)

    return probe


def make_stream_appender(stream_dir: str,
                         partition: str = CANARY_STREAM_PARTITION,
                         slot: int = 0):
    """Append callable for the stream_watermark probe: writes a canary
    record (id inside the reserved range, fsync'd) and returns its
    offset."""
    import json as _json

    from elasticdl_tpu_torch.data.stream import StreamWriter

    writer = StreamWriter(stream_dir)

    def append() -> int:
        payload = _json.dumps(
            {"id": canary_id(slot), "canary": True}
        ).encode()
        return writer.append(partition, payload, fsync=True)

    return append


def make_stream_watermark_probe(append_fn, watermark_fn,
                                deadline_secs: float = 10.0,
                                poll_secs: float = 0.05):
    """Append a canary stream record, then poll the committed
    watermark until it passes the record's offset. ``watermark_fn()``
    returns the canary partition's committed watermark (record count)
    or None while the partition is undiscovered."""

    def probe():
        offset = int(_probe_guard(append_fn))
        deadline = time.monotonic() + deadline_secs
        polls = 0
        while True:
            polls += 1
            wm = _probe_guard(watermark_fn)
            if wm is not None and int(wm) > offset:
                return {"offset": offset, "committed": int(wm),
                        "polls": polls}
            if time.monotonic() >= deadline:
                raise ProbeFailure(
                    "stale",
                    f"committed watermark did not pass offset "
                    f"{offset} within {deadline_secs}s "
                    f"(last {wm!r})",
                )
            time.sleep(poll_secs)

    return probe


def make_dispatch_roundtrip_probe(master_addr: str,
                                  worker_id: int = -1,
                                  resolve: bool = False,
                                  timeout: float = 2.0):
    """get_task / report_task_result against the master's dispatch
    plane. Leased tasks are handed straight back with the graceful
    ``preempted:`` reason (no retry budget burned, the task re-queues
    at the front) unless ``resolve=True`` — the drill mode, where the
    only job on the master is the canary stream and the probe doubles
    as its worker."""
    from elasticdl_tpu_torch.comm.rpc import RpcStub
    from elasticdl_tpu_torch.master.servicer import SERVICE_NAME

    holder: dict = {"stub": None}

    def probe():
        def body():
            stub = holder["stub"]
            if stub is None:
                stub = RpcStub(master_addr, SERVICE_NAME,
                               max_retries=0)
                holder["stub"] = stub
            try:
                resp = stub.call("get_task", timeout=timeout,
                                 worker_id=int(worker_id))
            except Exception:
                # Next run reconnects: a channel wedged by a master
                # kill must not fail every later probe run too.
                stub.reconnect()
                raise
            if resp.get("stale_master"):
                raise ProbeFailure(
                    "stale", "fenced master answered get_task"
                )
            task = resp.get("task") or {}
            detail = {"finished": bool(resp.get("finished")),
                      "resolved": False}
            task_id = int(task.get("task_id", -1))
            if task_id >= 0:
                fields = {"task_id": task_id,
                          "worker_id": int(worker_id)}
                job = resp.get("job")
                if job:
                    fields["job"] = job
                gen = resp.get("generation")
                if gen is not None:
                    fields["generation"] = gen
                if not resolve:
                    fields["err_reason"] = (
                        "preempted: canary probe hand-back"
                    )
                stub.call("report_task_result", timeout=timeout,
                          **fields)
                detail.update(task_id=task_id, resolved=bool(resolve))
            return detail

        return _probe_guard(body)

    return probe
