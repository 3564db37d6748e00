"""The port's serving fleet against the JAX package's cases: routing
policies, hedging, tiered shedding on the replica and the router, the
router end to end over real ``InferenceServer`` replicas (fake
predictors: no model cost), its drain, and the replica's ``/metrics``
and ``/traces``.

The cases are the JAX package's (tests/test_serving_router.py,
tests/test_serving.py's metrics case) run against
``elasticdl_tpu_torch.serving``; the consistent-hash ring is held to the
JAX ring's pick for the same 1,000 keys, which must be identical (both
rings hash with blake2b and place 64 virtual nodes a replica).
"""

import http.client
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.observability import MetricsRegistry, tracing
from elasticdl_tpu_torch.serving.model_store import ServedModel
from elasticdl_tpu_torch.serving.router import (
    AdaptiveHedge,
    ConsistentHashPolicy,
    LeastLoadedPolicy,
    Replica,
    RouterCore,
    RouterServer,
    _Attempt,
)
from elasticdl_tpu_torch.serving.server import (
    BatchingPredictor,
    InferenceServer,
)

FEATURE_DIM = 4


def _snap(registry):
    return {f["name"]: f for f in registry.snapshot()["families"]}


def _series_value(snap, family, **labels):
    fam = snap.get(family)
    if fam is None:
        return 0.0
    want = list(labels.values())
    for series in fam["series"]:
        if series["labels"] == want:
            return series["value"]
    return 0.0


# ---- routing policies ------------------------------------------------


class TestLeastLoaded:
    def test_picks_emptier_replica(self):
        replicas = [Replica("a:1", 0), Replica("b:1", 1)]
        replicas[0].inflight = 3
        replicas[1].inflight = 1
        policy = LeastLoadedPolicy()
        for _ in range(4):
            assert policy.pick(replicas) is replicas[1]

    def test_skips_unhealthy(self):
        replicas = [Replica("a:1", 0), Replica("b:1", 1)]
        replicas[0].healthy = False
        assert LeastLoadedPolicy().pick(replicas) is replicas[1]

    def test_rotates_among_ties(self):
        replicas = [Replica("a:1", 0), Replica("b:1", 1),
                    Replica("c:1", 2)]
        policy = LeastLoadedPolicy()
        picked = {policy.pick(replicas).index for _ in range(6)}
        assert len(picked) > 1

    def test_exclude_for_hedge(self):
        replicas = [Replica("a:1", 0), Replica("b:1", 1)]
        policy = LeastLoadedPolicy()
        assert policy.pick(replicas, exclude=(replicas[0],)) is replicas[1]
        assert policy.pick(replicas,
                           exclude=(replicas[0], replicas[1])) is None


class TestConsistentHash:
    def test_stable_under_replica_removal(self):
        """Removing one replica remaps only the keys that lived on it."""
        replicas = [Replica(f"host{i}:1", i) for i in range(4)]
        policy = ConsistentHashPolicy(replicas)
        keys = [f"user-{i}" for i in range(200)]
        before = {k: policy.pick(replicas, key=k).index for k in keys}
        assert len(set(before.values())) == 4
        replicas[2].healthy = False
        after = {k: policy.pick(replicas, key=k).index for k in keys}
        for key in keys:
            if before[key] != 2:
                assert after[key] == before[key], key
            else:
                assert after[key] != 2
        assert policy.pick(replicas, key="user-7").index == after["user-7"]

    def test_falls_back_without_key(self):
        replicas = [Replica("a:1", 0), Replica("b:1", 1)]
        replicas[0].inflight = 5
        policy = ConsistentHashPolicy(replicas)
        assert policy.pick(replicas, key=None) is replicas[1]

    @pytest.mark.parametrize("down", [None, 1])
    def test_ring_picks_what_the_jax_ring_picks(self, down):
        """1,000 keys over 3 replicas (and with one down): the port's
        ring and the JAX ring pick the same replica for every key."""
        from elasticdl_tpu.serving import router as jax_router

        addrs = ["10.0.0.1:8500", "10.0.0.2:8500", "replica-c:9000"]
        ours = [Replica(a, i) for i, a in enumerate(addrs)]
        theirs = [jax_router.Replica(a, i) for i, a in enumerate(addrs)]
        if down is not None:
            ours[down].healthy = theirs[down].healthy = False
        port_policy = ConsistentHashPolicy(ours)
        jax_policy = jax_router.ConsistentHashPolicy(theirs)
        keys = [f"key-{i}" for i in range(1000)]
        got = [port_policy.pick(ours, key=k).index for k in keys]
        want = [jax_policy.pick(theirs, key=k).index for k in keys]
        assert got == want
        assert len(set(got)) == (3 if down is None else 2)


class TestAdaptiveHedge:
    def test_pins_to_max_until_warm(self):
        hedge = AdaptiveHedge(min_ms=5, max_ms=500, min_samples=10)
        assert hedge.delay_secs() == 0.5
        for _ in range(10):
            hedge.observe(0.01)
        assert abs(hedge.delay_secs() - 0.01) < 1e-9

    def test_clamped(self):
        hedge = AdaptiveHedge(min_ms=5, max_ms=50, min_samples=1)
        hedge.observe(10.0)
        assert hedge.delay_secs() == 0.05
        for _ in range(100):
            hedge.observe(1e-6)
        assert hedge.delay_secs() == 0.005

    def test_shed_responses_do_not_feed_the_window(self):
        """Fast 429s are not service-time samples: they must not
        collapse the hedge delay to its floor."""
        core = RouterCore(["a:1", "b:1"], metrics_registry=MetricsRegistry(),
                          hedge_min_ms=5, hedge_max_ms=500)
        for _ in range(50):
            attempt = _Attempt(core, core.replicas[0], b"", "t", "normal",
                               False)
            core.replicas[0].inflight += 1
            attempt.outcome = (429, b"", "application/json", "1")
            attempt.elapsed = 0.001
            core._finish_attempt(attempt)
        assert core.hedge.delay_secs() == 0.5


# ---- replica-side tiered shedding ------------------------------------


class _RecordingPredictor:
    def __init__(self, delay: float = 0.0):
        self.delay = delay
        self.calls = 0

    def __call__(self, features):
        self.calls += 1
        if self.delay:
            time.sleep(self.delay)
        return np.asarray(features).sum(axis=1, keepdims=True)


class _FakeStore:
    def __init__(self, predictor, meta=None):
        self._model = ServedModel(
            "fake", 1, meta or {"batch_polymorphic": True}, predictor)

    def current(self):
        return self._model

    def versions(self):
        return [1]

    def stop(self):
        pass


def _try_submit(predictor, **kw):
    try:
        predictor.submit(np.ones((1, FEATURE_DIM), np.float32), timeout=1.0,
                         **kw)
    except Exception:
        pass


def _stall_queue(predictor, depth):
    """Park requests until the queue of a predictor whose batcher was
    never started holds ``depth`` of them."""
    for _ in range(depth - len(predictor._queue)):
        threading.Thread(target=lambda: _try_submit(predictor),
                         daemon=True).start()
    deadline = time.monotonic() + 5
    while len(predictor._queue) < depth:
        assert time.monotonic() < deadline, "queue never filled"
        time.sleep(0.002)


class TestShedTiers:
    def test_hedge_sheds_before_low_before_all(self):
        registry = MetricsRegistry()
        predictor = BatchingPredictor(
            _FakeStore(_RecordingPredictor()), max_queue=8,
            hedge_shed_frac=0.5, low_shed_frac=0.75,
            metrics_registry=registry,
        )  # batcher not started: the queue depth is fully controlled
        features = np.ones((1, FEATURE_DIM), np.float32)
        _stall_queue(predictor, 4)
        with pytest.raises(BatchingPredictor.QueueFullError) as exc:
            predictor.submit(features, hedge=True)
        assert exc.value.tier == "hedge"
        _stall_queue(predictor, 6)
        with pytest.raises(BatchingPredictor.QueueFullError) as exc:
            predictor.submit(features, priority="low")
        assert exc.value.tier == "low"
        assert exc.value.retry_after >= 1.0
        _stall_queue(predictor, 8)
        with pytest.raises(BatchingPredictor.QueueFullError) as exc:
            predictor.submit(features, priority="high")
        assert exc.value.tier == "capacity"
        snap = _snap(registry)
        for tier in ("hedge", "low", "capacity"):
            assert _series_value(snap, "edl_tpu_serving_load_shed_total",
                                 tier=tier) == 1.0

    def test_normal_traffic_admitted_between_tiers(self):
        predictor = BatchingPredictor(
            _FakeStore(_RecordingPredictor()), max_queue=8,
            metrics_registry=MetricsRegistry())
        _stall_queue(predictor, 6)
        count = len(predictor._queue)
        threading.Thread(
            target=lambda: _try_submit(predictor, priority="normal"),
            daemon=True).start()
        deadline = time.monotonic() + 2
        while len(predictor._queue) <= count:
            assert time.monotonic() < deadline
            time.sleep(0.002)

    def test_stop_sheds_queued_and_later_requests_as_draining(self):
        """A stopped batcher answers what was queued, and what arrives
        later, with the draining tier at once (no wait for a batcher
        that is gone)."""
        registry = MetricsRegistry()
        predictor = BatchingPredictor(
            _FakeStore(_RecordingPredictor()), max_queue=8,
            metrics_registry=registry)
        errors = []

        def queued():
            try:
                predictor.submit(np.ones((1, FEATURE_DIM), np.float32),
                                 timeout=30.0)
            except BatchingPredictor.QueueFullError as exc:
                errors.append(exc.tier)

        threads = [threading.Thread(target=queued) for _ in range(3)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 5
        while len(predictor._queue) < 3:
            assert time.monotonic() < deadline, "queue never filled"
            time.sleep(0.002)
        t0 = time.monotonic()
        assert predictor.stop() is True
        for t in threads:
            t.join(timeout=5)
        assert time.monotonic() - t0 < 2.0
        assert errors == ["draining"] * 3
        with pytest.raises(BatchingPredictor.QueueFullError) as exc:
            predictor.submit(np.ones((1, FEATURE_DIM), np.float32))
        assert exc.value.tier == "draining"
        assert _series_value(_snap(registry),
                             "edl_tpu_serving_load_shed_total",
                             tier="draining") == 4.0

    def test_stop_cuts_keep_alive_connections(self):
        """After stop() a kept-alive connection fails at once, as one to
        a dead process would, instead of reaching a stopped batcher."""
        server = _start_replica()
        port = server.port
        conn = http.client.HTTPConnection("localhost", port, timeout=10)
        body = tensor_utils.dumps(
            {"features": np.ones((1, FEATURE_DIM), np.float32)})
        headers = {"Content-Type": "application/x-msgpack"}
        try:
            conn.request("POST", "/v1/predict", body=body, headers=headers)
            resp = conn.getresponse()
            resp.read()
            assert resp.status == 200
            server.stop()
            t0 = time.monotonic()
            with pytest.raises((ConnectionError, http.client.HTTPException)):
                conn.request("POST", "/v1/predict", body=body,
                             headers=headers)
                conn.getresponse().read()
            assert time.monotonic() - t0 < 2.0
            with pytest.raises(ConnectionError):
                _predict_via(port, timeout=2)
        finally:
            conn.close()

    def test_http_429_carries_retry_after_and_tier(self):
        server = InferenceServer(
            _FakeStore(_RecordingPredictor(delay=0.2)), port=0,
            max_batch_size=1, batch_deadline_ms=0.0, max_queue=2,
            metrics_registry=MetricsRegistry(),
        ).start()
        try:
            body = tensor_utils.dumps(
                {"features": np.ones((1, FEATURE_DIM), np.float32)})
            results = []
            lock = threading.Lock()

            def fire():
                conn = http.client.HTTPConnection("localhost", server.port,
                                                  timeout=10)
                try:
                    conn.request("POST", "/v1/predict", body=body, headers={
                        "Content-Type": "application/x-msgpack",
                        "X-Priority": "low"})
                    resp = conn.getresponse()
                    resp.read()
                    with lock:
                        results.append((resp.status,
                                        resp.getheader("Retry-After"),
                                        resp.getheader("X-Shed-Tier")))
                finally:
                    conn.close()

            threads = [threading.Thread(target=fire) for _ in range(10)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            shed = [r for r in results if r[0] == 429]
            assert shed, results
            for _, retry_after, tier in shed:
                assert retry_after is not None and int(retry_after) >= 1
                assert tier in ("low", "capacity", "draining")
        finally:
            server.stop()


# ---- the replica's /metrics and /traces ------------------------------


def _get(port, path):
    with urllib.request.urlopen(f"http://localhost:{port}{path}",
                                timeout=10) as resp:
        return resp.read().decode("utf-8")


def test_metrics_families_exposed(tmp_path):
    """The JAX server's families on the port replica's /metrics, the
    model store's version gauge among them."""
    import torch

    from elasticdl_tpu_torch.serving.export import export_serving_bundle
    from elasticdl_tpu_torch.serving.model_store import ModelStore

    def model_fn():
        return torch.nn.Linear(FEATURE_DIM, 2)

    export_serving_bundle(
        str(tmp_path), model_fn(),
        batch_example=np.zeros((1, FEATURE_DIM), np.float32), version=1)
    registry = MetricsRegistry()
    store = ModelStore(str(tmp_path), device="cpu", model_fn=model_fn,
                       metrics_registry=registry)
    store.load_initial()
    server = InferenceServer(store, max_batch_size=8, batch_deadline_ms=2.0,
                             port=0, metrics_registry=registry).start()
    try:
        status, _ = _predict_via(server.port)
        assert status == 200
        text = _get(server.port, "/metrics")
        for family in ("edl_tpu_serving_requests_total",
                       "edl_tpu_serving_request_seconds",
                       "edl_tpu_serving_batch_occupancy",
                       "edl_tpu_serving_queue_depth",
                       "edl_tpu_serving_model_version",
                       "edl_tpu_serving_batch_flushes_total",
                       "edl_tpu_serving_padded_examples_total"):
            assert family in text
        assert 'edl_tpu_serving_requests_total{code="200"}' in text
    finally:
        server.stop()


def test_traces_carry_the_request_spans():
    """With a flight recorder installed, one predict leaves its
    request, queue_wait, batch_assembly and predict spans on /traces,
    the last three children of the first."""
    previous = tracing.recorder()
    tracing.install_recorder(tracing.FlightRecorder(256))
    server = InferenceServer(_FakeStore(_RecordingPredictor()), port=0,
                             batch_deadline_ms=1.0,
                             metrics_registry=MetricsRegistry()).start()
    try:
        assert _predict_via(server.port)[0] == 200
        spans = json.loads(_get(server.port, "/traces"))["spans"]
        by_name = {s["name"]: s for s in spans}
        assert {"request", "queue_wait", "batch_assembly",
                "predict"} <= set(by_name)
        root = by_name["request"]
        for name in ("queue_wait", "batch_assembly", "predict"):
            assert by_name[name]["trace_id"] == root["trace_id"]
            assert by_name[name]["parent_id"] == root["span_id"]
    finally:
        server.stop()
        if previous is None:
            tracing.uninstall_recorder()
        else:
            tracing.install_recorder(previous)


# ---- router e2e over real replicas -----------------------------------


def _start_replica(delay=0.0, registry=None, **kw):
    return InferenceServer(
        _FakeStore(_RecordingPredictor(delay=delay)), port=0,
        batch_deadline_ms=1.0,
        metrics_registry=registry or MetricsRegistry(), **kw).start()


def _predict_via(port, body=None, headers=None, timeout=15):
    if body is None:
        body = tensor_utils.dumps(
            {"features": np.ones((2, FEATURE_DIM), np.float32)})
    conn = http.client.HTTPConnection("localhost", port, timeout=timeout)
    try:
        send = {"Content-Type": "application/x-msgpack"}
        send.update(headers or {})
        conn.request("POST", "/v1/predict", body=body, headers=send)
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, (tensor_utils.loads(raw) if resp.status == 200
                             else raw)
    finally:
        conn.close()


class TestRouterEndToEnd:
    def test_routes_and_answers(self):
        replicas = [_start_replica(), _start_replica()]
        registry = MetricsRegistry()
        router = RouterServer([f"localhost:{r.port}" for r in replicas],
                              port=0, metrics_registry=registry).start()
        try:
            for _ in range(8):
                status, out = _predict_via(router.port)
                assert status == 200
                np.testing.assert_allclose(
                    np.asarray(out["predictions"]),
                    np.full((2, 1), FEATURE_DIM, np.float32))
            snap = _snap(registry)
            assert _series_value(snap, "edl_tpu_router_requests_total",
                                 code="200") == 8.0
            attempts = {s["labels"][0]: s["value"] for s in
                        snap["edl_tpu_router_attempts_total"]["series"]}
            assert set(attempts) == {"0", "1"}
            text = _get(router.port, "/metrics")
            for family in ("edl_tpu_router_requests_total",
                           "edl_tpu_router_request_seconds",
                           "edl_tpu_router_inflight",
                           "edl_tpu_router_replicas_healthy",
                           "edl_tpu_router_hedge_delay_seconds"):
                assert family in text
            info = json.loads(_get(router.port, "/v1/replicas"))
            assert info["policy"] == "least_loaded"
            assert [r["slo"]["requests"] for r in info["replicas"]] == [
                attempts["0"], attempts["1"]]
        finally:
            router.stop()
            for r in replicas:
                r.stop()

    def test_replica_kill_mid_load_availability_holds(self):
        replicas = [_start_replica(), _start_replica()]
        registry = MetricsRegistry()
        router = RouterServer(
            [f"localhost:{r.port}" for r in replicas], port=0,
            metrics_registry=registry, hedge_min_ms=5, hedge_max_ms=100,
            replica_timeout=5.0).start()
        try:
            for _ in range(10):
                assert _predict_via(router.port)[0] == 200
            replicas[0].stop()
            codes = [_predict_via(router.port)[0] for _ in range(20)]
            assert codes.count(200) == 20, codes
            snap = _snap(registry)
            assert snap["edl_tpu_router_replica_unhealthy_total"][
                "series"][0]["value"] >= 1.0
        finally:
            router.stop()
            for r in replicas:
                r.stop()

    def test_hedge_slow_replica_loses_no_double_count(self):
        slow = _start_replica(delay=0.4)
        fast = _start_replica()
        registry = MetricsRegistry()
        router = RouterServer(
            [f"localhost:{slow.port}", f"localhost:{fast.port}"], port=0,
            metrics_registry=registry, hedge_min_ms=20, hedge_max_ms=40,
            replica_timeout=5.0).start()
        try:
            t0 = time.monotonic()
            statuses = [_predict_via(router.port)[0] for _ in range(6)]
            elapsed = time.monotonic() - t0
            assert statuses == [200] * 6
            assert elapsed < 2.4, elapsed
            snap = _snap(registry)
            assert _series_value(snap, "edl_tpu_router_requests_total",
                                 code="200") == 6.0
            assert _series_value(snap, "edl_tpu_router_hedges_total",
                                 event="fired") >= 1.0
            assert _series_value(snap, "edl_tpu_router_hedges_total",
                                 event="won") >= 1.0
        finally:
            router.stop()
            slow.stop()
            fast.stop()

    def test_router_passthrough_models_endpoint(self):
        replica = _start_replica()
        router = RouterServer([f"localhost:{replica.port}"], port=0,
                              metrics_registry=MetricsRegistry()).start()
        try:
            assert json.loads(_get(router.port, "/v1/models"))[
                "current"] == 1
        finally:
            router.stop()
            replica.stop()

    def test_router_capacity_shed_with_retry_after(self):
        replica = _start_replica()
        router = RouterServer([f"localhost:{replica.port}"], port=0,
                              metrics_registry=MetricsRegistry(),
                              replica_concurrency=1, hedge=False).start()
        try:
            core = router.core
            with core._lock:
                core._inflight_requests = 1  # a parked route
            conn = http.client.HTTPConnection("localhost", router.port,
                                              timeout=5)
            conn.request("POST", "/v1/predict", body=tensor_utils.dumps(
                {"features": np.ones((1, FEATURE_DIM), np.float32)}),
                headers={"Content-Type": "application/x-msgpack"})
            resp = conn.getresponse()
            resp.read()
            assert resp.status == 429
            assert int(resp.getheader("Retry-After")) >= 1
            assert resp.getheader("X-Shed-Tier") == "capacity"
            with core._lock:
                core._inflight_requests = 0
        finally:
            router.stop()
            replica.stop()

    def test_master_reporter_is_not_ported(self):
        with pytest.raises(NotImplementedError, match="item 8"):
            RouterServer(["localhost:1"], port=0, master_addr="m:1",
                         metrics_registry=MetricsRegistry())


class TestRouterDrain:
    def test_drain_settles_inflight_and_refuses_new(self):
        slow = _start_replica(delay=0.3)
        router = RouterServer([f"localhost:{slow.port}"], port=0,
                              metrics_registry=MetricsRegistry(),
                              hedge=False).start()
        port = router.port
        results = {}
        thread = threading.Thread(target=lambda: results.update(
            inflight=_predict_via(port, timeout=10)))
        thread.start()
        deadline = time.monotonic() + 5
        while router.core._inflight_requests == 0:
            assert time.monotonic() < deadline, "request never started"
            time.sleep(0.005)
        assert router.drain(grace=10.0) is True
        thread.join(timeout=10)
        assert results["inflight"][0] == 200
        with pytest.raises(Exception):
            _predict_via(port, timeout=2)
        slow.stop()

    def test_drain_while_idle_is_clean(self):
        replica = _start_replica()
        router = RouterServer([f"localhost:{replica.port}"], port=0,
                              metrics_registry=MetricsRegistry()).start()
        assert router.drain(grace=2.0) is True
        replica.stop()


@pytest.mark.parametrize("argv", [
    ["--replicas", "localhost:1", "--master_addr", "m:1"],
    ["--replicas", "localhost:1", "--profile_hz", "50"],
    ["--replicas", "localhost:1", "--router_id", "3"],
])
def test_route_flags_of_unported_parts_raise(argv):
    from elasticdl_tpu_torch.serving.router import main

    with pytest.raises(NotImplementedError, match="item 8"):
        main(argv)


@pytest.mark.parametrize("flag,value", [
    ("--master_addr", "m:1"), ("--metrics_report_secs", "5"),
    ("--profile_window_secs", "2"), ("--replica_id", "1"),
])
def test_serve_flags_of_unported_parts_raise(tmp_path, flag, value):
    from elasticdl_tpu_torch.serving.server import main

    with pytest.raises(NotImplementedError, match="item 8"):
        main(["--model_dir", str(tmp_path), "--device", "cpu", flag, value])
