"""The port's time-series store and SLO engine
(``elasticdl_tpu_torch/observability/{timeseries,slo}.py``) held to the
JAX package's on the CPU, under fake clocks and with no sleeps.

One scripted stream of snapshots (counters, gauges, histograms, stale
fingerprints, a counter reset, a bucket change, cold-tier flushes) goes
into both stores and gives equal ``render()`` bodies and window
reductions; burn-rate, threshold, absence and counter-pair rules move
through the same states; ``load_rules`` accepts and refuses alike;
``default_rules`` is equal; each package's ``check_incident`` accepts
both packages' ``IncidentRecorder`` bundles; ``/timeseries`` and
``/alerts`` answer over HTTP; the autoscaler's ``timeseries=`` signal
decides as JAX's; the master's ``--timeseries_secs``, ``--slo_rules``
and ``--incident_dir`` wire the plane with the journal's tail in the
bundle; and the counterparts of tests/test_probe.py:226, :271 and
tests/test_stream.py:487 run on the port's prober and rules.
"""

import json
import os
import pathlib
import sys
import time
import urllib.request
from types import SimpleNamespace

import pytest

from elasticdl_tpu.master import autoscaler as jauto
from elasticdl_tpu.observability import aggregator as jagg
from elasticdl_tpu.observability import registry as jreg
from elasticdl_tpu.observability import slo as jslo
from elasticdl_tpu.observability import timeseries as jts
from elasticdl_tpu.observability import tracing as jtracing
from elasticdl_tpu_torch.master import autoscaler as pauto
from elasticdl_tpu_torch.observability import aggregator as pagg
from elasticdl_tpu_torch.observability import registry as preg
from elasticdl_tpu_torch.observability import slo as pslo
from elasticdl_tpu_torch.observability import timeseries as pts
from elasticdl_tpu_torch.observability import tracing as ptracing
from elasticdl_tpu_torch.tools import check_incident as pcheck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools import check_incident as jcheck  # noqa: E402

PKGS = {
    "jax": SimpleNamespace(ts=jts, slo=jslo, reg=jreg, agg=jagg,
                           auto=jauto, tracing=jtracing),
    "port": SimpleNamespace(ts=pts, slo=pslo, reg=preg, agg=pagg,
                            auto=pauto, tracing=ptracing),
}


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, secs):
        self.t += secs
        return self.t


def _script():
    """[(advance secs, {source: (snapshot, fingerprint)})]: a master
    registry, two workers (one goes silent), a counter reset, a bucket
    change, 150 s of 5 s samples (cold flushes at 60 s)."""
    master, w0, w1 = (jreg.MetricsRegistry() for _ in range(3))
    q = master.gauge("master_task_queue_depth", "h")
    pushes = master.counter("pushes_total", "h", ["shard"])
    steps = {w: w.histogram("worker_step_seconds", "h",
                            buckets=(0.01, 0.1, 1.0)) for w in (w0, w1)}
    util = {w: w.gauge("worker_step_utilization", "h") for w in (w0, w1)}
    out = []
    for i in range(30):
        q.set(30 - i)
        pushes.labels("0").inc(3 + i % 4)
        pushes.labels("1").inc(i % 2)
        for k, w in enumerate((w0, w1)):
            for j in range(1 + (i + k) % 3):
                steps[w].observe(0.004 * (1 + j) * (1 + i % 7))
            util[w].set(0.1 * ((i + k) % 10))
        sources = {"": (master.snapshot(), None),
                   "0": (w0.snapshot(), i)}
        # Worker 1 goes silent at step 12: its last snapshot lingers
        # with an unchanged fingerprint.
        sources["1"] = (w1.snapshot(), min(i, 12))
        if i == 18:
            # A restarted worker 0: counters and histograms reset.
            w0 = jreg.MetricsRegistry()
            steps[w0] = w0.histogram("worker_step_seconds", "h",
                                     buckets=(0.01, 0.1, 0.5, 1.0))
            util[w0] = w0.gauge("worker_step_utilization", "h")
        out.append((5.0, sources))
    return out


def _store_readings(mod, clock, script):
    store = mod.ts.TimeSeriesStore(cadence_secs=5.0, clock=clock,
                                   cold_resolution_secs=60.0)
    updated = []
    for step, sources in script:
        clock.advance(step)
        updated.append(store.sample(sources))
    now = clock()
    fam = "edl_tpu_worker_step_seconds"
    return {
        "updated": updated,
        "hot": store.render(),
        "cold": store.render(tier="cold"),
        "prefix": store.render(name="edl_tpu_pushes", window_secs=40.0),
        "names": store.series_names(),
        "q": [store.window_quantile(fam, w, q, now=now)
              for w in (10.0, 60.0, 600.0) for q in (0.5, 0.9, 0.99)],
        "q1": store.window_quantile(fam, 600.0, 0.99, source="1"),
        "hist": store.window_hist(fam, 600.0),
        "delta": [store.window_counter_delta(
            "edl_tpu_pushes_total", w, labels=lab)
            for w in (15.0, 600.0) for lab in (None, {"shard": "1"})],
        "gauges": store.gauge_values("edl_tpu_worker_step_utilization",
                                     90.0),
        "seen": store.last_seen("edl_tpu_worker_step_utilization"),
        "dropped": store.drop_source("1"),
        "after": store.series_names(),
    }


def test_scripted_stream_renders_equal():
    script = _script()
    got = _store_readings(PKGS["port"], FakeClock(), script)
    want = _store_readings(PKGS["jax"], FakeClock(), script)
    assert got == want
    assert got["cold"]["series"] and got["q"][-1][0] > 0


@pytest.mark.parametrize("case", [
    ((0.01, 0.1, 1.0), [0, 0, 0], 0.5, None),
    ((0.01, 0.1, 1.0), [3, 1, 0], 0.5, None),
    ((0.01, 0.1, 1.0), [3, 1, 1], 0.99, None),
    ((0.01, 0.1, 1.0), [3, 1, 1], 0.99, 50.0),
    ((0.5, 120.0), [0, 0], 0.99, 7.0),
    ((), [], 0.5, 3.0),
])
def test_quantile_from_buckets_equal(case):
    assert pts.quantile_from_buckets(*case) == \
        jts.quantile_from_buckets(*case)


def _burn_rule(mod, **kw):
    base = dict(name="latency-burn", kind="burn_rate",
                series="edl_tpu_lat_seconds", latency_threshold=0.05,
                objective=0.95, long_window_secs=60.0,
                short_window_secs=15.0, burn_rate_threshold=3.0,
                min_count=5)
    base.update(kw)
    return mod.slo.SLORule(**base)


def _rule_walk(mod, kind):
    """Drive one rule kind through firing and back; the engine's render
    and the alert gauge after every evaluation."""
    clock = FakeClock()
    store = mod.ts.TimeSeriesStore(cadence_secs=5.0, clock=clock)
    reg = mod.reg.MetricsRegistry()
    if kind == "burn":
        rules = [_burn_rule(mod)]
        h = reg.histogram("lat_seconds", "h")
        phases = [(3, 0.001), (3, 0.5), (14, 0.001)]
    elif kind == "pair":
        rules = [mod.slo.SLORule(
            name="error-burn", kind="burn_rate",
            series="edl_tpu_requests_total",
            bad_series="edl_tpu_errors_total", objective=0.99,
            long_window_secs=60.0, short_window_secs=15.0,
            burn_rate_threshold=4.0, min_count=10)]
        total = reg.counter("requests_total", "h")
        bad = reg.counter("errors_total", "h")
        phases = [(3, 0), (4, 10), (14, 0)]
    elif kind == "threshold":
        rules = [mod.slo.SLORule(
            name=f"t-{agg}", kind="threshold",
            series=("edl_tpu_queue" if agg in ("last", "max", "min")
                    else "edl_tpu_step_seconds"),
            aggregation=agg, op=op, value=v, window_secs=30.0)
            for agg, op, v in (("last", ">", 10.0), ("max", ">=", 40.0),
                               ("min", "<", 5.0), ("p99", ">", 0.5),
                               ("p50", "<=", 0.1), ("mean", ">", 0.2),
                               ("rate", ">", 0.5), ("p90", ">", 1.0))]
        g = reg.gauge("queue", "h")
        h = reg.histogram("step_seconds", "h")
        phases = [(4, 50.0), (4, 2.0), (8, 20.0)]
    else:
        rules = [mod.slo.SLORule(
            name="gone", kind="absence",
            series="edl_tpu_worker_step_utilization",
            staleness_secs=30.0, forget_secs=120.0)]
        reg.gauge("worker_step_utilization", "h").set(0.8)
        phases = [(3, True), (8, False), (30, False)]
    engine = mod.slo.SLOEngine(store, rules=rules, metrics_registry=reg,
                               clock=clock)
    trail = []
    fingerprint = 0
    for ticks, value in phases:
        for _ in range(ticks):
            if kind == "burn":
                for _ in range(5):
                    h.observe(value)
                store.sample({"": (reg.snapshot(), None)})
            elif kind == "pair":
                total.inc(100)
                bad.inc(value)
                store.sample({"": (reg.snapshot(), None)})
            elif kind == "threshold":
                g.set(value)
                h.observe(value / 40.0)
                store.sample({"": (reg.snapshot(), None)})
            else:
                fingerprint += int(value)
                store.sample({"7": (reg.snapshot(), fingerprint)})
            clock.advance(5)
            engine.evaluate()
            trail.append(engine.render())
    active = [s for f in reg.snapshot()["families"]
              if f["name"] == "edl_tpu_alert_active" for s in f["series"]]
    return trail, active


@pytest.mark.parametrize("kind", ["burn", "threshold", "absence", "pair"])
def test_rules_move_through_the_same_states(kind):
    got, got_active = _rule_walk(PKGS["port"], kind)
    want, want_active = _rule_walk(PKGS["jax"], kind)
    assert got == want
    assert got_active == want_active
    fired = [r for body in got for r in body["firing"]]
    assert fired, "the walk must fire"
    if kind != "threshold":
        assert got[-1]["firing"] == [], "and clear"


_RULE_FILES = {
    "defaults": {"rules": "DEFAULTS"},
    "bare-list": [{"name": "q", "kind": "threshold", "series": "s",
                   "aggregation": "last", "value": 1.0}],
    "unknown-field": [{"name": "x", "kind": "threshold", "series": "s",
                       "thresold_value": 3}],
    "bad-kind": [{"name": "x", "kind": "ratio", "series": "s"}],
    "bad-objective": [{"name": "x", "kind": "burn_rate", "series": "s",
                       "objective": 1.0, "latency_threshold": 1.0}],
    "no-sli": [{"name": "x", "kind": "burn_rate", "series": "s"}],
    "windows": [{"name": "x", "kind": "burn_rate", "series": "s",
                 "bad_series": "b", "short_window_secs": 600.0}],
    "bad-agg": [{"name": "x", "kind": "threshold", "series": "s",
                 "aggregation": "p42"}],
    "bad-op": [{"name": "x", "kind": "threshold", "series": "s",
                "op": "=="}],
    "inverted-forget": [{"name": "x", "kind": "absence", "series": "s",
                         "staleness_secs": 60.0, "forget_secs": 30.0}],
}


def _load(mod, path):
    try:
        return [r.to_dict() for r in mod.slo.load_rules(path)]
    except Exception as exc:
        return (type(exc).__name__, str(exc))


@pytest.mark.parametrize("name", sorted(_RULE_FILES))
def test_load_rules_behaves_alike(tmp_path, name):
    body = _RULE_FILES[name]
    if body == {"rules": "DEFAULTS"}:
        body = {"rules": [r.to_dict() for r in jslo.default_rules()]}
    path = tmp_path / "rules.json"
    path.write_text(json.dumps(body))
    got, want = _load(PKGS["port"], str(path)), _load(PKGS["jax"],
                                                      str(path))
    assert got == want
    assert isinstance(got, list) == (name in ("defaults", "bare-list"))


def test_default_rules_equal():
    got = [r.to_dict() for r in pslo.default_rules()]
    assert got == [r.to_dict() for r in jslo.default_rules()]
    names = {r["name"] for r in got}
    assert {"probe-failure-burn", "stream-watermark-stall",
            "row-push-log-fsync-stall", "primary-heartbeat-absent",
            "worker-absent"} <= names


def _bundle(mod, out_dir):
    """One IncidentRecorder bundle from a firing burn rule, with spans,
    a series window, a journal tail and a profile window."""
    clock = FakeClock()
    reg = mod.reg.MetricsRegistry()
    plane = mod.agg.MetricsPlane(registry=reg)
    store = plane.enable_timeseries(cadence_secs=0.0)
    store._clock = clock
    h = reg.histogram("lat_seconds", "h")
    h.observe(0.5)
    store.sample({"": (reg.snapshot(), None)}, now=clock())
    clock.advance(5)
    h.observe(0.7)
    store.sample({"": (reg.snapshot(), None)}, now=clock())
    tracing = mod.tracing
    ring = tracing.FlightRecorder(64)
    tracing.install_recorder(ring)
    try:
        with tracing.Tracer("worker", "0").span("task"):
            with tracing.span("device_step"):
                pass
    finally:
        tracing.uninstall_recorder()
    plane.traces.ingest(ring.snapshot())
    # The profile store reads the wall clock.
    window = {"seq": 1, "t0": time.time() - 2.0, "t1": time.time() - 1.0,
              "hz": 10.0, "sample_count": 2, "role": "worker",
              "instance": "0", "threads": {"MainThread": 1},
              "samples": {"MainThread;train;step": 2}}
    plane.profiles.ingest("0", [window])
    recorder = mod.slo.IncidentRecorder(
        out_dir, metrics_plane=plane, store=store,
        journal_tail_fn=lambda: [{"t": "dispatch", "seq": 1}],
        background=False, clock=clock)
    engine = mod.slo.SLOEngine(
        store, rules=[_burn_rule(mod, min_count=1)],
        metrics_registry=reg, incident_recorder=recorder, clock=clock)
    assert engine.evaluate()[0]["firing"] is True
    assert recorder.capture(engine.alert_state("latency-burn")) is None
    (bundle,) = recorder.bundles
    return bundle


def test_each_check_incident_accepts_both_bundles(tmp_path):
    for name, mod in PKGS.items():
        bundle = _bundle(mod, str(tmp_path / name))
        assert pcheck.newest_bundle(str(tmp_path / name)) == bundle
        for checker in (pcheck, jcheck):
            assert checker.check_incident(bundle,
                                          require_profile=True) == []
        with open(os.path.join(bundle, "journal_tail.json")) as fh:
            assert json.load(fh)["records"][0]["t"] == "dispatch"
    port, ref = (sorted(os.listdir(next(pathlib.Path(
        tmp_path, n).iterdir()))) for n in ("port", "jax"))
    assert port == ref


def _http_json(port, path):
    with urllib.request.urlopen(f"http://localhost:{port}{path}",
                                timeout=10) as resp:
        return json.loads(resp.read())


def test_timeseries_and_alerts_over_http():
    bodies = {}
    for name, mod in PKGS.items():
        reg = mod.reg.MetricsRegistry()
        plane = mod.agg.MetricsPlane(registry=reg)
        plane.enable_timeseries(cadence_secs=5.0)
        plane.enable_slo(rules=[mod.slo.SLORule(
            name="q", kind="threshold", series="edl_tpu_queue",
            aggregation="last", op=">", value=1.0, window_secs=600.0)])
        reg.gauge("queue", "h").set(5)
        server = plane.serve(port=0)
        try:
            now = 1000.0
            plane.slo_tick(now)
            assert plane.slo_tick(now + 1.0) is None  # not due
            plane.slo.evaluate(now + 5.0)
            plane.slo_tick(now + 5.0)
            ts = _http_json(server.port,
                            "/timeseries?name=edl_tpu_queue&window=1e9")
            alerts = _http_json(server.port, "/alerts")
            with pytest.raises(urllib.error.HTTPError):
                _http_json(server.port, "/nope")
        finally:
            plane.stop()
        assert alerts["firing"] == ["q"]
        for body in (ts, alerts):
            body.pop("now", None)
        for state in alerts["rules"]:
            state.pop("last_eval", None)
        bodies[name] = (ts, alerts)
    assert bodies["port"] == bodies["jax"]
    off = pagg.MetricsPlane(registry=preg.MetricsRegistry())
    routes = off._json_routes()
    assert "disabled" in routes["/timeseries"]({})["error"]
    assert routes["/alerts"]({})["firing"] == []


def _decisions(mod):
    clock = FakeClock()
    store = mod.ts.TimeSeriesStore(cadence_secs=5.0, clock=clock)
    worker = mod.reg.MetricsRegistry()
    util = worker.gauge("worker_step_utilization", "h")
    plane = mod.agg.MetricsPlane(registry=mod.reg.MetricsRegistry(),
                                 ttl_secs=600.0)
    queue = {"depth": 0}

    class Dispatcher:
        def queue_depths(self):
            return queue["depth"], 1

    class Servicer:
        def resize_status(self):
            return None

    signals = mod.auto.master_signals(
        Dispatcher(), Servicer(), plane, lambda: 2, with_traces=False,
        timeseries=store, trend_window_secs=30.0)
    policy = mod.auto.AutoscalePolicy(
        min_workers=1, max_workers=4, hysteresis_ticks=2,
        cooldown_secs=10.0)
    actions = []
    scaler = mod.auto.Autoscaler(
        policy, signals, lambda s: actions.append("up"),
        lambda s: actions.append("down"),
        metrics_registry=mod.reg.MetricsRegistry(), clock=clock)
    out = []
    for i, (value, depth) in enumerate(
            [(0.9, 20)] * 6 + [(0.1, 0)] * 10 + [(0.95, 30)] * 6):
        util.set(value if i % 3 else value / 2)
        plane.ingest(0, worker.snapshot())  # the instantaneous view
        store.sample({"0": (worker.snapshot(), i)})
        queue["depth"] = depth
        out.append((scaler.tick(), signals().step_utilization,
                    mod.auto.utilization_from_timeseries(store, 30.0)))
        clock.advance(5)
    return out, actions


def test_autoscaler_timeseries_decisions_equal():
    got, got_actions = _decisions(PKGS["port"])
    want, want_actions = _decisions(PKGS["jax"])
    assert got == want and got_actions == want_actions
    assert "up" in got_actions and "down" in got_actions


def test_master_flags_wire_the_slo_plane(tmp_path):
    """``--timeseries_secs``, ``--slo_rules`` and ``--incident_dir``
    as JAX's master wires them: the store samples on the run tick, a
    file rule fires on the master's queue gauge, and the bundle carries
    the journal's tail and passes both checkers."""
    from elasticdl_tpu_torch.common.args import parse_master_args
    from elasticdl_tpu_torch.master.main import Master
    from elasticdl_tpu_torch.testing import data as tdata

    train = tdata.create_mnist_record_file(str(tmp_path / "t.rec"), 64,
                                           seed=1)
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps({"rules": [{
        "name": "queued", "kind": "threshold",
        "series": "edl_tpu_master_task_queue_depth",
        "aggregation": "last", "op": ">", "value": 0.5,
        "window_secs": 60.0}]}))
    flags = ["--model_zoo", tdata.model_zoo_dir(), "--model_def",
             "mnist.mnist_functional.custom_model", "--training_data",
             train, "--minibatch_size", "16", "--master_addr",
             "localhost:0", "--journal_dir", str(tmp_path / "j"),
             "--timeseries_secs", "0.5", "--slo_rules", str(rules),
             "--incident_dir", str(tmp_path / "inc")]
    master = Master(parse_master_args(flags))
    try:
        plane = master.metrics_plane
        assert plane.timeseries.cadence_secs == 0.5
        assert [r.name for r in plane.slo.rules] == ["queued"]
        plane.slo_tick(now=1000.0)
        plane.slo_tick(now=1001.0)
        assert plane.slo.firing() == ["queued"]
        plane.slo.incident_recorder.flush()
        (bundle,) = plane.slo.incident_recorder.bundles
        for checker in (pcheck, jcheck):
            assert checker.check_incident(bundle) == []
        with open(os.path.join(bundle, "journal_tail.json")) as fh:
            assert json.load(fh)["records"]
    finally:
        master.stop()
    off = Master(parse_master_args(
        [f for f in flags if f not in ("--journal_dir",
                                       str(tmp_path / "j"))]
        + ["--timeseries_secs", "0"]))
    try:
        assert off.metrics_plane.timeseries is None
        assert off.metrics_plane.slo is None
    finally:
        off.stop()


# ---- counterparts of tests/test_probe.py:226, :271, test_stream.py:487 --


def test_probe_failure_burn_rule_fires_on_failing_probe():
    from elasticdl_tpu_torch.observability.prober import (
        ProbeFailure,
        ProbeScheduler,
    )

    rule = next(
        r for r in pslo.default_rules() if r.name == "probe-failure-burn"
    )
    assert rule.series == "edl_tpu_probe_attempts_total"
    assert rule.bad_series == "edl_tpu_probe_failures_total"
    clock = FakeClock()
    store = pts.TimeSeriesStore(cadence_secs=5.0, clock=clock)
    reg = preg.MetricsRegistry()
    sched = ProbeScheduler(registry=reg, unhealthy_after=2, clock=clock)
    verdicts = {"fail": False}

    def probe():
        if verdicts["fail"]:
            raise ProbeFailure("stale", "stuck")

    sched.register("canary", probe, interval_secs=0)
    engine = pslo.SLOEngine(store, rules=[rule], metrics_registry=reg,
                            clock=clock)

    def sample(runs=2):
        for _ in range(runs):
            sched.run_once("canary", now=clock())
        store.sample({"": (reg.snapshot(), None)}, now=clock())
        clock.advance(10)

    for _ in range(8):
        sample()
    assert engine.evaluate()[0]["firing"] is False
    # Every probe run failing = 100x the 1% budget: both windows burn.
    verdicts["fail"] = True
    for _ in range(8):
        sample()
    state = engine.evaluate()[0]
    assert state["firing"] is True
    assert engine.firing() == ["probe-failure-burn"]


def test_red_transition_captures_one_bundle_with_trace_id(tmp_path):
    from elasticdl_tpu_torch.observability.prober import (
        ProbeFailure,
        ProbeScheduler,
    )

    recorder = pslo.IncidentRecorder(str(tmp_path), background=False)
    ptracing.install_recorder(ptracing.FlightRecorder(64))
    try:
        sched = ProbeScheduler(
            registry=preg.MetricsRegistry(),
            incident_recorder=recorder, unhealthy_after=2,
        )
        sched.register(
            "dying",
            lambda: (_ for _ in ()).throw(
                ProbeFailure("rpc_error", "shard down")
            ),
            interval_secs=0, description="row tier RYW",
        )
        sched.run_once("dying")
        assert recorder.bundles == []
        sched.run_once("dying")  # red transition
        assert len(recorder.bundles) == 1
        with open(
            pathlib.Path(recorder.bundles[0]) / "alert.json"
        ) as fh:
            alert = json.load(fh)["alert"]
        assert alert["rule"] == "probe-dying"
        assert alert["probe"] == "dying"
        assert alert["reason"] == "rpc_error"
        # The bundle carries the failing RUN's trace id.
        assert alert["trace_id"]
        # Staying red captures nothing more: one bundle per outage.
        sched.run_once("dying")  # still red: no second bundle
        assert len(recorder.bundles) == 1
    finally:
        ptracing.uninstall_recorder()


def test_default_rules_include_watermark_stall():
    rules = {r.name: r for r in pslo.default_rules()}
    rule = rules["stream-watermark-stall"]
    assert rule.series == "edl_tpu_stream_ingest_watermark_lag_seconds"
    assert rule.aggregation == "max"
