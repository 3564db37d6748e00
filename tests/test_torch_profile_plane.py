"""The port's profiling and trace-export plane held to the JAX package's
on the CPU: ``observability/profiler.py`` (the fold, merge, diff, pprof
and ``top_frames`` functions and ``ProfileStore``), ``reporter.py``,
``utils/profiler.py`` and ``trace_export.py``.

The pure functions and the store's renders equal JAX's on the same
inputs; windows flow from a worker to the master through a snapshot and
from a component through the reporter, whose ``report_metrics``
requests equal JAX's against a recording servicer; the step-window
``Profiler`` with a fake backend starts and stops at JAX's steps over
the same sequences (a rewind, an early stop); on the CPU the
``torch.profiler`` backend writes a Chrome trace naming ``train_step``;
``chrome_trace`` of the same spans is equal JSON, and the ``trace``
command's output passes both packages' ``check_trace``. Fake clocks,
no sleeps, no wall-clock gates.
"""

import glob
import json
import os
import sys
import time
import urllib.request

import pytest

from elasticdl_tpu.observability import profiler as jprof
from elasticdl_tpu.observability import registry as jreg
from elasticdl_tpu.observability import reporter as jrep
from elasticdl_tpu.observability import trace_export as jtx
from elasticdl_tpu.observability import tracing as jtracing
from elasticdl_tpu.utils import profiler as jutil
from elasticdl_tpu_torch.comm.rpc import RpcServer
from elasticdl_tpu_torch.observability import profiler as pprof
from elasticdl_tpu_torch.observability import registry as preg
from elasticdl_tpu_torch.observability import reporter as prep
from elasticdl_tpu_torch.observability import trace_export as ptx
from elasticdl_tpu_torch.observability import tracing as ptracing
from elasticdl_tpu_torch.tools import check_profile as pcheck_profile
from elasticdl_tpu_torch.tools import check_trace as pcheck_trace
from elasticdl_tpu_torch.utils import profiler as putil

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools import check_profile as jcheck_profile  # noqa: E402
from tools import check_trace as jcheck_trace  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_seams():
    yield
    for prof_mod, tracing_mod in ((pprof, ptracing), (jprof, jtracing)):
        prof_mod.uninstall_profiler()
        tracing_mod.uninstall_recorder()


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, secs):
        self.t += secs
        return self.t


def _window(samples, passes=50, t0=0.0, t1=5.0, hz=10.0, seq=1,
            threads=None):
    return {"seq": seq, "t0": t0, "t1": t1, "hz": hz, "role": "worker",
            "instance": "3", "sample_count": passes,
            "threads": dict(threads or {"main": 1, "pool": 2}),
            "samples": samples, "dropped": 0}


W1 = _window({"main;a.f;a.g": 30, "main;a.f": 20, "pool;b.h": 7},
             t0=0.0, t1=10.0)
W2 = _window({"main;a.f": 35, "pool;b.h;b.i": 12, "pool;b.h": 1},
             t0=10.0, t1=20.0, seq=2, threads={"main": 1, "pool": 3})
SPANS = [
    {"span_id": "p", "parent_id": None, "name": "task", "role": "worker",
     "instance": "3", "dur": 1.0, "t0": 12.0, "trace_id": "t1",
     "tid": 5, "attrs": {"task_id": 4}},
    {"span_id": "c", "parent_id": "p", "name": "device_step",
     "role": "worker", "instance": "3", "dur": 0.6, "t0": 12.1,
     "trace_id": "t1", "tid": 5, "attrs": {"kind": "train"}},
    {"span_id": "m", "parent_id": None, "name": "dispatch",
     "role": "master", "instance": "0", "dur": 0.01, "t0": 11.9,
     "trace_id": "t1", "tid": 1, "attrs": {}},
    {"span_id": "r", "parent_id": "c", "name": "row_pull",
     "role": "rowservice", "instance": "1", "dur": 0.2, "t0": 12.2,
     "trace_id": "t1", "tid": 9, "attrs": {"rows": 12}},
]


@pytest.mark.parametrize("fn", [
    "folded_text", "pprof_json", "merge_windows", "diff_profiles",
    "top_frames", "fold_spans", "component_role", "thread_class",
])
def test_profile_functions_equal(fn):
    calls = {
        "folded_text": [(W1["samples"],), (W2["samples"],), ({},)],
        "pprof_json": [(W1,), (W2,)],
        "merge_windows": [([W1, W2],), ([W2],), ([],)],
        "diff_profiles": [(W2, W1), (W1, W2, 2)],
        "top_frames": [(W1["samples"],), (W2["samples"], 2)],
        "fold_spans": [(SPANS, 10.0), (SPANS, 10.0, "worker", "3"),
                       (SPANS, 67.0, "master")],
        "component_role": [(c,) for c in ("", "3", "rowservice-1",
                                          "serving-2", "router-0")],
        "thread_class": [(n,) for n in (
            "MainThread", "ThreadPoolExecutor-0_3", "Thread-4 (busy)",
            "rowservice-metrics-report", "incident-writer", "Dummy-2",
            "table-fanout_1", "worker-prefetch")],
    }[fn]
    for args in calls:
        assert getattr(pprof, fn)(*args) == getattr(jprof, fn)(*args)


def _store_renders(mod):
    store = mod.ProfileStore(max_windows_per_source=4)
    out = [store.ingest("3", [W1, W2]), store.ingest("3", [W1]),
           store.ingest("rowservice-1", [dict(W1, role="rowservice",
                                              instance="1")])]
    out.append(store.components())
    out.append(store.merged("3", window_secs=50.0, now=25.0))
    out.append(store.merged("3", window_secs=8.0, now=25.0))
    out.append(store.render("3", window_secs=10.0, base_secs=10.0,
                            spans=SPANS, now=20.0))
    out.append(store.render("nope", window_secs=10.0, now=20.0))
    out.append(store.bundle_capture(window_secs=100.0, now=20.0))
    store.drop_source("3")
    out.append(store.components())
    return out


def test_profile_store_renders_equal():
    got, want = _store_renders(pprof), _store_renders(jprof)
    assert got == want
    render, bundle = got[6], got[8]
    for check in (pcheck_profile, jcheck_profile):
        assert check.check_profile_payload(render) == []
        assert check.check_bundle_profile(bundle) == []


def _rotations(mod):
    clock = FakeClock()
    prof = mod.SamplingProfiler(hz=10.0, window_secs=10.0, clock=clock,
                                role="test", instance="7")
    out = []
    for step in (1.0, 1.0, 1.0, 1.0, 7.0, 1.0, 12.0):
        prof.sample()
        clock.advance(step)
        windows, cursor = prof.windows_since(0)
        out.append((cursor, [(w["seq"], w["t0"], w["t1"],
                              w["sample_count"], w["role"], w["instance"],
                              w["hz"]) for w in windows]))
    prof.close_window()
    out.append(prof.windows_since(out[-1][0])[1])
    return out


def test_window_rotation_equal_under_a_fake_clock():
    assert _rotations(pprof) == _rotations(jprof)


def test_worker_snapshot_carries_windows_to_the_master(tmp_path):
    """A worker's closed profile windows ride its metrics snapshot into
    the master's ``ProfileStore`` (JAX ``worker/worker.py:352``) and
    serve on ``/profile``."""
    from elasticdl_tpu_torch.testing.cluster import MiniCluster
    from elasticdl_tpu_torch.testing.data import (
        create_mnist_record_file,
        model_zoo_dir,
    )

    clock = FakeClock(t=time.time() - 30.0)
    prof = pprof.install_profiler(pprof.SamplingProfiler(
        hz=10.0, window_secs=10.0, clock=clock, role="worker",
        instance="0"))
    prof.sample()
    clock.advance(11.0)
    prof.sample()  # closes window 1
    (closed,), _ = prof.windows_since(0)
    train = create_mnist_record_file(str(tmp_path / "t.rec"), 32, seed=3)
    cluster = MiniCluster(
        model_zoo=model_zoo_dir(),
        model_def="mnist.mnist_functional.custom_model",
        training_data=train, minibatch_size=16, device="cpu",
        metrics_port=0)
    try:
        cluster.run()
        assert cluster.finished
        plane = cluster.metrics_plane
        assert [c["component"] for c in plane.profiles.components()] \
            == ["0"]
        merged = plane.profiles.merged("0", window_secs=1e6)
        assert merged["samples"] == closed["samples"]
        base = f"http://localhost:{plane.http_port}"
        with urllib.request.urlopen(
                f"{base}/profile?component=0&window=1e6") as resp:
            body = json.loads(resp.read())
        assert pcheck_profile.check_profile_payload(body) == []
        assert cluster.workers[0]._profile_cursor == 1
    finally:
        cluster.stop()


def _reporter_requests(prof_mod, tracing_mod, rep_mod, reg_mod, port):
    """Two reports of one component: the requests the servicer saw
    (span ids and sample stacks left out)."""
    tracing_mod.install_recorder(tracing_mod.FlightRecorder(64))
    tracing_mod.set_process_role("rowservice", "0")
    with tracing_mod.span("row_push"):
        pass
    clock = FakeClock()
    prof = prof_mod.install_profiler(prof_mod.SamplingProfiler(
        hz=10.0, window_secs=10.0, clock=clock, role="rowservice",
        instance="0"))
    prof.sample()
    clock.advance(11.0)
    prof.sample()  # closes window 1
    registry = reg_mod.MetricsRegistry()
    registry.counter("row_pushes_total", "h", ["table"]).labels("t").inc(3)
    registry.gauge("row_rows", "h").set(7)
    reporter = rep_mod.ComponentMetricsReporter(
        f"localhost:{port}", "rowservice", 2, registry=registry,
        interval_secs=5.0)
    reporter.send_once()
    clock.advance(11.0)
    prof.sample()  # closes window 2
    reporter.send_once()
    return reporter.reports_sent, reporter._profile_cursor


def _normalise(request):
    metrics = dict(request["metrics"])
    # The recording server is the port's: its server spans land in the
    # port's ring only.
    spans = [(s["name"], s["role"], s["instance"], s["parent_id"])
             for s in metrics.pop("spans", [])
             if not s["name"].startswith("serve/")]
    # The stacks and thread classes are the live process's own.
    profiles = [{k: v for k, v in w.items()
                 if k not in ("samples", "threads")}
                for w in metrics.pop("profiles", [])]
    return (request["component"], request["component_id"],
            sorted(metrics), metrics["families"], spans, profiles)


def test_reporter_requests_equal_jax():
    seen = []

    def report_metrics(request):
        seen.append(request)
        return {"accepted": True}

    server = RpcServer("localhost:0", {
        "elasticdl_tpu.Master": {"report_metrics": report_metrics},
    }).start()
    try:
        outcomes = {}
        for name, mods in (("port", (pprof, ptracing, prep, preg)),
                           ("jax", (jprof, jtracing, jrep, jreg))):
            seen.clear()
            outcomes[name] = (_reporter_requests(*mods, server.port),
                              [_normalise(r) for r in seen])
            mods[0].uninstall_profiler()
            mods[1].uninstall_recorder()
    finally:
        server.stop(0)
    assert outcomes["port"] == outcomes["jax"]
    (sent, cursor), requests = outcomes["port"]
    assert (sent, cursor) == (2, 2)
    # The first carried the span and window 1, the second window 2 only.
    # The second also carries the first report's client span.
    assert [[s[0] for s in r[4]] for r in requests] == [
        ["row_push"], ["rpc/report_metrics"]]
    assert [[w["seq"] for w in r[5]] for r in requests] == [[1], [2]]


class _FakeBackend:
    def __init__(self):
        self.calls = []

    def start_trace(self, logdir):
        self.calls.append(("start", logdir))

    def stop_trace(self):
        self.calls.append(("stop",))


@pytest.mark.parametrize("case", [
    (2, 3, list(range(10)), False),        # the window, then done
    (0, 1, [0, 1, 2], False),              # a window of one step
    (5, 3, [5, 3, 4, 6, 7, 8, 9], False),  # a rewind mid-window
    (1, 100, [1, 2, 3], True),             # stop() closes it early
    (50, 2, [1, 2, 3], True),              # never opens
    (3, 2, [4, 9, 2, 10], True),           # starts late, skips ahead
], ids=["window", "one", "rewind", "early-stop", "never", "late"])
def test_step_window_profiler_matches_jax(case):
    start, num, steps, stop = case
    trails = {}
    for name, mod in (("port", putil), ("jax", jutil)):
        fake = _FakeBackend()
        prof = mod.Profiler("/tmp/trace", start_step=start,
                            num_steps=num, backend=fake)
        trail = []
        for step in steps:
            prof.observe_step(step)
            with prof.annotation("train_step"):
                pass
            trail.append((prof._active, prof._done, len(fake.calls)))
        if stop:
            prof.stop()
            prof.stop()
        trails[name] = (trail, fake.calls, prof._active, prof._done)
    assert trails["port"] == trails["jax"]


def test_from_args_gate_as_jax():
    class Off:
        profile_dir = ""

    class On:
        profile_dir = "/tmp/x"
        profile_start_step = 1
        profile_steps = 3

    assert putil.from_args(Off()) is None and jutil.from_args(Off()) is None
    got, want = putil.from_args(On()), jutil.from_args(On())
    assert (got.profile_dir, got.start_step, got.num_steps) == \
        (want.profile_dir, want.start_step, want.num_steps)


def _train_steps(path):
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [e for e in events if e.get("name") == "train_step"
            and e.get("ph") == "X"]


def test_worker_writes_a_torch_trace_naming_train_step(tmp_path):
    """JAX's tests/test_profiler.py:115 on the port: a worker with a
    ``Profiler(start_step=2, num_steps=2)`` writes one Chrome trace of
    ``torch.profiler`` whose window holds steps 2 and 3, each under a
    ``train_step`` annotation."""
    from elasticdl_tpu_torch.testing.cluster import MiniCluster
    from elasticdl_tpu_torch.testing.data import (
        create_mnist_record_file,
        model_zoo_dir,
    )

    train = create_mnist_record_file(str(tmp_path / "t.rec"), 96, seed=1)
    trace_dir = str(tmp_path / "trace")
    cluster = MiniCluster(
        model_zoo=model_zoo_dir(),
        model_def="mnist.mnist_functional.custom_model",
        training_data=train, minibatch_size=16, num_epochs=1,
        device="cpu")
    worker = cluster.workers[0]
    worker._profiler = putil.Profiler(trace_dir, start_step=2,
                                      num_steps=2)
    worker.run()
    assert cluster.finished and worker._profiler._done
    (path,) = glob.glob(os.path.join(trace_dir, "trace-*.json"))
    assert worker._profiler._backend.last_trace_path == path
    assert len(_train_steps(path)) == 2


def test_torch_backend_refuses_a_second_start(tmp_path, monkeypatch):
    """No fallback: a second start, a stop with none started and a
    window whose file is not written all raise."""
    import torch

    backend = putil.TorchProfilerBackend()
    backend.start_trace(str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="already started"):
            backend.start_trace(str(tmp_path))
    finally:
        path = backend.stop_trace()
    assert os.path.getsize(path) > 0
    with pytest.raises(RuntimeError, match="no torch.profiler"):
        backend.stop_trace()
    monkeypatch.setattr(torch.profiler.profile, "export_chrome_trace",
                        lambda self, path: None)
    backend.start_trace(str(tmp_path / "t2"))
    with pytest.raises(RuntimeError, match="wrote no trace"):
        backend.stop_trace()


def test_chrome_trace_of_the_same_spans_is_equal_json(tmp_path):
    assert ptx.chrome_trace(SPANS) == jtx.chrome_trace(SPANS)
    assert ptx.chrome_trace([]) == jtx.chrome_trace([])
    ptx.export_chrome_trace(SPANS, str(tmp_path / "p" / "t.json"))
    jtx.export_chrome_trace(SPANS, str(tmp_path / "j" / "t.json"))
    with open(tmp_path / "p" / "t.json", "rb") as a, \
            open(tmp_path / "j" / "t.json", "rb") as b:
        assert a.read() == b.read()


def test_trace_command_passes_both_checkers(tmp_path, capsys):
    """``python -m elasticdl_tpu_torch trace --device cpu``: a traced
    deepfm_host job over a localhost row service, one task tree from
    master to worker to row service."""
    from elasticdl_tpu_torch.api import client

    out = str(tmp_path / "TRACE.json")
    report = str(tmp_path / "report.json")
    assert client.main(["trace", "--device", "cpu", "--out", out,
                        "--report", report, "--num_workers", "1",
                        "--records", "32", "--workdir",
                        str(tmp_path / "w")]) == 0
    assert "trace written to" in capsys.readouterr().out
    assert pcheck_trace.check_trace(out) == []
    assert jcheck_trace.check_trace(out) == []
    with open(report) as fh:
        assert json.load(fh)["span_count"] > 0
