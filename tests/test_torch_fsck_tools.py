"""The port's audit and client tools against the root tools of the JAX
package: ``check_checkpoint``, the umbrella ``fsck``, ``check_overlap``,
``dump_metrics`` and ``serve_client`` (``elasticdl_tpu_torch/tools/``).

- ``check_checkpoint``: the cases of ``tests/test_checkpoint.py``'s
  ``TestCheckpointFsck`` (a healthy base + two deltas, a torn shard with
  an orphaned delta, a leftover ``.tmp`` dir) on chains written by the
  port's saver and by the JAX package's, each with the root tool's
  verdict beside the port's.
- ``fsck``: a tree holding every kind of artifact (a master journal, a
  row checkpoint chain with its push log, a cold store, an incident
  bundle, an authority state file and the five drill reports) gives the
  same artifacts, counts and errors through both umbrellas, green and
  then with a torn checkpoint shard planted.
- ``check_overlap``: a pipelined deepfm_host_multi job of the port
  (one worker, a real localhost row service with injected latency) has
  row pulls that overlap a device step of another trace tree, by both
  checkers.
- ``dump_metrics``: each rendering of a port process's endpoints and of
  the same bodies is the root tool's, character for character.
- ``serve_client``: its closed-loop load against a port server on the
  CPU, every request answered.
"""

import io
import json
import os
import shutil
import sys
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.tools import check_checkpoint as pcheck
from elasticdl_tpu_torch.tools import check_overlap as poverlap
from elasticdl_tpu_torch.tools import dump_metrics as pdump
from elasticdl_tpu_torch.tools import fsck as pfsck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools import check_checkpoint as jcheck  # noqa: E402
from tools import check_overlap as joverlap  # noqa: E402
from tools import dump_metrics as jdump  # noqa: E402

sys.path.insert(0, os.path.join(REPO, "tools"))
from fsck import run_fsck as root_fsck  # noqa: E402

DIM = 4


def _tables(pkg):
    if pkg == "port":
        from elasticdl_tpu_torch.embedding.table import EmbeddingTable
    else:
        from elasticdl_tpu.embedding.table import EmbeddingTable
    table = EmbeddingTable("emb", DIM)
    table.get(range(8))
    return {"emb": table}


def _saver(pkg, path, **kw):
    if pkg == "port":
        from elasticdl_tpu_torch.checkpoint.saver import CheckpointSaver
    else:
        from elasticdl_tpu.checkpoint.saver import CheckpointSaver
    return CheckpointSaver(path, **kw)


def _chain_save(saver, version, tables, dense=None):
    """One save through the saver's on-disk plan (single-threaded)."""
    kind, base, prev = saver.plan_next()
    captured = {}
    for name, table in tables.items():
        if kind == "delta":
            captured[name] = table.dirty_arrays()
        else:
            ids, rows = table.to_arrays()
            table.clear_dirty()
            captured[name] = (ids, rows)
    if kind == "delta":
        saver.save_delta(version, dense or {}, captured, base, prev)
    else:
        saver.save(version, dense or {}, embeddings=captured)


def _chain_dir(pkg, path):
    tables = _tables(pkg)
    saver = _saver(pkg, path, num_shards=2, delta_chain_max=4)
    for table in tables.values():
        table.enable_dirty_tracking()
    _chain_save(saver, 1, tables)
    for v in (2, 3):
        tables["emb"].set([v], np.ones((1, DIM)))
        _chain_save(saver, v, tables)
    return path


def _both(path):
    """The port's and the root tool's (errors, report)."""
    got, want = pcheck.check_checkpoint(path), jcheck.check_checkpoint(path)
    assert got == want
    return got


def _tear(path, element="delta-3"):
    ddir = os.path.join(path, element)
    fname = sorted(f for f in os.listdir(ddir) if f.endswith(".ckpt"))[0]
    blob = open(os.path.join(ddir, fname), "rb").read()
    with open(os.path.join(ddir, fname), "wb") as fh:
        fh.write(blob[: len(blob) // 2])


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_check_checkpoint_green_on_healthy_chain(tmp_path, pkg):
    path = _chain_dir(pkg, str(tmp_path / "c"))
    errors, report = _both(path)
    assert errors == []
    assert report["chains"] == [{"base": 1, "deltas": [2, 3]}]
    assert report["garbage"] == []
    assert pcheck.main([path]) == 0


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_check_checkpoint_flags_torn_shard_and_orphan_delta(tmp_path, pkg):
    path = _chain_dir(pkg, str(tmp_path / "c"))
    _tear(path)
    errors, report = _both(path)
    assert any("crc32" in e for e in errors)
    assert any(g["dir"] == "delta-3" for g in report["garbage"])
    assert pcheck.main([path]) == 1
    shutil.rmtree(os.path.join(path, "version-1"))
    errors, report = _both(path)
    assert any("orphaned delta" in g["why"] for g in report["garbage"])
    assert report["reclaimable_bytes"] > 0


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_check_checkpoint_reports_tmp_garbage(tmp_path, pkg):
    path = _chain_dir(pkg, str(tmp_path / "c"))
    os.makedirs(os.path.join(path, "version-9.tmp"))
    with open(os.path.join(path, "version-9.tmp", "x"), "wb") as f:
        f.write(b"y" * 100)
    errors, report = _both(path)
    assert errors == []
    assert report["garbage"][0]["dir"] == "version-9.tmp"
    assert report["reclaimable_bytes"] == 100
    assert pcheck.main([]) == 2


# ---- the umbrella --------------------------------------------------------


def _incident(out_dir):
    """One incident bundle from the port's SLO plane: a burn rule fired
    over two samples of a latency histogram."""
    from elasticdl_tpu_torch.observability import aggregator, registry, slo
    from elasticdl_tpu_torch.observability import tracing

    now = [1000.0]
    reg = registry.MetricsRegistry()
    plane = aggregator.MetricsPlane(registry=reg)
    store = plane.enable_timeseries(cadence_secs=0.0)
    store._clock = lambda: now[0]
    h = reg.histogram("lat_seconds", "h")
    for value in (0.5, 0.7):
        h.observe(value)
        store.sample({"": (reg.snapshot(), None)}, now=now[0])
        now[0] += 5
    ring = tracing.FlightRecorder(64)
    tracing.install_recorder(ring)
    try:
        with tracing.Tracer("worker", "0").span("task"):
            with tracing.span("device_step"):
                pass
    finally:
        tracing.uninstall_recorder()
    plane.traces.ingest(ring.snapshot())
    recorder = slo.IncidentRecorder(
        out_dir, metrics_plane=plane, store=store,
        journal_tail_fn=lambda: [{"t": "dispatch", "seq": 1}],
        background=False, clock=lambda: now[0])
    rule = slo.SLORule(
        name="latency-burn", kind="burn_rate",
        series="edl_tpu_lat_seconds", latency_threshold=0.05,
        objective=0.95, long_window_secs=60.0, short_window_secs=15.0,
        burn_rate_threshold=3.0, min_count=1)
    engine = slo.SLOEngine(store, rules=[rule], metrics_registry=reg,
                           incident_recorder=recorder,
                           clock=lambda: now[0])
    assert engine.evaluate()[0]["firing"] is True
    recorder.capture(engine.alert_state("latency-burn"))
    return recorder.bundles[0]


def _every_kind(root):
    """A tree with every artifact kind the umbrella dispatches."""
    from elasticdl_tpu_torch.embedding.shard_map import ShardMap
    from elasticdl_tpu_torch.master.journal import MasterJournal
    from elasticdl_tpu_torch.storage import ColdRowStore
    from elasticdl_tpu_torch.storage.pushlog import PushLog

    journal = MasterJournal(os.path.join(root, "master", "journal"))
    journal.open_generation()
    journal.append("version", model_version=3)
    journal.close()
    ckpt = _chain_dir("port", os.path.join(root, "rows", "ckpt"))
    log = PushLog(os.path.join(root, "rows", "ckpt_pushlog"))
    for v in (4, 5):
        log.append(version=v, client="c", seq=v, table="emb",
                   ids=np.asarray([1, 2], np.int64),
                   grads=np.ones((2, DIM), np.float32),
                   applied_at=0.0, map_version=0).wait()
    log.close()
    store = ColdRowStore(os.path.join(root, "cold"), dim=DIM)
    store.put_rows(np.arange(6, dtype=np.int64),
                   np.ones((6, DIM), np.float32))
    store.close()
    _incident(os.path.join(root, "incidents"))
    os.makedirs(os.path.join(root, "authority"))
    with open(os.path.join(root, "authority", "shard_map.json"), "w") as f:
        json.dump({"map": ShardMap.bootstrap(["a:1", "b:2"]).to_json(),
                   "migration": None, "mig_seq": 0, "drained": []}, f)
    for name in ("USAGE_DRILL.json", "SCHED_DRILL.json",
                 "STREAM_DRILL.json", "PROBE_DRILL.json",
                 "BROWNOUT_DRILL.json"):
        os.makedirs(os.path.join(root, "drills", name[:-5].lower()))
        shutil.copy(os.path.join(REPO, name),
                    os.path.join(root, "drills", name[:-5].lower(), name))
    return ckpt


def _umbrellas(root):
    got, want = pfsck.run_fsck(root), root_fsck(root)
    assert got == want
    return got


def test_fsck_umbrella_gives_the_root_verdicts(tmp_path, capsys):
    root = str(tmp_path / "tree")
    ckpt = _every_kind(root)
    errors, report = _umbrellas(root)
    assert errors == []
    assert report["checked"] == {k: 1 for k in report["checked"]}
    assert pfsck.main([root]) == 0
    assert "FSCK OK under" in capsys.readouterr().out
    _tear(ckpt)
    errors, report = _umbrellas(root)
    assert errors and all(e.startswith("checkpoint ") for e in errors)
    assert pfsck.main([root]) == 1
    assert "FSCK FAIL under" in capsys.readouterr().out
    assert pfsck.run_fsck(str(tmp_path / "empty")) == (
        [], {"artifacts": [], "checked": {k: 0 for k in report["checked"]}})


# ---- check_overlap on a pipelined job --------------------------------------


def test_check_overlap_on_a_pipelined_host_job(tmp_path):
    from elasticdl_tpu_torch.embedding import HostStepRunner
    from elasticdl_tpu_torch.embedding.row_service import make_remote_engine
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host_multi
    from elasticdl_tpu_torch.observability import tracing
    from elasticdl_tpu_torch.observability.trace_export import (
        export_chrome_trace,
    )
    from elasticdl_tpu_torch.testing.cluster import MiniCluster
    from elasticdl_tpu_torch.testing.data import (
        create_frappe_record_file,
        model_zoo_dir,
    )

    data = create_frappe_record_file(str(tmp_path / "train.rec"), 32,
                                     seed=11)
    svc = deepfm_host_multi.make_row_service()
    real_pull, real_push = svc._pull_rows, svc._push_row_grads

    def slow(real):
        def handler(request):
            time.sleep(0.02)
            return real(request)
        return handler

    svc._pull_rows, svc._push_row_grads = slow(real_pull), slow(real_push)
    svc.start(tag="rowservice/0")
    addr = f"localhost:{svc.port}"
    recorder = tracing.install_recorder(tracing.FlightRecorder(32768))
    cluster = None
    try:
        cluster = MiniCluster(
            model_zoo=model_zoo_dir(),
            model_def="deepfm.deepfm_host_multi.custom_model",
            training_data=data, minibatch_size=8,
            num_minibatches_per_task=2, num_workers=1, use_rpc=True,
            step_runner_factory=lambda: HostStepRunner(make_remote_engine(
                addr, id_keys={name: key for name, (key, _) in
                               deepfm_host_multi.FIELD_GROUPS.items()}),
                async_apply=True),
            metrics_report_secs=5.0, version_report_steps=2, device="cpu")
        results = cluster.run()
        collector = tracing.TraceCollector(capacity=65536)
        collector.ingest(cluster.metrics_plane.trace_spans())
        collector.ingest(recorder.snapshot())
        spans = collector.spans()
    finally:
        tracing.uninstall_recorder()
        if cluster is not None:
            if cluster._server is not None:
                cluster._server.stop(0)
            cluster.stop()
        svc.stop(0)
    assert sum(r["trained_batches"] for r in results if r) == 4
    out = str(tmp_path / "TRACE_sparse.json")
    export_chrome_trace(spans, out)
    assert poverlap.check_overlap(out) == joverlap.check_overlap(out) == []
    with open(out) as fh:
        events = poverlap._complete_events(json.load(fh))
    assert poverlap.find_overlaps(events) == joverlap.find_overlaps(events)
    assert poverlap.main([out]) == 0
    # A serialized trace (every pull inside its own step's tree) fails.
    serial = [dict(e, args={**e.get("args", {}), "trace_id": "t"})
              for e in events]
    with open(tmp_path / "serial.json", "w") as fh:
        json.dump({"traceEvents": serial}, fh)
    got = poverlap.check_overlap(str(tmp_path / "serial.json"))
    assert got and got == joverlap.check_overlap(
        str(tmp_path / "serial.json"))


# ---- dump_metrics ----------------------------------------------------------


def _render(tool, fn, *args, **kw):
    out = io.StringIO()
    with redirect_stdout(out):
        result = getattr(tool, fn)(*args, **kw)
    return result, out.getvalue()


ALERTS = {
    "now": 100.0, "firing": ["a"],
    "rules": [
        {"rule": "a", "kind": "burn_rate", "series": "s", "firing": True,
         "since": 40.0, "detail": "burning"},
        {"rule": "b", "kind": "absence", "series": "t", "firing": False,
         "detail": "all fresh"},
    ],
}
PROFILE = {
    "component": "0",
    "window": {"t0": 10.0, "t1": 12.5, "hz": 20.0, "sample_count": 7,
               "threads": {"MainThread": 7},
               "samples": {"MainThread;train;step": 4,
                           "MainThread;train;load": 2,
                           "MainThread;idle": 1}},
}


@pytest.mark.parametrize("fn,body", [
    ("print_alerts", ALERTS), ("print_alerts", {"error": "disabled"}),
    ("print_profile", PROFILE), ("print_profile", {
        "error": "unknown", "components": [
            {"component": "0", "role": "worker", "instance": "0",
             "windows": 2}]}),
])
def test_dump_metrics_renders_bodies_as_the_root_tool(fn, body):
    got = _render(pdump, fn, body)[1]
    assert got == _render(jdump, fn, body)[1]
    assert got


def test_dump_metrics_renders_a_port_endpoint_as_the_root_tool():
    from elasticdl_tpu_torch.observability.aggregator import MetricsPlane
    from elasticdl_tpu_torch.observability.registry import MetricsRegistry

    reg = MetricsRegistry()
    reg.counter("edl_tpu_tasks_total", "tasks").inc(3)
    reg.gauge("edl_tpu_overload_queue_depth", "depth").set(2)
    h = reg.histogram("edl_tpu_step_seconds", "step")
    for v in (0.01, 0.02, 0.5):
        h.observe(v)
    plane = MetricsPlane(registry=reg)
    plane.ingest(0, {
        "instance": "i", "families": [],
        "spans": [
            {"span_id": "root", "name": "task", "trace_id": "t",
             "parent_id": None, "role": "worker", "instance": "0",
             "t0": 1.0, "dur": 0.5, "attrs": {"task_id": 4}},
            {"span_id": "kid", "name": "device_step", "trace_id": "t",
             "parent_id": "root", "role": "worker", "instance": "0",
             "t0": 1.1, "dur": 0.3, "attrs": {}},
        ],
    })
    server = plane.serve(port=0)
    addr = f"localhost:{server.port}"
    try:
        for flags in ([], ["--raw"], ["--traces"], ["--overload"]):
            got = _render(pdump, "main", [addr, *flags])
            want = _render(jdump, "main", [addr, *flags])
            assert got == want and got[0] == 0, flags
            assert got[1]
        assert "edl_tpu_tasks_total 3" in _render(
            pdump, "main", [addr, "--raw"])[1]
    finally:
        plane.stop()


# ---- serve_client ----------------------------------------------------------


def test_serve_client_against_a_port_server(tmp_path):
    from elasticdl_tpu_torch import bridge
    from elasticdl_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from elasticdl_tpu_torch.serving import export as port_export
    from elasticdl_tpu_torch.serving.model_store import ModelStore
    from elasticdl_tpu_torch.serving.server import InferenceServer
    from elasticdl_tpu_torch.tools import serve_client

    # synth_features draws int leaves in [0, 1000): a vocabulary past it.
    cfg = TransformerConfig(vocab_size=1024, d_model=32, n_heads=2,
                            n_layers=1, d_ff=64, max_len=16,
                            compute_dtype=torch.float32)
    model = TransformerLM(cfg)
    model.load_state_dict(bridge.state_dict_from_flax(
        bridge.init_flax_params(cfg, 1)))
    port_export.export_serving_bundle(
        str(tmp_path / "v1"), model, batch_example=np.zeros((2, 16),
                                                            np.int32),
        model_def="transformer.transformer_lm.custom_model", version=1)
    store = ModelStore(str(tmp_path), device="cpu", poll_seconds=60)
    store.load_initial()
    srv = InferenceServer(store, port=0, batch_deadline_ms=2).start()
    addr = f"localhost:{srv.port}"
    try:
        signature = serve_client.fetch_signature(addr)
        assert signature == {"shape": [None, 16], "dtype": "int32"}
        features = serve_client.synth_features(signature, 2, seed=3)
        status, payload = serve_client.predict_once(addr, features)
        assert status == 200
        with torch.inference_mode():
            want = model.eval()(torch.from_numpy(features)).numpy()
        np.testing.assert_allclose(np.asarray(payload["predictions"]),
                                   want, rtol=1e-4, atol=1e-4)
        result = serve_client.run_load(addr, [features], 40, 4)
        assert result["ok"] == 40 and result["statuses"] == {"200": 40}
        assert result["p50_ms"] > 0 and result["p99_ms"] >= result["p50_ms"]
        rc, out = _render(serve_client, "main", [
            "--addr", addr, "--requests", "20", "--concurrency", "2",
            "--batch", "2", "--warmup", "1"])
        assert rc == 0 and json.loads(out)["ok"] == 20
    finally:
        srv.stop()
