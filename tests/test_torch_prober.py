"""The synthetic prober in the port (``elasticdl_tpu_torch/observability/
prober.py`` and the master's ``--probes``) on the CPU.

The JAX ``tests/test_probe.py`` cases that need no incident recorder
and no SLO rule run against the port: red only after consecutive
failures, ``healthz`` with no runs, the bounded reasons, probe traffic
metered under the ``canary`` purpose, ``/probes`` and ``/healthz`` over
HTTP. Under a fake clock the same scripted outcomes through a JAX and a
port ``ProbeScheduler`` render equal ``/probes`` bodies (the measured
latency, the one field read off the real clock, taken out). The probe
bodies are held to JAX's on the same fakes, the row probes run against
a port row service, and the port's master wires the prober as the JAX
master does (``/probes``, ``/healthz``, the ``__prober__`` tenant under
``--sched``).
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from elasticdl_tpu.observability import prober as jprober
from elasticdl_tpu.observability import registry as jreg
from elasticdl_tpu_torch.comm.rpc import (
    RpcServer,
    RpcStub,
    wait_for_channel_ready,
)
from elasticdl_tpu_torch.observability import principal, usage
from elasticdl_tpu_torch.observability import prober
from elasticdl_tpu_torch.observability import registry as registry_mod
from elasticdl_tpu_torch.observability.prober import (
    ProbeFailure,
    ProbeScheduler,
)
from elasticdl_tpu_torch.observability.registry import MetricsRegistry

PKGS = {"jax": (jprober, jreg), "port": (prober, registry_mod)}
# Read off time.perf_counter, not the scheduler's clock.
REAL_CLOCK_FIELDS = ("last_latency_secs",)


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, secs):
        self.t += secs
        return self.t


def _family(reg, name):
    return next(
        f for f in reg.snapshot()["families"] if f["name"] == name
    )


def test_canary_keyspace_matches_jax():
    for name in ("CANARY_ID_BASE", "CANARY_ID_SPAN",
                 "CANARY_STREAM_PARTITION", "CANARY_JOB", "PROBER_TENANT",
                 "REASONS", "PROBE_BUCKETS", "DEFAULT_INTERVAL_SECS"):
        assert getattr(prober, name) == getattr(jprober, name), name
    for slot in (0, 1, 2 ** 20, 2 ** 20 + 5):
        assert prober.canary_id(slot) == jprober.canary_id(slot)
        assert prober.is_canary_id(prober.canary_id(slot))
    assert not prober.is_canary_id(prober.CANARY_ID_BASE - 1)
    assert not prober.is_canary_id(
        prober.CANARY_ID_BASE + prober.CANARY_ID_SPAN)


# ---- state machine (the JAX cases) ----------------------------------------


def test_red_needs_consecutive_failures_and_clears_on_success():
    sched = ProbeScheduler(registry=MetricsRegistry(), unhealthy_after=2)
    verdicts = {"fail": False}

    def probe():
        if verdicts["fail"]:
            raise ProbeFailure("timeout", "deadline elapsed")
        return {"polls": 1}

    sched.register("flaky", probe, interval_secs=0)
    assert sched.run_once("flaky")["status"] == "green"
    verdicts["fail"] = True
    assert sched.run_once("flaky")["status"] == "green"
    assert sched.healthz()["ok"] is True
    assert sched.run_once("flaky")["status"] == "red"
    verdict = sched.healthz()
    assert verdict["ok"] is False
    assert verdict["status"] == "degraded"
    assert verdict["red"] == ["flaky"]
    verdicts["fail"] = False
    assert sched.run_once("flaky")["status"] == "green"
    assert sched.healthz()["ok"] is True
    assert sched.render()["probes"]["flaky"]["reds"] == 1


def test_never_run_probe_does_not_fail_healthz():
    sched = ProbeScheduler(registry=MetricsRegistry())
    sched.register("pending", lambda: None, interval_secs=60)
    assert sched.healthz()["ok"] is True
    assert sched.render()["probes"]["pending"]["status"] == "init"


def test_failure_reasons_label_the_failure_family():
    reg = MetricsRegistry()
    sched = ProbeScheduler(registry=reg, unhealthy_after=99)

    def fail_timeout():
        raise ProbeFailure("timeout", "deadline")

    def fail_stale():
        raise ProbeFailure("stale", "watermark stuck")

    def crash():
        raise ValueError("probe bug")

    sched.register("a", fail_timeout, interval_secs=0)
    sched.register("b", fail_stale, interval_secs=0)
    sched.register("c", crash, interval_secs=0)
    assert sched.run_once("a")["reason"] == "timeout"
    assert sched.run_once("b")["reason"] == "stale"
    assert sched.run_once("c")["reason"] == "exception"
    fam = _family(reg, "edl_tpu_probe_failures_total")
    by_labels = {tuple(s["labels"]): s["value"] for s in fam["series"]}
    assert by_labels[("a", "timeout")] == 1
    assert by_labels[("b", "stale")] == 1
    assert by_labels[("c", "exception")] == 1
    sched.register(
        "d", lambda: (_ for _ in ()).throw(
            ProbeFailure("weird", "unknown reason")
        ), interval_secs=0,
    )
    assert sched.run_once("d")["reason"] == "exception"


def test_probe_traffic_meters_under_the_canary_purpose():
    def echo(request):
        return {"who": principal.current().wire()}

    server = RpcServer("localhost:0", {"Echo": {"echo": echo}}).start()
    fresh = MetricsRegistry()
    old = registry_mod._DEFAULT
    registry_mod._DEFAULT = fresh
    old_gen, old_jobs = usage._fold_generation, usage._fold_jobs
    usage._fold_generation, usage._fold_jobs = fresh.generation, set()
    try:
        channel = wait_for_channel_ready(
            f"localhost:{server.port}", timeout=10, retries=3)
        stub = RpcStub(channel, "Echo")
        seen = {}

        def probe():
            seen.update(stub.call("echo")["who"])

        sched = ProbeScheduler(registry=MetricsRegistry())
        sched.register("rpc", probe, interval_secs=0)
        assert sched.run_once("rpc")["ok"]
        channel.close()
        assert seen["job"] == prober.CANARY_JOB
        assert seen["purpose"] == "canary"
        fam = _family(fresh, "edl_tpu_usage_requests_total")
        by_labels = {tuple(s["labels"]): s["value"]
                     for s in fam["series"]}
        assert by_labels[
            (prober.CANARY_JOB, "prober", "canary", "Echo.echo")] == 1
    finally:
        registry_mod._DEFAULT = old
        usage._fold_generation, usage._fold_jobs = old_gen, old_jobs
        server.stop(0)
        principal.set_process_principal()


def test_probes_and_healthz_endpoints_serve_the_verdict():
    from elasticdl_tpu_torch.observability.exposition import (
        MetricsHTTPServer,
    )

    sched = ProbeScheduler(registry=MetricsRegistry(), unhealthy_after=1)
    verdicts = {"fail": False}

    def probe():
        if verdicts["fail"]:
            raise ProbeFailure("rpc_error", "down")

    sched.register("edge", probe, interval_secs=0)
    sched.run_once("edge")
    server = MetricsHTTPServer(
        render=lambda: "", port=0,
        json_routes={"/probes": lambda params: sched.render()},
        health=sched.healthz,
    ).start()
    try:
        base = f"http://localhost:{server.port}"
        with urllib.request.urlopen(f"{base}/probes") as resp:
            body = json.loads(resp.read())
        assert body["job"] == prober.CANARY_JOB
        assert body["canary_id_base"] == prober.CANARY_ID_BASE
        assert body["probes"]["edge"]["status"] == "green"
        with urllib.request.urlopen(f"{base}/healthz") as resp:
            assert resp.status == 200
            assert json.loads(resp.read())["ok"] is True
        verdicts["fail"] = True
        sched.run_once("edge")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/healthz")
        assert err.value.code == 503
        degraded = json.loads(err.value.read())
        assert degraded["ok"] is False
        assert degraded["red"] == ["edge"]
    finally:
        server.stop()


# ---- the two packages' schedulers held to each other ----------------------


OUTCOMES = {
    "row": ["ok", "ok", "timeout", "rpc_error", "rpc_error", "ok"],
    "stream": ["stale", "stale", "stale", "ok", "mismatch", "ok"],
    "buggy": ["ok", "raise", "raise", "weird", "ok", "ok"],
}


def scripted_render(pkg):
    """Scripted outcomes under a fake clock through ``pkg``'s scheduler:
    every probe's result records, healthz after each tick, the tenant
    notes and the final render (measured latency taken out)."""
    mod, reg_mod = PKGS[pkg]
    clock = FakeClock()
    sched = mod.ProbeScheduler(registry=reg_mod.MetricsRegistry(),
                               unhealthy_after=2, clock=clock)
    step = {"i": 0}

    def body(name):
        def probe():
            outcome = OUTCOMES[name][step["i"]]
            if outcome == "ok":
                return {"tick": step["i"]}
            if outcome == "raise":
                raise KeyError("probe bug")
            raise mod.ProbeFailure(outcome, f"{name} {outcome}")
        return probe

    for i, name in enumerate(OUTCOMES):
        sched.register(name, body(name), interval_secs=5.0 + i,
                       description=f"the {name} canary")
    records, verdicts = [], []
    for i in range(len(OUTCOMES["row"])):
        step["i"] = i
        for record in sched.run_pending(clock()):
            record.pop("latency_secs")
            records.append(record)
        verdicts.append(sched.healthz())
        clock.advance(7.0)
    sched.note_registered()
    sched.note_preempted("__prober__", {})
    clock.advance(1.0)
    sched.note_resumed("__prober__", {})
    render = sched.render()
    for ent in render["probes"].values():
        for field in REAL_CLOCK_FIELDS:
            ent.pop(field)
    return records, verdicts, render


def test_same_outcomes_render_the_same_as_jax():
    got, want = scripted_render("port"), scripted_render("jax")
    assert got == want
    records, verdicts, render = got
    assert render["probes"]["row"]["reds"] == 1
    assert render["probes"]["stream"]["status"] == "green"
    assert render["probes"]["buggy"]["last_reason"] == "exception"
    assert render["tenant"]["preemptions"] == 1
    assert render["tenant"]["state"] == "running"
    assert any(not v["ok"] for v in verdicts) and verdicts[-1]["ok"]


# ---- the probe bodies ------------------------------------------------------


class FakeRowClient:
    """A row-tier stand-in: SGD at lr 1 on a dict of rows."""

    def __init__(self, dim=4, stale=False):
        self.rows, self.dim, self.stale = {}, dim, stale
        self.table_name = "t"

    def pull(self, ids):
        return np.stack([self.rows.get(int(i), np.zeros(self.dim,
                                                        np.float32))
                         for i in ids])

    def push(self, ids, grads):
        if self.stale:
            return
        for i, g in zip(ids, grads):
            self.rows[int(i)] = self.rows.get(
                int(i), np.zeros(self.dim, np.float32)) - g


@pytest.mark.parametrize("stale", [False, True])
def test_row_ryw_probe_matches_jax(stale):
    out = {}
    for tag, (mod, _reg) in PKGS.items():
        client = FakeRowClient(stale=stale)
        probe = mod.make_row_ryw_probe(
            client, slot=3, expect_fn=lambda before, g: before - g)
        results = []
        for _ in range(3):
            try:
                results.append(probe())
            except mod.ProbeFailure as exc:
                results.append((exc.reason, str(exc)))
        out[tag] = (results, {k: v.tobytes()
                              for k, v in client.rows.items()})
    assert out["port"] == out["jax"]
    if stale:
        assert out["port"][0][0][0] == "mismatch"
    else:
        # The sign alternates: the canary row stays bounded.
        assert out["port"][0][0] == {"table": "t",
                                     "id": prober.canary_id(3)}


def test_stream_and_serving_probes_match_jax(tmp_path):
    out = {}
    for tag, (mod, _reg) in PKGS.items():
        appender = mod.make_stream_appender(str(tmp_path / tag))
        offsets = [appender(), appender()]
        marks = iter([None, 0, 1, 2, 5])
        wm = mod.make_stream_watermark_probe(
            appender, lambda: next(marks), deadline_secs=5.0,
            poll_secs=0.0)
        predictions = iter([[0.5], [0.5], [0.25], [1.0], [1.0], [2.0]])
        pushed = []
        fresh = mod.make_serving_freshness_probe(
            lambda: {"p": np.asarray(next(predictions), np.float32)},
            pushed.append, deadline_secs=5.0, poll_secs=0.0)
        never = mod.make_stream_watermark_probe(
            appender, lambda: 0, deadline_secs=0.0, poll_secs=0.0)
        try:
            never()
            stale = None
        except mod.ProbeFailure as exc:
            stale = exc.reason
        out[tag] = (offsets, wm(), fresh(), fresh(), pushed, stale,
                    (tmp_path / tag / "canary.edlstream").stat().st_size,
                    mod.fingerprint_predictions(
                        {"b": [np.arange(3)], "a": np.ones(2, np.int64)}))
    assert out["port"] == out["jax"]
    # The canary records are the JAX package's bytes, JSON with the id.
    from elasticdl_tpu_torch.data.stream import FileTailStream

    records = FileTailStream(str(tmp_path / "port")).read(
        prober.CANARY_STREAM_PARTITION, 0, 2)
    assert json.loads(records[0]) == {"id": prober.canary_id(0),
                                      "canary": True}


def test_row_probes_against_a_port_row_service():
    """``row_ryw`` and ``reshard_convergence`` through the port's remote
    engine to a row service: green while it serves, ``rpc_error`` once
    it is gone, and every canary row in the reserved range."""
    from elasticdl_tpu_torch.embedding.optimizer import (
        SGD,
        HostOptimizerWrapper,
    )
    from elasticdl_tpu_torch.embedding.row_service import HostRowService
    from elasticdl_tpu_torch.embedding.table import EmbeddingTable

    svc = HostRowService({"emb": EmbeddingTable("emb", 8)},
                         HostOptimizerWrapper(SGD(lr=0.5))
                         ).start("localhost:0")
    addr = f"localhost:{svc.port}"
    sched = ProbeScheduler(registry=MetricsRegistry(), unhealthy_after=2)
    client = prober.RowCanaryClient(addr, retries=0, backoff_secs=0.05)
    sched.register("row_ryw", prober.make_row_ryw_probe(client),
                   interval_secs=0)
    sched.register("reshard_convergence",
                   prober.make_reshard_convergence_probe(
                       addr, retries=0, backoff_secs=0.05),
                   interval_secs=0)
    try:
        for _ in range(3):
            for name in ("row_ryw", "reshard_convergence"):
                record = sched.run_once(name)
                assert record["ok"], record
        assert client.table_name == "emb" and client.dim() == 8
        ids, _rows = svc.host_tables["emb"].to_arrays()
        assert len(ids) and all(prober.is_canary_id(i) for i in ids)
    finally:
        svc.stop(0)
    for _ in range(2):
        record = sched.run_once("row_ryw")
    assert not record["ok"] and record["reason"] in prober.REASONS
    assert record["reason"] in ("rpc_error", "timeout")
    assert sched.healthz()["red"] == ["row_ryw"]


# ---- the master's wiring ---------------------------------------------------


def test_master_mounts_probes_healthz_and_the_prober_tenant(tmp_path):
    from elasticdl_tpu_torch.common.args import build_parser
    from elasticdl_tpu_torch.master.main import Master
    from elasticdl_tpu_torch.master.scheduler import TERMINAL_STATES
    from elasticdl_tpu_torch.testing.data import (
        create_mnist_record_file,
        model_zoo_dir,
    )

    train = create_mnist_record_file(str(tmp_path / "t.rec"), 64, seed=1)
    master = Master(build_parser("master").parse_args([
        "--model_zoo", model_zoo_dir(),
        "--model_def", "mnist.mnist_functional.custom_model",
        "--training_data", train, "--minibatch_size", "16",
        "--probes", "true", "--probe_interval_secs", "0.2",
        "--sched", "true", "--master_addr", "localhost:0",
        "--metrics_port", "0", "--job_name", "probed"]))
    master.prepare()
    try:
        base = f"http://localhost:{master.metrics_plane.http_port}"
        import time

        deadline = time.monotonic() + 30
        while True:
            with urllib.request.urlopen(f"{base}/probes") as resp:
                body = json.loads(resp.read())
            ent = body["probes"]["dispatch_roundtrip"]
            if ent["attempts"] >= 3 or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert ent["status"] == "green" and ent["attempts"] >= 3
        assert set(body["probes"]) == {"dispatch_roundtrip"}
        assert body["tenant"]["registered"]
        with urllib.request.urlopen(f"{base}/healthz") as resp:
            assert resp.status == 200 and json.loads(resp.read())["ok"]
        jobs = master.scheduler.export_state()["jobs"]
        assert jobs[prober.PROBER_TENANT]["priority"] == -100
        assert jobs["probed"]["state"] == "submitted"
        # The dispatch probe's leases go back at retry 0: the job's
        # tasks stay whole.
        master.scheduler.tick()
        usage_body = master.metrics_plane.usage(top_k=50)
        purposes = {row["principal"]["purpose"]
                    for row in usage_body["principals"]}
        assert "canary" in purposes
        # The prober tenant is the only open job once the real one is
        # drained: the exit gate retires it.
        disp = master.task_dispatcher
        while True:
            task = disp.get(0)
            if task is None:
                break
            disp.report(task.task_id, True)
        master.scheduler.tick()
        assert master._job_finished()
        state = master.scheduler.export_state()["jobs"]
        assert state[prober.PROBER_TENANT]["state"] == "cancelled"
        assert all(j["state"] in TERMINAL_STATES for j in state.values())
    finally:
        master.stop()
