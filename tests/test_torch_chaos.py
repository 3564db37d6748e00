"""The port's chaos plane (``elasticdl_tpu_torch/chaos/{faults,
interceptors,invariants,runner}.py``) against the JAX package's.

- Plans: the same seed gives the same bytes in both packages.
- The injector: the same scripted calls give the same ``injected``
  schedule, ``fault_counts`` and ``metric_families``.
- The invariants: the same inputs give the same verdict dicts.
- ``ChaosRunner``: each package runs the same plan on its own job, the
  port's from the JAX run's initial weights (carried through
  ``bridge``), and the reports are equal but for three named fields:

  * ``job.final_loss`` is held to 1e-4 relative. The deepfm_host
    executor parity (``tests/test_torch_deepfm.py``, 8 steps from JAX's
    initial weights) and the f32 mnist executor parity
    (``tests/test_torch_vision_zoo.py``, 4 SGD-momentum steps) hold
    per-step losses to 1e-4 relative: the packages' float orders differ
    (XLA's fused reductions, torch's), and the chaos job's 8 steps sit
    in the same regime. The runs read ~6e-6 relative (sparse).
  * ``job.dense_leaves`` lists each package's own state leaves: flax
    paths with (in, out) kernels and one optax count in JAX, torch
    names with (out, in) weights and a step per parameter in the port.
    The parameters' element counts must agree.
  * The loss-equivalence verdict's detail counts those leaves.

  The dense flavour runs both packages' mnist_functional at f32 (bf16
  twins part by a rounding within a step or two on these saturating
  records, as the vision parity tests found).
- The port catches the lost-task regression and the corrupted latest
  checkpoint, and two same-seed port runs give byte-equal reports.
"""

import copy
import os
import re
import textwrap

import jax
import numpy as np
import pytest

from elasticdl_tpu.chaos import faults as jfaults
from elasticdl_tpu.chaos import interceptors as jinter
from elasticdl_tpu.chaos import invariants as jinv
from elasticdl_tpu.chaos import runner as jrunner
from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.chaos import faults as tfaults
from elasticdl_tpu_torch.chaos import interceptors as tinter
from elasticdl_tpu_torch.chaos import invariants as tinv
from elasticdl_tpu_torch.chaos import runner as trunner

PKG = {"jax": (jfaults, jinter, jinv, jrunner),
       "port": (tfaults, tinter, tinv, trunner)}
PLANS = ("default_plan", "master_kill_plan", "randomized_plan")
LOSS_RTOL = 1e-4


# ---- plans ---------------------------------------------------------------


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("plan", PLANS)
def test_plans_are_byte_equal_to_jax(plan, seed):
    for shards in (1, 3):
        want = getattr(jfaults, plan)(seed, num_row_service_shards=shards)
        got = getattr(tfaults, plan)(seed, num_row_service_shards=shards)
        assert got.to_json() == want.to_json()
        assert tfaults.describe(got) == jfaults.describe(want)
        assert tfaults.FaultPlan.from_json(want.to_json()).to_json() == (
            want.to_json())


def test_plan_validation_refuses_what_jax_refuses():
    for bad in ({"kind": "nope"}, {"kind": "rpc_drop", "site": "x"},
                {"kind": "fsync_stall", "target": "disk"},
                {"kind": "rpc_drop", "probability": 2.0},
                {"kind": "corrupt_checkpoint", "corrupt_mode": "x"}):
        for mod in (jfaults, tfaults):
            with pytest.raises(ValueError):
                mod.FaultEvent(**bad)
    with pytest.raises(ValueError):
        tfaults.FaultEvent.from_dict({"kind": "rpc_drop", "extra": 1})


# ---- the injector --------------------------------------------------------

SCRIPT_PLAN = {
    "seed": 4,
    "events": [
        {"kind": "rpc_drop", "target": "Svc", "method": "ping",
         "at_call": 2},
        {"kind": "rpc_error", "target": "Svc", "method": "put",
         "at_call": 1, "code": "INTERNAL"},
        {"kind": "rpc_delay", "target": "Svc", "method": "get",
         "at_call": 0, "probability": 0.5, "delay_secs": 0.001,
         "max_fires": 0},
        {"kind": "blackhole", "site": "server", "target": "rowservice/1",
         "at_call": 3, "duration_calls": 2},
        {"kind": "stall_shard", "site": "server", "shard": 0,
         "method": "push_row_grads", "at_call": 2, "duration_calls": 2,
         "delay_secs": 0.001},
        {"kind": "fsync_stall", "target": "pushlog", "at_call": 2,
         "delay_secs": 0.001},
        {"kind": "corrupt_checkpoint", "target": "state", "at_save": 2,
         "corrupt_mode": "garbage"},
        {"kind": "kill_worker", "worker_id": 1, "at_call": 2},
        {"kind": "master_kill", "method": "report_task_result",
         "at_call": 2},
    ],
}


def _script(pkg, tmp_path):
    """One fixed call sequence through an injector; returns what it
    recorded and the outcome of each call (the exception's class)."""
    _, inter, _, _ = PKG[pkg]
    plan = PKG[pkg][0].FaultPlan.from_dict(copy.deepcopy(SCRIPT_PLAN))
    injector = inter.FaultInjector(plan)
    restarts = []
    injector.set_master_restart(lambda: restarts.append(1))
    outcomes = []

    def call(fn, *args):
        try:
            outcomes.append(repr(fn(*args)))
        except BaseException as exc:  # ChaosKill is one
            outcomes.append(type(exc).__name__ + ":"
                            + str(getattr(exc, "code", "")))

    for i in range(6):
        call(injector.client_hook, "Svc", "ping", {})
        call(injector.client_hook, "Svc", "put", {})
        call(injector.client_hook, "Svc", "get", {})
        call(injector.client_hook, "elasticdl_tpu.Master", "get_task",
             {"worker_id": i % 2})
        call(injector.client_hook, "elasticdl_tpu.Master",
             "report_task_result", {"worker_id": 0})
        for tag in ("rowservice/0", "rowservice/1"):
            for method in ("pull_rows", "push_row_grads"):
                call(injector.server_hook, tag, "RowService", method, {})
        call(injector.fsync_hook, "pushlog")
        call(injector.fsync_hook, "checkpoint")
    for cb_name, cb in sorted(injector.in_process_callbacks().items()):
        call(cb, {"worker_id": 1})
    root = tmp_path / pkg
    for version in (1, 2, 3):
        vdir = root / "state" / f"version-{version}"
        vdir.mkdir(parents=True)
        (vdir / "variables-0-of-1.ckpt").write_bytes(bytes(range(64)))
        injector.on_save(str(root / "state"), version, str(vdir))
    blob = (root / "state" / "version-2" / "variables-0-of-1.ckpt"
            ).read_bytes()
    injector.observe_instance_event("kill_worker", worker_id=3)
    injector.observe_instance_event("worker_relaunched", worker_id=3,
                                    new_id=4)
    return dict(injected=injector.injected,
                counts=injector.fault_counts(),
                families=injector.metric_families(),
                outcomes=outcomes, restarts=len(restarts), blob=blob,
                recoveries=[(r["worker_id"], r["new_id"])
                            for r in injector.recoveries])


def test_scripted_calls_fire_the_same_schedule_as_jax(tmp_path):
    want = _script("jax", tmp_path)
    got = _script("port", tmp_path)
    assert got == want
    kinds = set(want["counts"])
    assert kinds == {e["kind"] for e in SCRIPT_PLAN["events"]}
    assert want["restarts"] == 1 and want["blob"].startswith(b"\x00CHAOS")


@pytest.mark.parametrize("mode", ["truncate", "garbage", "delete"])
def test_checkpoint_corruption_writes_what_jax_writes(mode, tmp_path):
    out = {}
    for pkg in ("jax", "port"):
        vdir = tmp_path / pkg / "version-5"
        vdir.mkdir(parents=True)
        for k in range(2):
            (vdir / f"variables-{k}-of-2.ckpt").write_bytes(
                bytes(range(k, 40 + k)))
        name = PKG[pkg][1].FaultInjector._corrupt(str(vdir), mode)
        out[pkg] = (name, sorted(
            (p.name, p.read_bytes()) for p in vdir.iterdir()))
    assert out["port"] == out["jax"]


def test_chaos_kill_is_a_base_exception():
    assert not issubclass(tinter.ChaosKill, Exception)
    kill = tinter.ChaosKill(2, 5)
    assert (kill.worker_id, kill.event_index) == (2, 5)
    assert str(kill) == str(jinter.ChaosKill(2, 5))


def test_install_reaches_the_ports_seams():
    from elasticdl_tpu_torch.checkpoint import saver
    from elasticdl_tpu_torch.comm import rpc
    from elasticdl_tpu_torch.master import instance_manager
    from elasticdl_tpu_torch.storage import pushlog

    injector = tinter.FaultInjector(tfaults.FaultPlan())
    with injector:
        assert rpc._client_hook == injector.client_hook
        assert rpc._server_hook == injector.server_hook
        assert saver._post_save_hook == injector.on_save
        assert pushlog._fsync_hook == injector.fsync_hook
        assert instance_manager._chaos_observer == (
            injector.observe_instance_event)
    assert rpc._client_hook is None and saver._post_save_hook is None
    assert pushlog._fsync_hook is None
    assert instance_manager._chaos_observer is None


# ---- the invariants ------------------------------------------------------


def _dispatcher(pkg):
    if pkg == "jax":
        from elasticdl_tpu.master.task_dispatcher import TaskDispatcher
    else:
        from elasticdl_tpu_torch.master.task_dispatcher import (
            TaskDispatcher,
        )
    return TaskDispatcher(training_shards={"f": (0, 32)},
                          evaluation_shards={}, prediction_shards={},
                          records_per_task=8, num_epochs=1)


def _accounting_cases(pkg):
    inv = PKG[pkg][2]
    from elasticdl_tpu.common.constants import TaskType

    out = []
    for case in ("clean", "lost", "double", "unbound"):
        d = _dispatcher(pkg)
        if case == "lost":
            d.get(0)
        while True:
            task = d.get(1)
            if task is None:
                break
            d.report(task.task_id, True)
        if case == "double":
            d.counters.add_completed(TaskType.TRAINING, 8)
        if case == "unbound":
            late = PKG[pkg][3]._LateBoundAccounting({TaskType.TRAINING: 32})
            out.append(late.check().to_dict())
            continue
        out.append(inv.ExactlyOnceTaskAccounting(
            d, {TaskType.TRAINING: 32}).check().to_dict())
    return out


def _row_cases(pkg):
    inv = PKG[pkg][2]
    if pkg == "jax":
        from elasticdl_tpu.embedding.table import EmbeddingTable
    else:
        from elasticdl_tpu_torch.embedding.table import EmbeddingTable
    full = EmbeddingTable("t", 4)
    full.get(np.array([1, 2, 3, 9], np.int64))
    shrunk = EmbeddingTable("t", 4)
    shrunk.get(np.array([1, 3], np.int64))
    out = []
    for final in ({"t": full}, {"t": shrunk}, {}):
        checker = inv.RowConservation()
        checker.snapshot("kill-1", {"t": full})
        out.append(checker.check(final).to_dict())
    return out


def _other_cases(pkg):
    inv = PKG[pkg][2]
    out = []
    mono = inv.CheckpointMonotonicity()
    for v in (2, 4, 4):
        mono.on_save("/c", v)
    mono.on_restore("/c", 4)
    out.append(mono.check().to_dict())
    mono.on_save("/c", 3)
    out.append(mono.check().to_dict())
    future = inv.CheckpointMonotonicity()
    future.on_save("/c", 2)
    future.on_restore("/c", 6)
    out.append(future.check().to_dict())
    state = {"todo": [], "doing": [[1, {}, 0]], "task_id": 4,
             "completed": {"training": 32}}
    for observed, gens, expected in (
            (dict(state), (0, 1), 1), ({**state, "task_id": 3}, (0, 1), 1),
            (dict(state), (1, 1), 1), (dict(state), (0, 1), 2),
            ({**state, "worker_version": {"0": 4}}, (0, 1), 1)):
        checker = inv.MasterRestartEquivalence(expected)
        checker.observe(state, observed, gens[0], gens[1], replayed=5)
        out.append(checker.check().to_dict())
    base = {"final_version": 8, "final_loss": 0.5,
            "leaves": {"w": np.ones((2, 3), np.float32)}}
    for run in (base, {**base, "final_version": 7},
                {**base, "final_loss": 0.6}, {**base, "final_loss": None},
                {**base, "leaves": {"w": np.full((2, 3), 1.1, np.float32)}},
                {**base, "leaves": {"v": np.ones(1)}}):
        checker = inv.LossTrajectoryEquivalence(base)
        checker.observe(run)
        out.append(checker.check().to_dict())
    out.append(inv.LossTrajectoryEquivalence(None).check().to_dict())
    out.append(inv.LossTrajectoryEquivalence(base).check().to_dict())
    return out


@pytest.mark.parametrize("cases", [_accounting_cases, _row_cases,
                                   _other_cases])
def test_invariant_verdicts_equal_jax(cases):
    want = cases("jax")
    assert cases("port") == want
    assert any(v["passed"] for v in want)
    assert not all(v["passed"] for v in want)


# ---- the runner ----------------------------------------------------------

JAX_F32_MNIST = '''
import jax.numpy as jnp

from elasticdl_tpu.core.model_spec import load_module

_ref = load_module(REF)
loss, optimizer = _ref.loss, _ref.optimizer
dataset_fn, eval_metrics_fn = _ref.dataset_fn, _ref.eval_metrics_fn


def custom_model():
    return _ref.MnistModel(compute_dtype=jnp.float32)
'''

PORT_F32_MNIST = '''
import torch

from elasticdl_tpu_torch.model_zoo.mnist import mnist_functional as twin
from elasticdl_tpu_torch.model_zoo.mnist.mnist_functional import (
    dataset_fn, eval_metrics_fn, loss, optimizer)


def custom_model(device=None):
    return twin.MnistModel(compute_dtype=torch.float32).to(device)
'''


@pytest.fixture
def f32_mnist(tmp_path, monkeypatch):
    """Point both runners' dense flavour at f32 mnist twins."""
    from elasticdl_tpu.testing import data as jdata
    from elasticdl_tpu_torch.testing import data as tdata

    zoo = tmp_path / "zoo"
    ref = os.path.join(jdata.model_zoo_dir(), "mnist", "mnist_functional.py")
    for pkg, src in (("jax_f32", JAX_F32_MNIST),
                     ("port_f32", PORT_F32_MNIST)):
        (zoo / pkg).mkdir(parents=True)
        (zoo / pkg / "mnist.py").write_text(
            textwrap.dedent(src.replace("REF", repr(ref))))
    monkeypatch.setattr(jdata, "model_zoo_dir", lambda: str(zoo))
    monkeypatch.setattr(tdata, "model_zoo_dir", lambda: str(zoo))
    monkeypatch.setattr(jrunner, "DENSE_MODEL_DEF",
                        "jax_f32.mnist.custom_model")
    monkeypatch.setattr(trunner, "DENSE_MODEL_DEF",
                        "port_f32.mnist.custom_model")


@pytest.fixture
def jax_start(monkeypatch):
    """Records the first initial variables a JAX worker builds."""
    import elasticdl_tpu.core.train_state as jts
    import elasticdl_tpu.worker.worker as jworker

    seen = {}
    real = jts.init_train_state

    def init(*args, **kwargs):
        state = real(*args, **kwargs)
        seen.setdefault("variables", jax.tree.map(np.asarray, {
            "params": state.params,
            "batch_stats": getattr(state, "batch_stats", None) or {}}))
        return state

    monkeypatch.setattr(jts, "init_train_state", init)
    monkeypatch.setattr(jworker, "init_train_state", init)
    return seen


def _port_runner_from(start):
    class FromJaxStart(trunner.ChaosRunner):
        """Loads the JAX run's initial weights into the template model
        every worker of the job copies."""

        def _build_cluster(self, *args, **kwargs):
            cluster = super()._build_cluster(*args, **kwargs)
            variables = start["variables"]
            cluster.spec.model.load_state_dict(
                bridge.deepfm_state_dict_from_flax(variables["params"])
                if self.model == "sparse"
                else bridge.flax_state_dict(variables))
            return cluster

    return FromJaxStart


def _kw(**kw):
    out = dict(model="sparse", records=64, minibatch_size=8,
               num_minibatches_per_task=2, use_rpc=True, twin=True,
               join_timeout=90.0)
    out.update(kw)
    return out


def _elements(leaves, prefix):
    return sum(int(np.prod(shape)) for name, shape in leaves.items()
               if name.startswith(prefix))


def _comparable(report):
    report = copy.deepcopy(report)
    job = report["job"]
    loss = job.pop("final_loss")
    leaves = job.pop("dense_leaves")
    job["elements"] = {p: _elements(leaves, p)
                       for p in ("params", "batch_stats")}
    for verdict in report["invariants"]:
        verdict["details"] = re.sub(r"\d+ dense leaves", "N dense leaves",
                                    verdict["details"])
    return report, loss


@pytest.mark.parametrize("case", ["canonical", "in_process", "master_kill",
                                  "dense"])
def test_runner_report_equals_jax(case, tmp_path, jax_start, request):
    seed = 3
    plan = "master_kill_plan" if case == "master_kill" else "default_plan"
    kw = _kw(use_rpc=case != "in_process",
             model="dense" if case == "dense" else "sparse",
             twin=case in ("canonical", "dense"))
    if case == "dense":
        request.getfixturevalue("f32_mnist")
    want = jrunner.ChaosRunner(getattr(jfaults, plan)(seed),
                               workdir=str(tmp_path / "jax"), **kw).run()
    got = _port_runner_from(jax_start)(
        getattr(tfaults, plan)(seed), workdir=str(tmp_path / "port"),
        device="cpu", **kw).run()
    assert want["passed"], want
    got_cmp, got_loss = _comparable(got)
    want_cmp, want_loss = _comparable(want)
    assert got_cmp == want_cmp
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    assert got_cmp["job"]["elements"]["params"] > 0
    if case == "master_kill":
        from elasticdl_tpu_torch.tools.check_journal import check_journal

        assert got["fault_counts"]["master_kill"] == 2
        assert check_journal(
            str(tmp_path / "port" / "faulted" / "journal")) == []


def test_lost_task_regression_is_caught(tmp_path):
    plan = tfaults.FaultPlan(events=[tfaults.FaultEvent(
        kind="kill_worker", method="report_task_result", at_call=1,
    )], seed=5)
    report = trunner.ChaosRunner(
        plan, workdir=str(tmp_path / "w"), device="cpu",
        **_kw(records=32, twin=False, join_timeout=6.0),
        debug_disable_recovery=True).run()
    assert not report["passed"]
    verdict = {v["name"]: v for v in report["invariants"]}[
        "exactly_once_task_accounting"]
    assert not verdict["passed"]
    assert "did not drain" in verdict["details"]
    assert "LOST" in verdict["details"]
    dump = report["flight_recorder"]
    assert dump["capacity"] == 512
    names = {s["name"] for s in dump["spans"]}
    assert "task" in names and "device_step" in names


def test_corrupt_latest_checkpoint_caught_by_equivalence(tmp_path):
    plan = tfaults.FaultPlan(events=[
        tfaults.FaultEvent(kind="corrupt_checkpoint", target="state",
                           at_save=2, corrupt_mode="truncate"),
        tfaults.FaultEvent(kind="kill_worker", at_call=3),
    ], seed=13)
    report = trunner.ChaosRunner(plan, workdir=str(tmp_path / "w"),
                                 device="cpu", **_kw()).run()
    assert not report["passed"]
    names = {v["name"]: v for v in report["invariants"]}
    assert names["exactly_once_task_accounting"]["passed"]
    equivalence = names["loss_trajectory_equivalence"]
    assert not equivalence["passed"]
    assert ("version" in equivalence["details"]
            or "diverged" in equivalence["details"])


def test_same_seed_port_reports_are_byte_identical(tmp_path):
    first, second = (trunner.ChaosRunner(
        tfaults.default_plan(11), workdir=str(tmp_path / d), device="cpu",
        **_kw(twin=False)).run() for d in "ab")
    assert trunner.render_report(first) == trunner.render_report(second)
    assert first["passed"]


def test_replacement_worker_owns_a_fresh_model(tmp_path, monkeypatch):
    """A relaunched worker never trains the dead worker's module: its
    spec holds a copy of the template, filled from the checkpoint."""
    made = []
    real = trunner.ChaosRunner._make_replacement

    def spy(self, cluster, *args, **kwargs):
        worker = real(self, cluster, *args, **kwargs)
        made.append((worker, cluster))
        return worker

    monkeypatch.setattr(trunner.ChaosRunner, "_make_replacement", spy)
    report = trunner.ChaosRunner(
        tfaults.default_plan(0), workdir=str(tmp_path / "w"), device="cpu",
        **_kw(twin=False)).run()
    assert report["passed"] and len(made) == 1
    worker, cluster = made[0]
    dead = cluster.workers[0]
    assert worker._spec.model is not cluster.spec.model
    assert worker._spec.model is not dead._spec.model
    assert worker.state.model is worker._spec.model


def test_cli_runs_on_the_cpu_and_writes_into_its_workdir(tmp_path,
                                                        monkeypatch):
    from elasticdl_tpu_torch.api import client

    monkeypatch.chdir(tmp_path)
    work = tmp_path / "w"
    assert client.main(["chaos", "run", "--seed", "0", "--device", "cpu",
                        "--workdir", str(work), "--no_twin"]) == 0
    assert (work / trunner.DEFAULT_REPORT).exists()
    assert sorted(os.listdir(tmp_path)) == ["w"]
    assert trunner.main(["soak", "--seed", "1", "--rounds", "1",
                         "--device", "cpu", "--workdir", str(work),
                         "--no_twin", "--report",
                         str(tmp_path / "w" / "soak.json")]) == 0
