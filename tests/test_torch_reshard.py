"""Live resharding (elasticdl_tpu_torch/parallel/reshard.py,
``MeshRunner.resize``) and the worker's resize directive: the cases of
tests/test_autoscale.py:71-175 and :485-560 against the port, on
``[cpu] * n`` meshes.

A resize moves values without changing them, so every comparison here
is exact: a resized run is bit-equal to the unresized one (the dense
step is the same global program on the one device, and the slots are
gathered and split, never recomputed).
"""

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.checkpoint import state_io
from elasticdl_tpu_torch.parallel import mesh as tmesh
from elasticdl_tpu_torch.parallel import reshard
from elasticdl_tpu_torch.parallel import rules as rules_lib
from elasticdl_tpu_torch.parallel.mesh_runner import MeshRunner
from elasticdl_tpu_torch.parallel.zero import WholeSlots, ZeroOptimizer
from elasticdl_tpu_torch.testing.cluster import MiniCluster
from elasticdl_tpu_torch.testing.data import (
    create_mnist_record_file,
    model_zoo_dir,
)

CPU = torch.device("cpu")
MODEL_DEF = "mnist.mnist_functional.custom_model"


def _mesh(n):
    return tmesh.make_mesh((n,), ("dp",), [CPU] * n)


class Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.hidden = torch.nn.Linear(4, 16)
        self.out = torch.nn.Linear(16, 1)

    def forward(self, x):
        return self.out(torch.relu(self.hidden(x)))[..., 0]


def _sq_loss(labels, preds, mask):
    per = (preds - labels) ** 2
    return (per * mask).sum() / mask.sum().clamp_min(1.0)


def _runner_and_state(n):
    torch.manual_seed(0)
    runner = MeshRunner(mesh=_mesh(n))
    state = runner.init_state(
        Tiny(), lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.9))
    return runner, state


def _batches(n):
    out = []
    for s in range(n):
        r = np.random.RandomState(100 + s)
        out.append({"features": r.rand(8, 4).astype(np.float32),
                    "labels": r.rand(8).astype(np.float32),
                    "mask": np.ones((8,), np.float32)})
    return out


def test_resize_preserves_values_and_moves_mesh():
    runner, state = _runner_and_state(4)
    state, _ = runner.train_step(_sq_loss)(state, _batches(1)[0])
    before = state_io.named_leaves_from_state(state)
    state = runner.resize(_mesh(2), state)
    assert runner.mesh.shape == {"dp": 2}
    # The optimizer's slots (ZeRO-split) moved too.
    assert state.optimizer.num_entries == 2
    assert all(s.mesh == _mesh(2)
               for s in state.optimizer.shardings.values())
    after = state_io.named_leaves_from_state(state)
    assert before.keys() == after.keys()
    for key in before:
        np.testing.assert_array_equal(before[key], after[key], err_msg=key)


def test_resize_pre_init_retargets_runner():
    fresh = MeshRunner(mesh=_mesh(4))
    assert fresh.resize(_mesh(2), None) is None
    assert fresh.mesh.shape == {"dp": 2}
    state = fresh.init_state(Tiny(), lambda p: torch.optim.SGD(p, lr=0.1))
    assert state.optimizer.num_entries == 2


def test_trajectory_equal_across_round_trip():
    """dp4 -> dp2 -> dp4 live against an unresized dp4 control: the same
    losses and parameters, bit for bit."""
    data = _batches(6)
    runner, state = _runner_and_state(4)
    step = runner.train_step(_sq_loss)
    control = []
    for b in data:
        state, m = step(state, b)
        control.append(m["loss"])
    runner2, state2 = _runner_and_state(4)
    losses = []
    for lo, hi, n in ((0, 2, 2), (2, 4, 4), (4, 6, None)):
        step2 = runner2.train_step(_sq_loss)
        for b in data[lo:hi]:
            state2, m = step2(state2, b)
            losses.append(m["loss"])
        if n is not None:
            state2 = runner2.resize(_mesh(n), state2)
    torch.testing.assert_close(torch.stack(losses), torch.stack(control),
                               rtol=0, atol=0)
    for a, b in zip(state.model.parameters(), state2.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_step_memo_reused_on_return_to_known_mesh():
    runner, state = _runner_and_state(4)
    batch = _batches(1)[0]
    step4 = runner.train_step(_sq_loss)
    state, _ = step4(state, batch)
    state = runner.resize(_mesh(2), state)
    step2 = runner.train_step(_sq_loss)
    assert step2 is not step4
    state, _ = step2(state, batch)
    state = runner.resize(_mesh(4), state)
    assert runner.train_step(_sq_loss) is step4


def test_host_bounce_fallback_gives_the_same_state(monkeypatch):
    """When the on-device gather/split cannot allocate
    (``torch.OutOfMemoryError``), live_reshard logs it, gathers every
    placed leaf to the host (the device shards released) and places from
    there."""
    runner, state = _runner_and_state(4)
    state, _ = runner.train_step(_sq_loss)(state, _batches(1)[0])
    want = state_io.named_leaves_from_state(state)
    calls, warned = [], []
    monkeypatch.setattr(reshard.logger, "warning",
                        lambda msg, *args: warned.append(msg % args))
    real_place = runner.place_state

    def flaky_place(s):
        calls.append(type(s.optimizer))
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (simulated)")
        return real_place(s)

    monkeypatch.setattr(runner, "place_state", flaky_place)
    state = runner.resize(_mesh(2), state)
    assert calls == [ZeroOptimizer, WholeSlots]
    assert len(warned) == 1 and "host bounce" in warned[0]
    assert state.optimizer.num_entries == 2
    for key, value in state_io.named_leaves_from_state(state).items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)


def _assert_on_dp4_as_unresized(runner, state, want):
    """``state`` is back on dp4 with the values ``want`` held, and two
    more steps stay bit-equal to an unresized run's."""
    assert runner.mesh == _mesh(4)
    assert isinstance(state.optimizer, ZeroOptimizer)
    assert state.optimizer.num_entries == 4
    assert all(s.mesh == _mesh(4)
               for s in state.optimizer.shardings.values())
    for key, value in state_io.named_leaves_from_state(state).items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)
    control_runner, control = _runner_and_state(4)
    batches = _batches(3)
    control, _ = control_runner.train_step(_sq_loss)(control, batches[0])
    for batch in batches[1:]:
        state, m = runner.train_step(_sq_loss)(state, batch)
        control, mc = control_runner.train_step(_sq_loss)(control, batch)
        assert m["loss"].item() == mc["loss"].item()
    for a, b in zip(state.model.parameters(), control.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("error", [torch.OutOfMemoryError, RuntimeError])
def test_failed_placement_puts_the_state_back(monkeypatch, error):
    """A placement on the new mesh that fails (out of memory twice, on
    the card and after the host bounce; or any other error, which takes
    no bounce) raises, and the runner and the state are back on the old
    mesh with every value kept: training goes on as if no resize had
    been asked for."""
    runner, state = _runner_and_state(4)
    state, _ = runner.train_step(_sq_loss)(state, _batches(1)[0])
    want = state_io.named_leaves_from_state(state)
    real_place = runner.place_state
    seen = []

    def failing_place(s):
        seen.append(type(s.optimizer))
        if runner.mesh == _mesh(2):
            raise error("simulated failure on the new mesh")
        return real_place(s)

    monkeypatch.setattr(runner, "place_state", failing_place)
    with pytest.raises(error, match="simulated"):
        runner.resize(_mesh(2), state)
    bounced = error is torch.OutOfMemoryError
    assert seen == ([ZeroOptimizer, WholeSlots, WholeSlots] if bounced
                    else [ZeroOptimizer, ZeroOptimizer])
    _assert_on_dp4_as_unresized(runner, state, want)


def test_refused_placement_changes_nothing(monkeypatch):
    """A new mesh whose rule the port refuses (a spec naming one axis
    twice, as JAX's NamedSharding refuses it) raises before anything
    moves: no placement, no host bounce, the same optimizer object, the
    runner on its old mesh."""
    def factory(m):
        def rule(name, leaf):
            if name == "hidden.weight" and "tp" in m.shape:
                return rules_lib.PartitionSpec("tp", "tp")
            return rules_lib.PartitionSpec()
        return rule

    torch.manual_seed(0)
    runner = MeshRunner(mesh=_mesh(4), param_rule_factory=factory)
    state = runner.init_state(
        Tiny(), lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.9))
    state, _ = runner.train_step(_sq_loss)(state, _batches(1)[0])
    want = state_io.named_leaves_from_state(state)
    optimizer = state.optimizer

    def no_bounce(s):
        raise AssertionError("the host bounce ran")

    monkeypatch.setattr(reshard, "gather_to_host", no_bounce)
    tp_mesh = tmesh.make_mesh((2, 2), ("dp", "tp"), [CPU] * 4)
    with pytest.raises(ValueError, match="twice"):
        runner.resize(tp_mesh, state)
    assert state.optimizer is optimizer
    _assert_on_dp4_as_unresized(runner, state, want)


def test_reshard_state_and_abstract_like():
    runner, state = _runner_and_state(4)
    state, _ = runner.train_step(_sq_loss)(state, _batches(1)[0])
    leaves = state_io.named_leaves_from_state(state)
    shapes = reshard.abstract_like(state)
    assert shapes["params.hidden.weight"][0] == (16, 4)
    runner2, fresh = _runner_and_state(2)
    fresh = reshard.reshard_state(fresh, leaves, runner2.place_state)
    assert fresh.optimizer.num_entries == 2
    for key, value in state_io.named_leaves_from_state(fresh).items():
        np.testing.assert_array_equal(value, leaves[key], err_msg=key)


def test_mesh_spec_round_trip():
    spec = reshard.mesh_spec(_mesh(4))
    assert spec == {"shape": [4], "axes": ["dp"]}
    rebuilt = reshard.mesh_from_spec(spec, device="cpu")
    assert rebuilt.shape == {"dp": 4} and rebuilt == _mesh(4)


def test_mesh_from_spec_rejects_oversized():
    with pytest.raises(ValueError, match="device"):
        reshard.mesh_from_spec({"shape": [5], "axes": ["dp"]},
                               devices=[CPU] * 4)


# ---- the worker (tests/test_autoscale.py:485-560) -------------------------


@pytest.fixture
def mnist_train(tmp_path):
    return create_mnist_record_file(str(tmp_path / "t.rec"), 192, seed=3)


def _cluster(mnist_train, on_report):
    return MiniCluster(
        model_zoo=model_zoo_dir(), model_def=MODEL_DEF,
        training_data=mnist_train, minibatch_size=16,
        num_minibatches_per_task=2, mesh=_mesh(4), device="cpu",
        worker_callbacks={"report_task_result": on_report})


def test_worker_applies_resize_at_task_boundary(mnist_train):
    """The directive piggybacks on get_task, the worker reshards between
    tasks, acks, the barrier completes, and the job drains on the new
    mesh; worker_resize_seconds observes the apply."""
    from elasticdl_tpu_torch.observability import default_registry

    reports = {"n": 0}
    box = {}

    def on_report(request):
        reports["n"] += 1
        if reports["n"] == 2:
            box["rid"] = box["cluster"].begin_resize(_mesh(2),
                                                     direction="shrink")

    cluster = _cluster(mnist_train, on_report)
    box["cluster"] = cluster
    hist = default_registry().histogram(
        "worker_resize_seconds",
        "Live reshard latency: gather + re-place + step rebuild")

    def count():
        series = hist.snapshot()["series"]
        return series[0]["count"] if series else 0

    before = count()
    results = cluster.run()
    assert cluster.finished
    assert np.isfinite(results[0]["final_loss"])
    worker = cluster.workers[0]
    assert isinstance(worker.state.optimizer, ZeroOptimizer)
    assert worker.state.optimizer.num_entries == 2
    assert worker._step_runner.mesh.shape == {"dp": 2}
    assert worker._applied_resize_id == box["rid"]
    assert cluster.servicer.resize_status() is None
    assert count() == before + 1


def test_directive_arriving_with_finished_response_still_acked(mnist_train):
    total_tasks = 192 // 32
    reports = {"n": 0}
    box = {}

    def on_report(request):
        reports["n"] += 1
        if reports["n"] == total_tasks:
            box["rid"] = box["cluster"].begin_resize(_mesh(2),
                                                     direction="shrink")

    cluster = _cluster(mnist_train, on_report)
    box["cluster"] = cluster
    cluster.run()
    assert cluster.finished
    assert "rid" in box
    assert cluster.servicer.resize_status() is None
    assert cluster.workers[0].state.optimizer.num_entries == 2


def test_failed_apply_acks_failed_and_stays_on_the_mesh(mnist_train,
                                                        monkeypatch):
    """A resize whose placement on the new mesh fails (out of memory on
    the device and again after the host bounce) acks "failed", puts the
    state back on the old mesh and does not record the id (a re-offer
    tries again); the tasks after it train on the old mesh, bit-equal to
    a job that was never asked to resize."""
    from elasticdl_tpu_torch.parallel.mesh_runner import MeshRunner as MR

    control = _cluster(mnist_train, lambda request: None)
    control.run()
    reports = {"n": 0}
    box = {}

    def on_report(request):
        reports["n"] += 1
        if reports["n"] == 2:
            box["rid"] = box["cluster"].begin_resize(_mesh(2))

    cluster = _cluster(mnist_train, on_report)
    box["cluster"] = cluster
    worker = cluster.workers[0]
    acks, failed_on = [], []
    real_ack = worker._master.report_resize

    def ack(resize_id, status, *args, **kwargs):
        acks.append(status)
        return real_ack(resize_id, status, *args, **kwargs)

    real_zero = MR._zero

    def zero(self, model, slots=None):
        if self.mesh.shape == {"dp": 2}:
            failed_on.append(type(worker.state.optimizer).__name__)
            raise torch.OutOfMemoryError("simulated: the card is full")
        return real_zero(self, model, slots)

    monkeypatch.setattr(worker._master, "report_resize", ack)
    monkeypatch.setattr(MR, "_zero", zero)
    cluster.run()
    assert cluster.finished
    assert acks and set(acks) == {"failed"}
    assert failed_on[:2] == ["ZeroOptimizer", "WholeSlots"]
    assert worker._applied_resize_id != box["rid"]
    assert worker._step_runner.mesh.shape == {"dp": 4}
    assert worker.state.optimizer.num_entries == 4
    got = state_io.named_leaves_from_state(worker.state)
    want = state_io.named_leaves_from_state(control.workers[0].state)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
