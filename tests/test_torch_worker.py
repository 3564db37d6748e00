"""The port's worker on the port's master, in process (``testing/
cluster.MiniCluster``): jobs drain, workers share one queue, a crashed
task is re-queued and every record still counts, a predict job hands
every row to the processor; the recsys ranker trained through the
worker is bit-equal to the port's Local executor (and the fused task
path to the stepwise one); deepfm_host trains through the worker's
pull-ahead; a raising step fails its task with its reason reported; and
the port's MiniCluster matches the JAX MiniCluster from the same initial
weights (f32 transformer: final loss and the master's eval metrics at
rtol 1e-4, as the Local executors' parity test holds them).
"""

import os
import textwrap

import jax
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.core.model_spec import get_model_spec as jax_spec
from elasticdl_tpu.core.train_state import init_train_state as jax_init
from elasticdl_tpu.testing.cluster import MiniCluster as JaxMiniCluster
from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.api.local_executor import LocalExecutor
from elasticdl_tpu_torch.common.constants import TaskType
from elasticdl_tpu_torch.testing import data as tdata
from elasticdl_tpu_torch.testing.cluster import MiniCluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST = "mnist.mnist_functional.custom_model"


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    root = tmp_path_factory.mktemp("mnist")
    return {
        "train": tdata.create_mnist_record_file(str(root / "t.rec"), 128,
                                                seed=1),
        "eval": tdata.create_mnist_record_file(str(root / "e.rec"), 32,
                                               seed=2),
    }


def _cluster(model_def=MNIST, zoo=None, **kwargs):
    kwargs.setdefault("minibatch_size", 16)
    return MiniCluster(zoo or tdata.model_zoo_dir(), model_def,
                       device="cpu", **kwargs)


def test_port_mnist_job_drains_with_eval_rounds(mnist):
    cluster = _cluster(training_data=mnist["train"],
                       validation_data=mnist["eval"], num_epochs=2,
                       eval_steps=8)
    results = cluster.run()
    assert cluster.finished
    assert results[0]["trained_batches"] == results[0]["final_version"] == 16
    assert np.isfinite(results[0]["final_loss"])
    # Step-based trigger fired at versions 8 and 16 and the master
    # computed the metrics.
    assert sorted(cluster.eval_service.completed_results) == [8, 16]
    assert cluster.dispatcher.counters.total_records == {
        TaskType.TRAINING: 256, TaskType.EVALUATION: 64}


def test_port_workers_share_one_queue(mnist):
    cluster = _cluster(training_data=mnist["train"], num_workers=2,
                       num_epochs=2)
    results = cluster.run()
    assert cluster.finished
    assert sum(r["trained_batches"] for r in results) == 16
    assert cluster.dispatcher.counters.total_records[
        TaskType.TRAINING] == 256


def test_port_crash_mid_task_is_requeued(mnist):
    crashes = {"left": 2}
    reasons = []
    cluster = _cluster(
        training_data=mnist["train"],
        worker_callbacks={"report_task_result": lambda r: reasons.append(
            r["err_reason"])})
    dataset_fn = cluster.spec.dataset_fn

    def flaky(records, mode, metadata):
        if crashes["left"] > 0:
            crashes["left"] -= 1
            raise RuntimeError("injected crash")
        return dataset_fn(records, mode, metadata)

    for worker in cluster.workers:
        worker._task_data._dataset_fn = flaky
    results = cluster.run()
    assert cluster.finished and crashes["left"] == 0
    assert [r for r in reasons if r] == ["RuntimeError: injected crash"] * 2
    assert cluster.dispatcher.counters.total_records[
        TaskType.TRAINING] == 128
    assert results[0]["trained_batches"] == 8


def test_port_prediction_job_hands_every_row_over(mnist):
    collected = []

    class Collector:
        def process(self, outputs, worker_id):
            collected.append(np.asarray(outputs))

    cluster = _cluster(prediction_data=mnist["train"])
    for worker in cluster.workers:
        worker._processor = Collector()
    cluster.run()
    assert cluster.finished
    assert sum(arr.shape[0] for arr in collected) == 128
    assert all(arr.dtype == np.float32 and arr.shape[1:] == (10,)
               for arr in collected)


class _FailingRunner:
    """A step runner whose train step raises at its ``fail_at``-th call
    (1-based), delegating everything else."""

    def __init__(self, inner, fail_at):
        self._inner = inner
        self._fail_at = fail_at
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def train_step(self, loss_fn):
        step = self._inner.train_step(loss_fn)

        def wrapped(state, batch):
            self.calls += 1
            if self.calls == self._fail_at:
                raise RuntimeError("injected step failure")
            return step(state, batch)

        return wrapped


def test_port_raising_step_fails_its_task_with_the_reason(mnist):
    """A step that raises is not retried in place: its task fails, the
    master hears why, re-queues it, and the job still drains."""
    from elasticdl_tpu_torch.parallel.mesh_runner import MeshRunner
    from elasticdl_tpu_torch.parallel.mesh import make_mesh

    reasons = []
    runner = _FailingRunner(
        MeshRunner(make_mesh((1,), ("dp",), [torch.device("cpu")])),
        fail_at=3)
    cluster = _cluster(
        training_data=mnist["train"],
        step_runner_factory=lambda: runner,
        worker_callbacks={"report_task_result": lambda r: reasons.append(
            (r["task_id"], r["err_reason"]))})
    results = cluster.run()
    assert cluster.finished
    failed = [r for r in reasons if r[1]]
    assert failed == [(2, "RuntimeError: injected step failure")]
    # The failed task went back to the front and was trained again.
    assert cluster.dispatcher.counters.total_records[
        TaskType.TRAINING] == 128
    assert cluster.dispatcher.counters.failed_records == {}
    assert results[0]["trained_batches"] == 8
    assert runner.calls == 8 + 1


@pytest.mark.parametrize("fuse", [False, True], ids=["stepwise", "fused"])
def test_port_version_report_steps_thin_eval_rounds(mnist, fuse):
    """--get_model_steps as version_report_steps: 8 steps with 4 report
    exactly versions 4 and 8, and the master opens eval rounds only at
    reported versions (eval_steps=1 would otherwise fire every step)."""
    reported = []
    cluster = _cluster(
        training_data=mnist["train"], validation_data=mnist["eval"],
        eval_steps=1, version_report_steps=4, fuse_task_steps=fuse,
        worker_callbacks={"report_version": lambda r: reported.append(
            r["model_version"])})
    cluster.run()
    assert reported == [4, 8]
    assert cluster.eval_service.completed_results
    assert set(cluster.eval_service.completed_results) <= {4, 8}


def test_port_worker_checkpoints_and_resumes(mnist, tmp_path):
    """Worker 0's checkpoint hook saves every 4 versions and at the end;
    a new cluster booting from the directory starts from the saved
    version, its state bit-equal to the saved one."""
    from elasticdl_tpu_torch.checkpoint import named_leaves_from_state

    ckpt = str(tmp_path / "ckpt")
    first = _cluster(training_data=mnist["train"], checkpoint_dir=ckpt,
                     checkpoint_steps=4)
    first.run()
    assert sorted(os.listdir(ckpt)) == ["version-4", "version-8"]
    saved = named_leaves_from_state(first.workers[0].state)
    second = _cluster(training_data=mnist["train"],
                      checkpoint_dir_for_init=ckpt)
    worker = second.workers[0]
    seen = {}
    init = worker._maybe_init

    def maybe_init(batch):
        first_call = worker.state is None
        init(batch)
        if first_call:
            seen.update(named_leaves_from_state(worker.state))

    worker._maybe_init = maybe_init
    result = second.run()[0]
    assert result["final_version"] == 16
    assert sorted(seen) == sorted(saved)
    for name in saved:
        np.testing.assert_array_equal(np.asarray(seen[name]),
                                      np.asarray(saved[name]), err_msg=name)


# ---- the recsys ranker: worker against the Local executor ------------------

RECSYS_ZOO = '''
from elasticdl_tpu_torch.embedding.device_sparse import (
    DeviceSparseRunner, TableSpec)
from elasticdl_tpu_torch.embedding.optimizer import Adagrad
from elasticdl_tpu_torch.model_zoo.recsys import recsys_sparse as twin
from elasticdl_tpu_torch.model_zoo.recsys.recsys_sparse import (  # noqa
    dataset_fn, eval_metrics_fn, loss, optimizer)

SPECS = (TableSpec(twin.TABLE_NAME, vocab=1024, dim=16,
                   feature_key=twin.FEATURE_KEY),)


def custom_model(device=None):
    return twin.RecsysRanker(emb_dim=16).to(device)


def make_sparse_runner():
    return DeviceSparseRunner(SPECS, Adagrad(lr=0.05), use_pallas="always")
'''
RECSYS_IDS, RECSYS_BATCH = 8, 16


@pytest.fixture(scope="module")
def recsys(tmp_path_factory):
    root = tmp_path_factory.mktemp("recsys")
    zoo = root / "zoo" / "small"
    zoo.mkdir(parents=True)
    (zoo / "rec.py").write_text(textwrap.dedent(RECSYS_ZOO))
    train = tdata.create_frappe_record_file(
        str(root / "train.rec"), 128, seed=3, input_length=RECSYS_IDS,
        max_id=1024)
    evalf = tdata.create_frappe_record_file(
        str(root / "eval.rec"), 48, seed=4, input_length=RECSYS_IDS,
        max_id=1024)
    return str(root / "zoo"), train, evalf


def _sparse_state(state):
    leaves = {f"dense.{k}": v.detach().clone()
              for k, v in state.model.state_dict().items()}
    for name, table in state.tables.items():
        leaves[f"table.{name}"] = table.clone()
        for slot, t in state.slot_tables[name].items():
            leaves[f"slot.{name}.{slot}"] = t.clone()
    return leaves


def _assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("fuse", [False, True], ids=["stepwise", "fused"])
def test_recsys_worker_is_bit_equal_to_local(recsys, fuse):
    """The same records in the same order through the worker (tasks of
    2 minibatches, no shuffle, eval every 4 versions) and through the
    Local executor (one pass, eval every 4 steps): every leaf of the
    final state (MLP, table, accumulator) bit-equal, the final loss
    equal, and the master's accuracy at each round equal to the Local
    executor's eval at the same step."""
    zoo, train, evalf = recsys
    model_def = "small.rec.custom_model"
    args = tdata.make_local_args(
        zoo, model_def, train, validation_data=evalf,
        minibatch_size=RECSYS_BATCH,
        extra=["--device", "cpu", "--evaluation_steps", "4"])
    local = LocalExecutor(args)
    local_evals = []
    real_evaluate = local.evaluate

    def evaluate():
        result = real_evaluate()
        local_evals.append(result)
        return result

    local.evaluate = evaluate
    want = local.run()
    cluster = MiniCluster(zoo, model_def, training_data=train,
                          validation_data=evalf,
                          minibatch_size=RECSYS_BATCH, eval_steps=4,
                          fuse_task_steps=fuse, device="cpu")
    got = cluster.run()[0]
    assert got["trained_batches"] == want["steps"] == 8
    assert got["final_loss"] == want["final_loss"]
    _assert_bit_equal(_sparse_state(cluster.workers[0].state),
                      _sparse_state(local.state))
    results = cluster.eval_service.completed_results
    # A fused task reports its version once, at its end (2, 4, 6, 8):
    # the rounds open at the same versions as stepwise.
    assert sorted(results) == [4, 8]
    assert results[4] == local_evals[0]
    assert results[8] == local_evals[-1] == want["eval_metrics"]


def test_deepfm_host_trains_through_the_worker(tmp_path):
    """The zoo's host runner (async apply, so the worker pulls rows
    ahead and flushes the applier at each task's end) through the
    worker: the job drains, every record counts, the loss is finite,
    and the host table holds rows."""
    train = tdata.create_frappe_record_file(
        str(tmp_path / "t.rec"), 256, seed=5, input_length=10,
        max_id=5500)
    cluster = _cluster("deepfm.deepfm_host.custom_model",
                       training_data=train, minibatch_size=32,
                       num_minibatches_per_task=4)
    worker = cluster.workers[0]
    assert worker._step_runner.pull_ahead
    results = cluster.run()
    assert cluster.finished
    assert results[0]["trained_batches"] == 8
    assert np.isfinite(results[0]["final_loss"])
    assert cluster.dispatcher.counters.total_records[
        TaskType.TRAINING] == 256
    table = worker._step_runner.engine.tables["deepfm_host_embedding"]
    ids, rows = table.to_arrays()
    assert len(ids) > 0 and np.isfinite(rows).all()


# ---- the port's MiniCluster against the JAX MiniCluster --------------------

SEQ, VOCAB, BATCH = 32, 256, 16
JAX_ZOO = '''
import jax.numpy as jnp

from elasticdl_tpu.core.model_spec import load_module
from elasticdl_tpu.models.transformer import TransformerConfig, TransformerLM

_ref = load_module(REF_PATH)
loss, optimizer = _ref.loss, _ref.optimizer
dataset_fn, eval_metrics_fn = _ref.dataset_fn, _ref.eval_metrics_fn
CONFIG = TransformerConfig(vocab_size=256, d_model=64, n_heads=2,
                           n_layers=2, d_ff=128, max_len=32,
                           compute_dtype=jnp.float32)


def custom_model(mesh=None):
    return TransformerLM(CONFIG)
'''.replace("REF_PATH", repr(os.path.join(
    REPO, "model_zoo", "transformer", "transformer_lm.py")))
PORT_ZOO = '''
import torch

from elasticdl_tpu_torch.model_zoo.transformer import transformer_lm as twin
from elasticdl_tpu_torch.model_zoo.transformer.transformer_lm import (
    dataset_fn, eval_metrics_fn, loss, optimizer)
from elasticdl_tpu_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(vocab_size=256, d_model=64, n_heads=2,
                           n_layers=2, d_ff=128, max_len=32,
                           compute_dtype=torch.float32)


def custom_model(device=None):
    return twin.custom_model(config=CONFIG, device=device)
'''


def test_port_cluster_matches_jax_cluster(tmp_path):
    zoo = tmp_path / "zoo"
    for name, src in (("jax_tiny", JAX_ZOO), ("port_tiny", PORT_ZOO)):
        (zoo / name).mkdir(parents=True)
        (zoo / name / "lm.py").write_text(textwrap.dedent(src))
    train = tdata.create_lm_record_file(str(tmp_path / "train.rec"), 128,
                                        seed=1, seq_len=SEQ, vocab=VOCAB)
    evalf = tdata.create_lm_record_file(str(tmp_path / "eval.rec"), 32,
                                        seed=2, seq_len=SEQ, vocab=VOCAB)
    common = dict(training_data=train, validation_data=evalf,
                  minibatch_size=BATCH, eval_steps=8)
    jax_cluster = JaxMiniCluster(str(zoo), "jax_tiny.lm.custom_model",
                                 **common)
    want = jax_cluster.run()[0]
    # The JAX worker's initial params (init_train_state, seed 0), carried
    # into the port's model before its first step.
    spec = jax_spec(str(zoo), "jax_tiny.lm.custom_model")
    batch = {"features": np.zeros((BATCH, SEQ), np.int32)}
    params = jax.tree.map(np.asarray, jax_init(
        spec.model, optax.adam(1e-3), batch, seed=0).params)
    cluster = MiniCluster(str(zoo), "port_tiny.lm.custom_model",
                          device="cpu", **common)
    cluster.spec.model.load_state_dict(bridge.state_dict_from_flax(params))
    got = cluster.run()[0]
    assert got["trained_batches"] == want["trained_batches"] == 8
    assert got["final_version"] == want["final_version"] == 8
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-4)
    gm = cluster.eval_service.completed_results[8]
    wm = jax_cluster.eval_service.completed_results[8]
    np.testing.assert_allclose(gm["perplexity"], wm["perplexity"],
                               rtol=1e-4)
    assert abs(gm["token_accuracy"] - wm["token_accuracy"]) <= 2 / (32 * SEQ)
    for counters in (cluster.dispatcher.counters,
                     jax_cluster.dispatcher.counters):
        assert counters.total_records[TaskType.TRAINING] == 128
        assert counters.total_records[TaskType.EVALUATION] == 32
