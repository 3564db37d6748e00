"""Checkpoint and resume through the port's Local executor, on the CPU.

A straight run over records A then B against a split run: A with
``--checkpoint_dir`` and ``--checkpoint_steps``, then a NEW executor with
``--checkpoint_dir_for_init`` over B. The Local executor reads its data
from the start on resume (no task fast-forward, in either package), so
B is a file of its own and A holds whole batches: the two runs see the
same batches in the same order. On the CPU every op is deterministic,
so the resumed run must be BIT-equal to the straight one: the losses
and every leaf of the state (parameters, optimizer slots, statistics,
the dropout generator, the step, the device-tier tables, their slots
and apply counts) and the host tables, for

- the transformer twin with dropout (the generator's state);
- mnist_functional (BatchNorm statistics);
- census_wide_deep under its LearningRateScheduler, its version axis
  compressed so the schedule's steps fall inside the run (the schedule's
  position is not in the optimizer's state);
- the recsys twin at 100,000 x 64 (the device-tier sparse plane, its
  kernels pinned: the plain versions on the CPU);
- deepfm_host with ``--checkpoint_delta_chain 2`` (host tables through
  a base and two deltas).

Also: a restore writes into the live tensors and never rebinds one; a
corrupt newest version falls back to the one before; and an empty
``--checkpoint_dir_for_init`` raises FileNotFoundError, as in JAX.
"""

import os
import shutil
import textwrap

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.api.local_executor import LocalExecutor
from elasticdl_tpu_torch.callbacks import Callback
from elasticdl_tpu_torch.checkpoint import (
    CheckpointSaver,
    named_leaves_from_state,
)
from elasticdl_tpu_torch.testing import data as tdata

TRANSFORMER_ZOO = '''
import torch

from elasticdl_tpu_torch.model_zoo.transformer import transformer_lm as twin
from elasticdl_tpu_torch.model_zoo.transformer.transformer_lm import (  # noqa
    dataset_fn, eval_metrics_fn, loss, optimizer)
from elasticdl_tpu_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                           d_ff=64, max_len=16, dropout_rate=0.1,
                           compute_dtype=torch.float32)


def custom_model(device=None):
    return twin.custom_model(config=CONFIG, device=device)
'''
# census_wide_deep with the zoo's own schedule read at 2500x the
# version: its steps (5000 and 12000) land at versions 2 and 5.
CENSUS_ZOO = '''
from elasticdl_tpu_torch.callbacks import LearningRateScheduler
from elasticdl_tpu_torch.model_zoo.census import census_wide_deep as twin
from elasticdl_tpu_torch.model_zoo.census.census_wide_deep import (  # noqa
    custom_model, dataset_fn, eval_metrics_fn, loss, optimizer)


def callbacks():
    return [LearningRateScheduler(lambda v: twin.lr_multiplier(2500 * v))]
'''
RECSYS_ZOO = '''
from elasticdl_tpu_torch.embedding.device_sparse import (
    DeviceSparseRunner, TableSpec)
from elasticdl_tpu_torch.embedding.optimizer import Adagrad
from elasticdl_tpu_torch.model_zoo.recsys import recsys_sparse as twin
from elasticdl_tpu_torch.model_zoo.recsys.recsys_sparse import (  # noqa
    dataset_fn, eval_metrics_fn, loss, optimizer)

SPECS = (TableSpec(twin.TABLE_NAME, vocab=100_000, dim=64,
                   feature_key=twin.FEATURE_KEY),)


def custom_model(device=None):
    return twin.RecsysRanker(emb_dim=64).to(device)


def make_sparse_runner():
    return DeviceSparseRunner(SPECS, Adagrad(lr=0.05), use_pallas="always")
'''
# The host twin with its rows applied synchronously: under async apply a
# pull may read a shared row one apply behind, so two runs may differ.
HOST_ZOO = '''
from elasticdl_tpu_torch.embedding.host_engine import HostStepRunner
from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin
from elasticdl_tpu_torch.model_zoo.deepfm.deepfm_host import (  # noqa
    custom_model, dataset_fn, eval_metrics_fn, loss, optimizer)


def make_host_runner():
    return HostStepRunner(twin.make_host_runner().engine, async_apply=False)
'''

# name -> (zoo source or None for the repo's zoo, model_def, records(path,
# n, seed), batch, batches in A, batches in B, checkpoint flags)
MODELS = {
    "transformer": (
        TRANSFORMER_ZOO, "tiny.m.custom_model",
        lambda p, n, s: tdata.create_lm_record_file(p, n, seed=s, seq_len=16,
                                                    vocab=64),
        8, 4, 3, ["--checkpoint_steps", "2"]),
    "mnist_functional": (
        None, "mnist.mnist_functional.custom_model",
        lambda p, n, s: tdata.create_mnist_record_file(p, n, seed=s),
        16, 3, 2, ["--checkpoint_steps", "3"]),
    "census_wide_deep": (
        CENSUS_ZOO, "tiny.m.custom_model",
        lambda p, n, s: tdata.create_census_record_file(p, n, seed=s),
        32, 3, 3, ["--checkpoint_steps", "3"]),
    "recsys": (
        RECSYS_ZOO, "tiny.m.custom_model",
        lambda p, n, s: tdata.create_frappe_record_file(
            p, n, seed=s, input_length=32, max_id=100_000),
        32, 3, 2, ["--checkpoint_steps", "3"]),
    "deepfm_host": (
        HOST_ZOO, "tiny.m.custom_model",
        lambda p, n, s: tdata.create_frappe_record_file(
            p, n, seed=s, input_length=10, max_id=5500),
        32, 6, 2, ["--checkpoint_steps", "2", "--checkpoint_delta_chain",
                   "2"]),
}


class Recorder(Callback):
    """Per-step losses and learning rates."""

    def __init__(self):
        self.losses, self.lrs = [], []

    def on_train_batch_begin(self, owner=None):
        self.lrs.append(owner.state.optimizer.param_groups[0]["lr"])

    def on_train_batch_end(self, owner=None, metrics=None):
        self.losses.append(float(metrics["loss"]))


def _setup(name, tmp_path):
    source, model_def, make, batch, n_a, n_b, flags = MODELS[name]
    zoo = tdata.model_zoo_dir()
    if source is not None:
        zoo = str(tmp_path / "zoo")
        os.makedirs(os.path.join(zoo, "tiny"))
        with open(os.path.join(zoo, "tiny", "m.py"), "w") as f:
            f.write(textwrap.dedent(source))
    both = tmp_path / "ab"
    both.mkdir()
    a = make(str(both / "a.rec"), batch * n_a, 1)
    b = make(str(both / "b.rec"), batch * n_b, 2)
    split = tmp_path / "split"
    split.mkdir()
    shutil.copy(a, split / "a.rec")
    shutil.copy(b, split / "b.rec")
    return zoo, model_def, batch, str(both), str(split / "a.rec"), \
        str(split / "b.rec"), flags


def _run(zoo, model_def, data, batch, extra):
    args = tdata.make_local_args(zoo, model_def, data, minibatch_size=batch,
                                 extra=["--device", "cpu"] + extra)
    record = Recorder()
    executor = LocalExecutor(args, callbacks=[record])
    executor.run()
    return executor, record


def _assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


def _host_tables(executor):
    runner = executor._step_runner
    if not hasattr(runner, "host_tables"):
        return {}
    return {name: np.concatenate([ids[:, None].astype(np.float64),
                                  rows.astype(np.float64)], axis=1)
            for name, (ids, rows) in (
                (n, t.to_arrays()) for n, t in runner.host_tables.items())}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_split_run_is_bit_equal_to_straight_run(name, tmp_path):
    zoo, model_def, batch, both, a, b, flags = _setup(name, tmp_path)
    ckpt = str(tmp_path / "ckpt")
    straight, want = _run(zoo, model_def, both, batch, [])
    first, got_a = _run(zoo, model_def, a, batch,
                        ["--checkpoint_dir", ckpt] + flags)
    resumed, got_b = _run(zoo, model_def, b, batch,
                          ["--checkpoint_dir_for_init", ckpt])
    n_a = MODELS[name][4]
    assert first.state.step == n_a
    assert resumed.state.step == straight.state.step == n_a + MODELS[name][5]
    assert got_a.losses + got_b.losses == want.losses
    assert got_a.lrs + got_b.lrs == want.lrs
    _assert_bit_equal(named_leaves_from_state(resumed.state),
                      named_leaves_from_state(straight.state))
    _assert_bit_equal(_host_tables(resumed), _host_tables(straight))
    if name == "deepfm_host":
        # base at 2, deltas at 4 and 6 (chain max 2)
        assert sorted(os.listdir(ckpt)) == ["delta-4", "delta-6",
                                            "version-2"]
        assert _host_tables(resumed)
    if name == "census_wide_deep":
        # the schedule moved inside each half of the split
        assert len(set(got_a.lrs)) == 2 and len(set(got_b.lrs)) == 2
    if name == "transformer":
        # dropout is on: the generator moved with every step
        assert not torch.equal(resumed.state.generator.get_state(),
                               torch.Generator().manual_seed(0).get_state())


def test_restore_writes_into_the_live_tensors(tmp_path):
    """Restore copies into the module's parameters and buffers, the
    tables and the slots, and binds no new tensor: the optimizer's state
    stays keyed by the model's Parameters, the sparse step writes the
    same table storage."""
    zoo, model_def, batch, _, a, b, flags = _setup("recsys", tmp_path)
    ckpt = str(tmp_path / "ckpt")
    _run(zoo, model_def, a, batch, ["--checkpoint_dir", ckpt] + flags)
    seen = {}

    class Capture(Callback):
        def on_train_batch_begin(self, owner=None):
            state = owner.state
            if seen:
                return
            seen["params"] = [p for p in state.model.parameters()]
            seen["ptrs"] = [p.data_ptr() for p in seen["params"]]
            seen["tables"] = {k: t.data_ptr()
                              for k, t in state.tables.items()}
            seen["slots"] = {k: {s: t.data_ptr() for s, t in v.items()}
                             for k, v in state.slot_tables.items()}

    args = tdata.make_local_args(
        zoo, model_def, b, minibatch_size=batch,
        extra=["--device", "cpu", "--checkpoint_dir_for_init", ckpt])
    executor = LocalExecutor(args, callbacks=[Capture()])
    executor.run()
    state = executor.state
    assert [p.data_ptr() for p in state.model.parameters()] == seen["ptrs"]
    assert all(p is q for p, q in zip(state.model.parameters(),
                                       seen["params"]))
    assert {k: t.data_ptr() for k, t in state.tables.items()} \
        == seen["tables"]
    assert {k: {s: t.data_ptr() for s, t in v.items()}
            for k, v in state.slot_tables.items()} == seen["slots"]
    names = {p for p in state.model.parameters()}
    assert set(state.optimizer.state) <= names
    assert state.optimizer.state


def test_resumed_run_saves_on_the_interval_after_the_restore(tmp_path):
    """A run restored at version 3 with ``--checkpoint_steps 3`` saves at
    6 (and at its end), not at its first step: the interval counts from
    the restored version."""
    zoo, model_def, batch, _, a, b, _ = _setup("mnist_functional", tmp_path)
    first, resumed = str(tmp_path / "first"), str(tmp_path / "resumed")
    _run(zoo, model_def, a, batch,
         ["--checkpoint_dir", first, "--checkpoint_steps", "3"])
    _run(zoo, model_def, a, batch,
         ["--checkpoint_dir_for_init", first, "--checkpoint_dir", resumed,
          "--checkpoint_steps", "3", "--keep_checkpoint_max", "0"])
    assert CheckpointSaver(resumed).list_versions() == [6]


def test_corrupt_newest_version_falls_back_to_the_one_before(tmp_path):
    zoo, model_def, batch, _, a, b, _ = _setup("mnist_functional", tmp_path)
    ckpt = str(tmp_path / "ckpt")
    _run(zoo, model_def, a, batch,
         ["--checkpoint_dir", ckpt, "--checkpoint_steps", "1"])
    saver = CheckpointSaver(ckpt)
    assert saver.list_versions() == [1, 2, 3]
    _, want, _ = saver.restore(version=2)
    vdir = os.path.join(ckpt, "version-3")
    shard = os.path.join(vdir, sorted(os.listdir(vdir))[0])
    with open(shard, "rb") as f:
        blob = f.read()
    with open(shard, "wb") as f:
        f.write(blob[: len(blob) // 2])
    restored = {}

    class Capture(Callback):
        def on_train_batch_begin(self, owner=None):
            if not restored:
                restored.update(named_leaves_from_state(owner.state))

    args = tdata.make_local_args(
        zoo, model_def, b, minibatch_size=batch,
        extra=["--device", "cpu", "--checkpoint_dir_for_init", ckpt])
    LocalExecutor(args, callbacks=[Capture()]).run()
    assert int(restored["step"]) == 2
    _assert_bit_equal(restored, want)


def test_empty_init_dir_raises_as_in_jax(tmp_path):
    from elasticdl_tpu.api.local_executor import LocalExecutor as JaxExec
    from elasticdl_tpu.testing import data as jdata

    records = tdata.create_mnist_record_file(str(tmp_path / "t.rec"), 16,
                                             seed=1)
    empty = tmp_path / "empty"
    empty.mkdir()
    jargs = jdata.make_local_args(
        jdata.model_zoo_dir(), "mnist.mnist_functional.custom_model",
        records, str(tmp_path / "jax"), minibatch_size=16,
        extra=["--checkpoint_dir_for_init", str(empty)])
    with pytest.raises(FileNotFoundError):
        JaxExec(jargs).run()
    args = tdata.make_local_args(
        tdata.model_zoo_dir(), "mnist.mnist_functional.custom_model",
        records, minibatch_size=16,
        extra=["--device", "cpu", "--checkpoint_dir_for_init", str(empty)])
    with pytest.raises(FileNotFoundError):
        LocalExecutor(args).run()
