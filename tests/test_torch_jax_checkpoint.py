"""Checkpoints the JAX package wrote, restored into the port through
``--checkpoint_dir_for_init`` (``checkpoint/hooks.restore_from_dir`` and
``bridge.port_leaves_from_jax``), on the CPU.

The shard files are the same bytes in both packages; the leaf names are
not: JAX names a leaf by ``jax.tree_util.keystr`` (``params['Conv_0']
['kernel']``, ``opt_state[0].trace[...]``), the port by its state's
fields and torch names (``params.Conv_0.weight``,
``opt_state.Conv_0.weight.momentum_buffer``). For each family the JAX
executor trains a few steps with ``--checkpoint_dir``; then the JAX
executor and the port's each resume from that directory over the same
next batches, and the port's losses are held to JAX's at the tolerance
the family's parity tests state (f32 twins):

- mnist_functional (SGD momentum: optax's ``trace``; BatchNorm
  statistics), losses 1e-4 relative (tests/test_torch_vision_zoo.py);
- census_wide_deep under its LearningRateScheduler (Adam: ``mu``,
  ``nu`` and the one ``count`` beside them; the schedule's own count is
  not the optimizer's), 1e-4 (tests/test_torch_eval_predict.py);
- the recsys twin at 1024 x 16 (the device-tier tables, their Adagrad
  slot tables and apply counts), 1e-5 (tests/test_torch_device_sparse.py);
- deepfm_host through a base and two deltas (``--checkpoint_delta_chain
  2``: the host tables refilled from the chain), 1e-4
  (tests/test_torch_deepfm.py).

Also: the committed fixture (``tests/torch_fixtures/jax_mnist_functional``,
the JAX zoo's own mnist_functional after 2 steps) has the leaves of a
fresh JAX write, bit for bit, and its mapped leaves are the fixture's,
transposed; JAX's ``rng`` (a PRNG key) has no torch counterpart, so the
port's generator keeps its seeded state (a deliberate divergence); a
leaf the map does not know raises.

Regenerate the fixture with ``python tests/test_torch_jax_checkpoint.py``.
"""

import os
import re
import shutil
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "torch_fixtures",
                       "jax_mnist_functional")
FIXTURE_RECORDS, FIXTURE_BATCH, FIXTURE_STEPS = 32, 16, 2

JAX_ZOO = '''
import jax.numpy as jnp

from elasticdl_tpu.core.model_spec import load_module
from elasticdl_tpu.embedding import HostStepRunner

_ref = load_module(REF)
loss, optimizer = _ref.loss, _ref.optimizer
dataset_fn, eval_metrics_fn = _ref.dataset_fn, _ref.eval_metrics_fn
callbacks = getattr(_ref, "callbacks", None)


def custom_model():
    return _ref.MODEL(compute_dtype=jnp.float32)


if hasattr(_ref, "make_host_runner"):
    def make_host_runner():
        return HostStepRunner(_ref.make_host_runner().engine,
                              async_apply=False)
'''
PORT_ZOO = '''
import torch

from elasticdl_tpu_torch.embedding.host_engine import HostStepRunner
from elasticdl_tpu_torch.model_zoo.FAMILY import NAME as twin
from elasticdl_tpu_torch.model_zoo.FAMILY.NAME import (  # noqa
    dataset_fn, eval_metrics_fn, loss, optimizer)

callbacks = getattr(twin, "callbacks", None)


def custom_model(device=None):
    return twin.MODEL(compute_dtype=torch.float32).to(device)


if hasattr(twin, "make_host_runner"):
    def make_host_runner():
        return HostStepRunner(twin.make_host_runner().engine,
                              async_apply=False)
'''


def _records(name):
    from elasticdl_tpu_torch.testing import data as tdata

    if name == "mnist_functional":
        return tdata.create_mnist_record_file
    if name == "census_wide_deep":
        return tdata.create_census_record_file

    def frappe(path, n, seed):
        return tdata.create_frappe_record_file(
            path, n, seed=seed, input_length=10, max_id=5500)
    return frappe


# name -> (family, model class, batch, steps written, checkpoint flags,
#          steps resumed, loss rtol)
FAMILIES = {
    "mnist_functional": ("mnist", "MnistModel", 16, 2,
                         ["--checkpoint_steps", "2"], 3, 1e-4),
    "census_wide_deep": ("census", "WideAndDeep", 16, 2,
                         ["--checkpoint_steps", "2"], 3, 1e-4),
    "deepfm_host": ("deepfm", "HostDeepFM", 32, 3,
                    ["--checkpoint_steps", "1",
                     "--checkpoint_delta_chain", "2"], 3, 1e-4),
}


def _zoo(tmp_path, name):
    family, model = FAMILIES[name][:2]
    zoo = tmp_path / "zoo"
    ref = repr(os.path.join(REPO, "model_zoo", family, f"{name}.py"))
    for pkg, src in (("jax_f32", JAX_ZOO), ("port_f32", PORT_ZOO)):
        (zoo / pkg).mkdir(parents=True)
        (zoo / pkg / "m.py").write_text(textwrap.dedent(
            src.replace("REF", ref).replace("FAMILY", family)
            .replace("NAME", name).replace("MODEL", model)))
    return str(zoo)


def _jax_run(zoo, model_def, data, workdir, batch, extra):
    """The JAX executor's run and the loss of each of its steps."""
    from elasticdl_tpu.api.local_executor import LocalExecutor
    from elasticdl_tpu.testing import data as jdata

    args = jdata.make_local_args(zoo, model_def, data, workdir,
                                 minibatch_size=batch, extra=extra)
    executor, losses = LocalExecutor(args), []
    init = executor._maybe_init_state

    def recording(batch_):
        first = executor.state is None
        init(batch_)
        if first:
            real = executor._train_step

            def step(state, b):
                state, metrics = real(state, b)
                losses.append(float(metrics["loss"]))
                return state, metrics

            executor._train_step = step

    executor._maybe_init_state = recording
    executor.run()
    return executor, losses


def _port_run(zoo, model_def, data, batch, extra):
    """The port executor's run, the loss of each step and its state as
    restored (before the first step)."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.callbacks import Callback
    from elasticdl_tpu_torch.checkpoint import named_leaves_from_state
    from elasticdl_tpu_torch.testing import data as tdata

    class Record(Callback):
        def __init__(self):
            self.losses, self.restored = [], None

        def on_train_batch_begin(self, owner=None):
            if self.restored is None:
                self.restored = named_leaves_from_state(owner.state)

        def on_train_batch_end(self, owner=None, metrics=None):
            self.losses.append(float(metrics["loss"]))

    record = Record()
    args = tdata.make_local_args(zoo, model_def, data, minibatch_size=batch,
                                 extra=["--device", "cpu"] + extra)
    executor = LocalExecutor(args, callbacks=[record])
    executor.run()
    return executor, record


def _write_and_resume(tmp_path, zoo, jax_def, port_def, make, batch,
                      n_write, ckpt_flags, n_resume):
    a = make(str(tmp_path / "a.rec"), batch * n_write, 1)
    b = make(str(tmp_path / "b.rec"), batch * n_resume, 2)
    ckpt = str(tmp_path / "jax_ckpt")
    _jax_run(zoo, jax_def, a, str(tmp_path / "ja"), batch,
             ["--checkpoint_dir", ckpt] + ckpt_flags)
    final = os.path.join(ckpt, f"version-{n_write}")
    if os.path.exists(os.path.join(ckpt, f"delta-{n_write}")):
        # The JAX hook's final save writes the last version again, in
        # full, beside its delta: without it (a job killed before its
        # final save) the restore goes through the base and the deltas.
        shutil.rmtree(final)
    _, want = _jax_run(zoo, jax_def, b, str(tmp_path / "jb"), batch,
                       ["--checkpoint_dir_for_init", ckpt])
    executor, got = _port_run(zoo, port_def, b, batch,
                              ["--checkpoint_dir_for_init", ckpt])
    return ckpt, want, executor, got


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_port_resumes_a_jax_checkpoint_like_jax(name, tmp_path):
    from elasticdl_tpu.checkpoint.saver import CheckpointSaver as JaxSaver

    _, _, batch, n_write, flags, n_resume, rtol = FAMILIES[name]
    zoo = _zoo(tmp_path, name)
    ckpt, want, executor, got = _write_and_resume(
        tmp_path, zoo, "jax_f32.m.custom_model", "port_f32.m.custom_model",
        _records(name), batch, n_write, flags, n_resume)
    entries = sorted(os.listdir(ckpt))
    if name == "deepfm_host":
        assert entries == ["delta-2", "delta-3", "version-1"], entries
    version, dense, _ = JaxSaver(ckpt).restore()
    assert version == n_write and "step" in dense
    assert any("[" in leaf for leaf in dense)   # JAX-named
    assert int(got.restored["step"]) == n_write
    assert len(got.losses) == len(want) == n_resume
    np.testing.assert_allclose(got.losses, want, rtol=rtol)
    assert executor.state.step == n_write + n_resume


def test_port_resumes_the_recsys_tables_like_jax(tmp_path, monkeypatch):
    """The device-tier sparse plane: the tables, their Adagrad slots and
    apply counts come from the JAX checkpoint (JAX draws its tables from
    ``jax.random``; no torch generator could redraw them)."""
    import jax.numpy as jnp

    from elasticdl_tpu.checkpoint.saver import CheckpointSaver as JaxSaver
    from elasticdl_tpu.testing.tiny_zoo import tiny_recsys_zoo as jax_tiny
    from elasticdl_tpu_torch.testing import data as tdata
    from elasticdl_tpu_torch.testing.tiny_zoo import tiny_recsys_zoo

    vocab, dim, batch = 1024, 16, 16

    def make(path, n, seed):
        return tdata.create_frappe_record_file(path, n, seed=seed,
                                               input_length=8,
                                               max_id=vocab)

    with jax_tiny(vocab=vocab, dim=dim) as jzoo, \
            tiny_recsys_zoo(vocab=vocab, dim=dim) as pzoo:
        monkeypatch.setattr(jzoo, "custom_model", lambda: jzoo.RecsysRanker(
            compute_dtype=jnp.float32, table_name=jzoo.TABLE_NAME,
            emb_dim=jzoo.DIM))
        monkeypatch.setattr(pzoo, "custom_model", lambda device=None: (
            pzoo.RecsysRanker(compute_dtype=torch.float32,
                              emb_dim=pzoo.DIM).to(device)))
        from elasticdl_tpu.testing.data import model_zoo_dir as jax_zoo

        model_def = "recsys.recsys_sparse.custom_model"
        a = make(str(tmp_path / "a.rec"), 2 * batch, 1)
        b = make(str(tmp_path / "b.rec"), 3 * batch, 2)
        ckpt = str(tmp_path / "jax_ckpt")
        _jax_run(jax_zoo(), model_def, a, str(tmp_path / "ja"), batch,
                 ["--checkpoint_dir", ckpt, "--checkpoint_steps", "2"])
        jex, want = _jax_run(jax_zoo(), model_def, b, str(tmp_path / "jb"),
                             batch, ["--checkpoint_dir_for_init", ckpt])
        executor, got = _port_run(tdata.model_zoo_dir(), model_def, b, batch,
                                  ["--checkpoint_dir_for_init", ckpt])
    _, dense, _ = JaxSaver(ckpt).restore()
    table = [k for k in dense if k.startswith("tables[")]
    slots = [k for k in dense if k.startswith("slot_tables[")]
    assert table and slots
    for key in table + slots:
        names = re.findall(r"\['([^']*)'\]", key)
        head = key.split("[")[0]
        np.testing.assert_array_equal(
            got.restored[".".join([head] + names)], dense[key])
    assert got.restored["table_steps.item_emb"] == 2
    np.testing.assert_allclose(got.losses, want, rtol=1e-5)
    assert executor.state.table_steps["item_emb"] == 5


# ---- the committed fixture -----------------------------------------------


def write_jax_mnist_checkpoint(ckpt_dir: str, workdir: str) -> str:
    """The fixture's recipe: the JAX zoo's mnist_functional (bf16
    compute), FIXTURE_STEPS Local steps at B FIXTURE_BATCH over
    ``create_mnist_record_file(FIXTURE_RECORDS, seed=1)``, its
    checkpoint at the last step."""
    from elasticdl_tpu.testing import data as jdata

    data = jdata.create_mnist_record_file(
        os.path.join(workdir, "fixture.rec"), FIXTURE_RECORDS, seed=1)
    _jax_run(jdata.model_zoo_dir(), "mnist.mnist_functional.custom_model",
             data, workdir, FIXTURE_BATCH,
             ["--checkpoint_dir", ckpt_dir, "--checkpoint_steps",
              str(FIXTURE_STEPS)])
    return ckpt_dir


def _fixture_leaves(path):
    from elasticdl_tpu_torch.checkpoint.saver import CheckpointSaver

    version, dense, embeddings = CheckpointSaver(path).restore()
    assert version == FIXTURE_STEPS and embeddings == {}
    return dense


def test_fixture_is_a_fresh_jax_write(tmp_path):
    fresh = _fixture_leaves(write_jax_mnist_checkpoint(
        str(tmp_path / "ckpt"), str(tmp_path)))
    committed = _fixture_leaves(FIXTURE)
    assert sorted(committed) == sorted(fresh)
    for name, value in fresh.items():
        got = np.asarray(committed[name])
        assert got.dtype == np.asarray(value).dtype, name
        assert got.tobytes() == np.asarray(value).tobytes(), name
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(FIXTURE) for f in fs)
    assert size < 2 << 20


def _fresh_state():
    from elasticdl_tpu_torch.core.model_spec import get_model_spec
    from elasticdl_tpu_torch.core.train_state import init_train_state
    from elasticdl_tpu_torch.testing.data import model_zoo_dir

    torch.manual_seed(0)
    spec = get_model_spec(model_zoo_dir(),
                          "mnist.mnist_functional.custom_model",
                          device="cpu")
    return init_train_state(spec.model, spec.make_optimizer(), seed=7)


def test_fixture_maps_to_the_port_names_transposed(monkeypatch):
    from elasticdl_tpu_torch import bridge

    state = _fresh_state()
    jax_named = _fixture_leaves(FIXTURE)
    assert bridge.is_jax_named(jax_named)
    said = []
    monkeypatch.setattr(bridge.logger, "info",
                        lambda msg, *a: said.append(msg % a))
    mapped = bridge.port_leaves_from_jax(state, jax_named)
    assert any("no torch.Generator counterpart" in m for m in said)
    assert not bridge.is_jax_named(mapped)

    def transposed(value):
        value = np.asarray(value)
        if value.ndim == 4:          # HWIO -> OIHW
            return value.transpose(3, 2, 0, 1)
        return value.T if value.ndim == 2 else value

    params = dict(state.model.named_parameters())
    seen = set()
    for key, value in jax_named.items():
        if key.startswith(("params[", "opt_state[0].trace[")):
            path = re.findall(r"\['([^']*)'\]", key)
            path[-1] = "weight" if path[-1] == "kernel" else path[-1]
            name = ".".join(path)
            port = (f"params.{name}" if key.startswith("params[")
                    else f"opt_state.{name}.momentum_buffer")
            assert name in params
            np.testing.assert_array_equal(mapped[port], transposed(value))
            seen.add(port)
        elif key.startswith("batch_stats["):
            port = "batch_stats." + ".".join(
                re.findall(r"\['([^']*)'\]", key))
            np.testing.assert_array_equal(mapped[port], value)
            seen.add(port)
    assert int(mapped["step"]) == FIXTURE_STEPS
    # SGD with momentum keeps no step count (optax's sgd holds none).
    assert sorted(seen | {"step", "rng"}) == sorted(mapped)
    # The generator stays as the port seeded it.
    assert torch.equal(torch.from_numpy(mapped["rng"]),
                       torch.Generator().manual_seed(7).get_state())


def test_restore_from_dir_reads_the_fixture(tmp_path):
    from elasticdl_tpu_torch.checkpoint import restore_from_dir

    state = restore_from_dir(_fresh_state(), FIXTURE)
    assert state.step == FIXTURE_STEPS
    jax_named = _fixture_leaves(FIXTURE)
    kernel = np.asarray(jax_named["params['Conv_1']['kernel']"])
    np.testing.assert_array_equal(
        state.model.Conv_1.weight.detach().numpy(),
        kernel.transpose(3, 2, 0, 1))
    (buf,) = [s["momentum_buffer"] for p, s in state.optimizer.state.items()
              if p is state.model.Dense_0.weight]
    np.testing.assert_array_equal(
        buf.numpy(), np.asarray(
            jax_named["opt_state[0].trace['Dense_0']['kernel']"]).T)
    np.testing.assert_array_equal(
        state.batch_stats["BatchNorm_0.var"].numpy(),
        jax_named["batch_stats['BatchNorm_0']['var']"])
    assert torch.equal(state.generator.get_state(),
                       torch.Generator().manual_seed(7).get_state())
    # A leaf the map does not know is refused, not dropped.
    odd = dict(jax_named)
    odd["opt_state[0].sum_of_squares['Dense_0']['bias']"] = np.zeros(10)
    copy = str(tmp_path / "odd")
    from elasticdl_tpu_torch.checkpoint.saver import CheckpointSaver

    CheckpointSaver(copy).save(FIXTURE_STEPS, odd)
    with pytest.raises(ValueError, match="sum_of_squares"):
        restore_from_dir(_fresh_state(), copy)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as work:
        out = write_jax_mnist_checkpoint(os.path.join(work, "ckpt"), work)
        shutil.rmtree(FIXTURE, ignore_errors=True)
        shutil.copytree(out, FIXTURE)
    print(f"wrote {FIXTURE}", file=sys.stderr)
