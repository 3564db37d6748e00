"""The four DeepFM zoo twins (``elasticdl_tpu_torch/model_zoo/deepfm/``)
against the JAX package's zoo models, and their runs through the Local
executor, on the CPU.

Weights cross from flax through ``bridge.deepfm_state_dict_from_flax``;
host rows are the same lazy rows on both sides (same name and ids).
Forward and first-step gradients (dense, and the host twins' row
gradients): at f32 each tensor within 1e-5 relative L2 (another
summation order). In bf16, the zoo's compute dtype, the forward within
2e-2 relative L2 and the whole gradient (every tensor, concatenated)
within 2e-2 relative L2: weights and rows read 0 to 3e-3 a tensor, but
XLA sums a bias's batch gradient in bf16 where PyTorch accumulates in
f32, and the output bias is one such sum with cancellation (7.6% apart
on one batch of deepfm_host_multi, each side's rounding, not a fault of
either). The executor runs are f32 twins of the zoo modules (the
JAX side's initial weights carried into the port before its first
step, the host runners synchronous so the two runs are exact):
per-step losses within 1e-4 relative over 8 Adam steps.
"""

import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.core.model_spec import load_module
from elasticdl_tpu.embedding import host_engine as jhe
from elasticdl_tpu.embedding.optimizer import SGD as JaxSGD
from elasticdl_tpu.embedding.optimizer import HostOptimizerWrapper as JaxWrap
from elasticdl_tpu.embedding.table import EmbeddingTable as JaxTable
from elasticdl_tpu.ops import masked_sigmoid_cross_entropy as jax_loss
from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.core.train_state import init_train_state
from elasticdl_tpu_torch.embedding import host_engine as the
from elasticdl_tpu_torch.embedding.optimizer import SGD, HostOptimizerWrapper
from elasticdl_tpu_torch.embedding.table import EmbeddingTable
from elasticdl_tpu_torch.model_zoo.deepfm import (
    deepfm_functional,
    deepfm_host,
    deepfm_host_multi,
    deepfm_standard,
)
from elasticdl_tpu_torch.ops.losses import masked_sigmoid_cross_entropy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ZOO = os.path.join(REPO, "model_zoo", "deepfm")
BATCH = 64
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TWINS = {
    "deepfm_host": (deepfm_host, "HostDeepFM", None),
    "deepfm_host_multi": (deepfm_host_multi, "HostDeepFMMulti", None),
    "deepfm_functional": (deepfm_functional, "DeepFM", "embedding"),
    "deepfm_standard": (deepfm_standard, "DeepFMStandard", "weight"),
}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def frappe_batch(seed, module):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 5500, (BATCH, 10))
    labels = ids.sum(axis=1) % 2
    features, labels = module.dataset_fn(
        [_payload(i, y) for i, y in zip(ids, labels)], "training", None)
    return {"features": features, "labels": labels,
            "mask": np.ones((BATCH,), np.float32)}


def _payload(ids, label):
    from elasticdl_tpu_torch.common import tensor_utils

    return tensor_utils.dumps({"feature_ids": ids.astype(np.int64),
                               "label": int(label)})


def grad_recorder():
    """An optax transformation that applies nothing and keeps the
    gradient in its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (
            jax.tree.map(jnp.zeros_like, updates), updates))


def _host_twin(module, jmodel, model, batch):
    """Forward, dense and row gradients of a host twin and its JAX model
    on one batch through each package's engine and host train step."""
    from elasticdl_tpu.core.train_state import init_train_state as jinit

    keys = _host_keys(module)
    jeng = jhe.HostEmbeddingEngine({t: JaxTable(t, 16) for t in keys},
                                   JaxWrap(JaxSGD(lr=0.05)), id_keys=keys)
    teng = the.HostEmbeddingEngine(
        {t: EmbeddingTable(t, 16) for t in keys},
        HostOptimizerWrapper(SGD(lr=0.05)), id_keys=keys)
    jb, jrows, _ = jeng.prepare_batch(batch)
    tb, trows, _ = teng.prepare_batch(batch)
    jstate = jinit(jmodel, grad_recorder(), jb, seed=0)
    params = jax.tree.map(np.asarray, jstate.params)
    template = jhe.host_rows_template(jmodel, jb)
    want_pred = jstate.apply_fn(
        {"params": jstate.params,
         "host_rows": jhe._nest_rows(template, jrows)},
        jb["features"], training=False)
    jstate, jrow_grads, _ = jhe.build_host_train_step(jax_loss, template)(
        jstate, jb, jrows)
    model.load_state_dict(bridge.deepfm_state_dict_from_flax(params))
    state = init_train_state(model, lambda p: torch.optim.SGD(p, lr=0.0))
    with torch.no_grad():
        got_pred = model(the._to_device(tb["features"], "cpu"),
                         host_rows={k: torch.from_numpy(v)
                                    for k, v in trows.items()})
    _, row_grads, _ = the.build_host_train_step(
        masked_sigmoid_cross_entropy, the.host_rows_template(model))(
        state, tb, trows)
    grads = {n: p.grad for n, p in model.named_parameters()}
    want = bridge.deepfm_state_dict_from_flax(
        jax.tree.map(np.asarray, jstate.opt_state))
    for t in keys:
        grads[f"rows:{t}"] = row_grads[t]
        want[f"rows:{t}"] = torch.from_numpy(np.array(jrow_grads[t]))
    return got_pred, want_pred, grads, want


def _host_keys(module):
    if hasattr(module, "FIELD_GROUPS"):
        return {t: k for t, (k, _) in module.FIELD_GROUPS.items()}
    return {module.TABLE_NAME: module.FEATURE_KEY}


def _dense_twin(module, embed_param, jmodel, model, batch):
    ids = jnp.asarray(batch["features"])
    params = jmodel.init(jax.random.PRNGKey(0), ids)["params"]

    def loss_of(p):
        preds = jmodel.apply({"params": p}, ids)
        return jax_loss(jnp.asarray(batch["labels"]), preds,
                        jnp.asarray(batch["mask"]))

    want_pred = jmodel.apply({"params": params}, ids)
    jgrads = jax.grad(loss_of)(params)
    model.load_state_dict(bridge.deepfm_state_dict_from_flax(
        jax.tree.map(np.asarray, params), embed_param=embed_param))
    features = torch.from_numpy(batch["features"])
    with torch.no_grad():
        got_pred = model(features)
    masked_sigmoid_cross_entropy(torch.from_numpy(batch["labels"]),
                                 model(features),
                                 torch.from_numpy(batch["mask"])).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    want = bridge.deepfm_state_dict_from_flax(
        jax.tree.map(np.asarray, jgrads), embed_param=embed_param)
    return got_pred, want_pred, grads, want


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_forward_and_first_step_gradients_match_jax(name, dtype):
    module, cls, embed_param = TWINS[name]
    jdt, tdt = DTYPES[dtype]
    jmod = load_module(os.path.join(JAX_ZOO, f"{name}.py"))
    jmodel = getattr(jmod, cls)(compute_dtype=jdt)
    model = getattr(module, cls)(compute_dtype=tdt)
    batch = frappe_batch(3, module)
    if embed_param is None:
        got, want, grads, want_grads = _host_twin(module, jmodel, model,
                                                  batch)
    else:
        got, want, grads, want_grads = _dense_twin(module, embed_param,
                                                   jmodel, model, batch)
    assert got.dtype == torch.float32 and got.shape == (BATCH,)
    assert rel(got.numpy(), np.asarray(want, np.float32)) <= TOL[dtype]
    assert sorted(grads) == sorted(want_grads)
    if dtype == "bfloat16":
        keys = sorted(grads)
        assert rel(np.concatenate([grads[k].float().numpy().ravel()
                                   for k in keys]),
                   np.concatenate([want_grads[k].numpy().ravel()
                                   for k in keys])) <= TOL[dtype]
        return
    for key, g in grads.items():
        assert rel(g.numpy(), want_grads[key].numpy()) <= TOL[dtype], key


JAX_EXEC_ZOO = '''
import jax.numpy as jnp

from elasticdl_tpu.core.model_spec import load_module
from elasticdl_tpu.embedding import HostStepRunner

_ref = load_module(REF)
loss, optimizer = _ref.loss, _ref.optimizer
dataset_fn, eval_metrics_fn = _ref.dataset_fn, _ref.eval_metrics_fn


def custom_model():
    return _ref.CLS(compute_dtype=jnp.float32)


if hasattr(_ref, "make_host_runner"):
    def make_host_runner():
        return HostStepRunner(_ref.make_host_runner().engine,
                              async_apply=False)
'''

PORT_EXEC_ZOO = '''
import torch

from elasticdl_tpu_torch.embedding.host_engine import HostStepRunner
from elasticdl_tpu_torch.model_zoo.deepfm import NAME as twin
from elasticdl_tpu_torch.model_zoo.deepfm.NAME import (
    dataset_fn, eval_metrics_fn, loss, optimizer)


def custom_model(device=None):
    return twin.CLS(compute_dtype=torch.float32).to(device)


if hasattr(twin, "make_host_runner"):
    def make_host_runner():
        return HostStepRunner(twin.make_host_runner().engine,
                              async_apply=False)
'''


def _write_zoos(root, name):
    _, cls, _ = TWINS[name]
    zoo = root / "zoo"
    for pkg, src in (("jax_f32", JAX_EXEC_ZOO), ("port_f32", PORT_EXEC_ZOO)):
        (zoo / pkg).mkdir(parents=True, exist_ok=True)
        (zoo / pkg / f"{name}.py").write_text(textwrap.dedent(
            src.replace("REF", repr(os.path.join(JAX_ZOO, f"{name}.py")))
            .replace("NAME", name).replace("CLS", cls)))
    return str(zoo)


@pytest.mark.parametrize("name", ["deepfm_host", "deepfm_functional"])
def test_executor_losses_match_jax_executor(name, tmp_path):
    """256 frappe records, B 32, one epoch: 8 steps through each
    package's LocalExecutor from the JAX executor's initial weights."""
    from elasticdl_tpu.api.local_executor import LocalExecutor as JaxExec
    from elasticdl_tpu.testing import data as jdata
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.callbacks import Callback
    from elasticdl_tpu_torch.testing import data as tdata

    _, _, embed_param = TWINS[name]
    train = tdata.create_frappe_record_file(
        str(tmp_path / "train.rec"), 256, seed=1, input_length=10,
        max_id=5500)
    zoo = _write_zoos(tmp_path, name)
    jargs = jdata.make_local_args(zoo, f"jax_f32.{name}.custom_model", train,
                                  str(tmp_path / "jax"), minibatch_size=32)
    jex = JaxExec(jargs)
    jax_losses, start = [], {}
    orig_init = jex._maybe_init_state

    def init(batch):
        if jex.state is None:
            orig_init(batch)
            real_step = jex._train_step
            start["params"] = jax.tree.map(np.asarray, jex.state.params)

            def record(state, b):
                state, metrics = real_step(state, b)
                jax_losses.append(float(metrics["loss"]))
                return state, metrics

            jex._train_step = record

    jex._maybe_init_state = init
    want = jex.run()

    losses = []

    class Carry(Callback):
        def on_train_batch_begin(self, owner=None):
            if owner.state.step == 0:
                owner.state.model.load_state_dict(
                    bridge.deepfm_state_dict_from_flax(
                        start["params"], embed_param=embed_param or
                        "embedding"))

        def on_train_batch_end(self, owner=None, metrics=None):
            losses.append(float(metrics["loss"]))

    args = tdata.make_local_args(zoo, f"port_f32.{name}.custom_model", train,
                                 minibatch_size=32, extra=["--device", "cpu"])
    executor = LocalExecutor(args, callbacks=[Carry()])
    got = executor.run()
    assert got["steps"] == want["steps"] == 8
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    if embed_param is None:
        assert isinstance(executor._step_runner, the.HostStepRunner)


HOST_AND_SPARSE_ZOO = '''
from elasticdl_tpu_torch.model_zoo.deepfm.deepfm_host import (
    custom_model, dataset_fn, eval_metrics_fn, loss, make_host_runner,
    optimizer)
from elasticdl_tpu_torch.model_zoo.recsys.recsys_sparse import (
    make_sparse_runner)
'''


def test_executor_takes_the_host_runner_first(tmp_path):
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.testing import data as tdata

    zoo = tmp_path / "zoo" / "both"
    zoo.mkdir(parents=True)
    (zoo / "m.py").write_text(textwrap.dedent(HOST_AND_SPARSE_ZOO))
    train = tdata.create_frappe_record_file(str(tmp_path / "t.rec"), 64,
                                            input_length=10, max_id=5500)
    args = tdata.make_local_args(str(tmp_path / "zoo"), "both.m.custom_model",
                                 train, minibatch_size=32,
                                 extra=["--device", "cpu"])
    executor = LocalExecutor(args)
    assert executor._spec.make_sparse_runner is not None
    assert isinstance(executor._step_runner, the.HostStepRunner)
    result = executor.run()
    assert result["steps"] == 2 and np.isfinite(result["final_loss"])
    assert executor._step_runner.engine.tables[
        deepfm_host.TABLE_NAME].num_rows > 0


@pytest.mark.parametrize("name", ["deepfm_host", "deepfm_host_multi"])
def test_output_with_a_host_runner_exports_a_host_bundle(name, tmp_path):
    """``--output`` with a host runner: the tables materialised dense up
    to ``host_serving_vocab`` (touched rows as trained, the rest their
    lazy rows, the live tables not grown), and the bundle serves the
    trained module's forward on the same raw ids, bit for bit."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.common import tensor_utils
    from elasticdl_tpu_torch.serving.export import HOST_ROWS_FILE
    from elasticdl_tpu_torch.serving.model_store import load_served_model
    from elasticdl_tpu_torch.testing import data as tdata

    module = TWINS[name][0]
    train = tdata.create_frappe_record_file(str(tmp_path / "t.rec"), 64,
                                            input_length=10, max_id=5500)
    out = str(tmp_path / "out")
    args = tdata.make_local_args(
        tdata.model_zoo_dir(), f"deepfm.{name}.custom_model", train,
        minibatch_size=32, extra=["--device", "cpu", "--output", out])
    executor = LocalExecutor(args)
    executor.run()
    engine = executor._step_runner.engine
    sizes = {n: t.num_rows for n, t in engine.tables.items()}
    rows = torch.load(os.path.join(out, HOST_ROWS_FILE))
    assert sorted(rows) == sorted(module.host_serving_vocab)
    for table_name, table in engine.tables.items():
        assert tuple(rows[table_name].shape) == (5500, 16)
        ids, trained = table.to_arrays()
        np.testing.assert_array_equal(rows[table_name].numpy()[ids],
                                      trained)
        assert table.num_rows == sizes[table_name]
    served = load_served_model(out, device="cpu", model_fn=lambda: (
        module.custom_model(device="cpu")))
    query = np.random.default_rng(3).integers(0, 5500, (5, 10)).astype(
        np.int32)
    features, _ = module.dataset_fn(
        [tensor_utils.dumps({"feature_ids": q, "label": 0})
         for q in query], None, None)
    dense = {n: torch.from_numpy(r.numpy()) for n, r in rows.items()}
    with torch.inference_mode():
        want = executor.state.model.eval()(
            {k: torch.from_numpy(v) for k, v in features.items()},
            host_rows=dense).numpy()
    np.testing.assert_array_equal(served.predict(features), want)


@pytest.mark.parametrize("name", sorted(TWINS))
def test_train_cli_runs_each_twin_on_the_cpu(name, tmp_path):
    """``python -m elasticdl_tpu_torch train`` in process with
    ``--device cpu``; without it and without CUDA, it raises."""
    from elasticdl_tpu_torch.__main__ import main
    from elasticdl_tpu_torch.testing import data as tdata

    train = tdata.create_frappe_record_file(str(tmp_path / "t.rec"), 96,
                                            input_length=10, max_id=5500)
    argv = ["train", "--model_zoo", tdata.model_zoo_dir(), "--model_def",
            f"deepfm.{name}.custom_model", "--training_data", train,
            "--minibatch_size", "32"]
    assert main(argv + ["--device", "cpu"]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)


def test_remote_row_service_waits_for_the_rpc_wire():
    """Each host twin's row service answers over the RPC wire, and its
    ``make_host_runner(remote_addr=...)`` builds a runner whose tables
    are that service's: concurrent-safe remote tables, no local
    checkpoint duty, and the service's lazy rows."""
    for module in (deepfm_host, deepfm_host_multi):
        svc = module.make_row_service().start()
        try:
            runner = module.make_host_runner(
                remote_addr=f"localhost:{svc.port}")
            engine = runner.engine
            assert engine.remote and engine.concurrent_io
            assert runner.host_tables is None
            assert sorted(engine.tables) == sorted(svc._tables)
            for name, table in engine.tables.items():
                ids = np.array([0, 7, 5499], np.int64)
                np.testing.assert_array_equal(
                    table.get(ids), svc._tables[name].get(ids))
        finally:
            svc.stop(0)
