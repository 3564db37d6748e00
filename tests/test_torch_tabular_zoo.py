"""The six tabular zoo twins (``elasticdl_tpu_torch/model_zoo/{census,
heart,iris}/``) against the JAX package's zoo modules on the CPU, and
their runs through the port's Local executor and serving.

Records come from the port's generators, which write the JAX
generators' bytes for the same seed; weights cross from flax through
``bridge.flax_state_dict``, each leaf first drawn away from its initial
value by a seeded numpy jitter (so sqlflow's zero wide weights and the
zero biases carry something).

- ``dataset_fn`` on the same records: exactly the JAX module's features
  and labels (iris through each package's CSV reader).
- Forward with carried weights: within 1e-5 relative L2 at f32 (both
  sides at ``compute_dtype`` float32: only the order of float sums
  differs) and within 2e-2 at the zoos' bf16, the house bound (every
  product rounds to bf16; another order moves a rounding).
- Three train steps at f32 through each package's train step and the
  zoo's optimizer (census_wide_deep under its schedule): losses within
  1e-5 relative, every parameter's change within 1e-4 relative L2.
- Each twin trains through the port's ``LocalExecutor`` with
  validation data (finite losses, eval metrics), as the JAX zoo's
  ``test_zoo_model_trains_end_to_end`` does.
- census_wide_deep's schedule equals JAX's; its ``--output`` bundle
  serves dict features on the CPU (``load_served_model`` and a JSON
  predict to ``InferenceServer``) as its eval forward answers.
"""

import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.callbacks import (
    apply_callbacks_to_optimizer as jax_apply_callbacks,
)
from elasticdl_tpu.core import step as jax_step
from elasticdl_tpu.core.model_spec import load_module
from elasticdl_tpu.core.train_state import TrainState as JaxState
from elasticdl_tpu.testing import data as jdata
from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.callbacks import apply_callbacks_to_optimizer
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.core import step as port_step
from elasticdl_tpu_torch.core.train_state import init_train_state
from elasticdl_tpu_torch.data.batcher import tree_map
from elasticdl_tpu_torch.model_zoo.census import (
    census_dnn,
    census_feature_columns,
    census_sqlflow,
    census_wide_deep,
)
from elasticdl_tpu_torch.model_zoo.heart import heart
from elasticdl_tpu_torch.model_zoo.iris import iris_dnn
from elasticdl_tpu_torch.testing import data as tdata

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ZOO = os.path.join(REPO, "model_zoo")
BATCH = 16
# name -> (JAX zoo file, twin module, JAX model(module, dtype), twin
# model(dtype), record generator)
TWINS = {
    "census_wide_deep": (
        "census/census_wide_deep.py", census_wide_deep,
        lambda m, dt: m.WideAndDeep(compute_dtype=dt),
        lambda dt: census_wide_deep.WideAndDeep(compute_dtype=dt),
        "census"),
    "census_dnn": (
        "census/census_dnn.py", census_dnn,
        lambda m, dt: m.CensusDNN(compute_dtype=dt),
        lambda dt: census_dnn.CensusDNN(compute_dtype=dt), "census"),
    "census_feature_columns": (
        "census/census_feature_columns.py", census_feature_columns,
        lambda m, dt: m.CensusColumnsDNN(compute_dtype=dt),
        lambda dt: census_feature_columns.CensusColumnsDNN(
            compute_dtype=dt), "census"),
    "census_sqlflow": (
        "census/census_sqlflow.py", census_sqlflow,
        lambda m, dt: m.SqlflowWideAndDeep(compute_dtype=dt),
        lambda dt: census_sqlflow.SqlflowWideAndDeep(compute_dtype=dt),
        "census"),
    "heart": (
        "heart/heart.py", heart,
        lambda m, dt: m.HeartModel(compute_dtype=dt),
        lambda dt: heart.HeartModel(compute_dtype=dt), "heart"),
    "iris_dnn": (
        "iris/iris_dnn.py", iris_dnn,
        lambda m, dt: m.IrisDNN(),
        lambda dt: iris_dnn.IrisDNN(), "iris"),
}
GENERATORS = {"census": "create_census_record_file",
              "heart": "create_heart_record_file",
              "iris": "create_iris_csv"}
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
LOSS_TOL, DELTA_TOL = 1e-5, 1e-4


def rel(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().double().numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _records_file(tmp_path, name, n, seed):
    kind = TWINS[name][4]
    suffix = ".csv" if kind == "iris" else ".rec"
    path = str(tmp_path / f"{kind}_{seed}{suffix}")
    if not os.path.exists(path):
        getattr(tdata, GENERATORS[kind])(path, n, seed=seed)
    return path


def _read(pkg, path):
    """(records, metadata) of every row of ``path`` through package
    ``pkg``'s reader factory (``elasticdl_tpu`` or the port)."""
    factory = __import__(f"{pkg}.data.factory", fromlist=["x"])
    task_mod = __import__(f"{pkg}.common.task", fromlist=["x"])
    reader = factory.create_data_reader(data_origin=path)
    records = []
    for task_id, (shard, (start, count)) in enumerate(
            reader.create_shards().items()):
        task = task_mod.Task(task_id=task_id, shard_name=shard, start=start,
                             end=start + count, type=Mode.TRAINING)
        records += list(reader.read_records(task))
    return records, reader.metadata


def _batches(name, tmp_path, n_batches=3, seed=1):
    """Port dataset_fn batches ({"features", "labels", "mask"}) and the
    JAX module's over the same records."""
    path = _records_file(tmp_path, name, BATCH * n_batches, seed)
    jmod = _jax_module(name)
    twin = TWINS[name][1]
    out = {"port": [], "jax": []}
    for side, pkg, mod in (("port", "elasticdl_tpu_torch", twin),
                           ("jax", "elasticdl_tpu", jmod)):
        records, meta = _read(pkg, path)
        for i in range(n_batches):
            features, labels = mod.dataset_fn(
                records[i * BATCH:(i + 1) * BATCH], Mode.TRAINING, meta)
            out[side].append({"features": features, "labels": labels,
                              "mask": np.ones(BATCH, np.float32)})
    return out


_JAX_MODULES = {}


def _jax_module(name):
    if name not in _JAX_MODULES:
        _JAX_MODULES[name] = load_module(os.path.join(JAX_ZOO,
                                                      TWINS[name][0]))
    return _JAX_MODULES[name]


def _jnp(tree):
    return tree_map(jnp.asarray, tree)


def _torch(tree):
    return tree_map(lambda x: torch.from_numpy(np.asarray(x)), tree)


def _init(name, features, seed=3):
    """The JAX model's f32 params (flax keeps them in f32 whatever the
    compute dtype), each leaf jittered by a seeded normal draw."""
    jmodel = TWINS[name][2](_jax_module(name), jnp.float32)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1),
                                                  _jnp(features)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(
            np.float32), params)


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _assert_tree_equal(got[key], want[key])
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---- records and dataset_fn ------------------------------------------------


@pytest.mark.parametrize("kind", sorted(GENERATORS))
def test_generators_write_the_jax_bytes(kind, tmp_path):
    name = GENERATORS[kind]
    suffix = ".csv" if kind == "iris" else ".rec"
    mine = getattr(tdata, name)(str(tmp_path / f"port{suffix}"), 37, seed=5)
    theirs = getattr(jdata, name)(str(tmp_path / f"jax{suffix}"), 37, seed=5)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", sorted(TWINS))
def test_tabular_twin_dataset_fn_matches_jax(name, tmp_path):
    batches = _batches(name, tmp_path, n_batches=2)
    for got, want in zip(batches["port"], batches["jax"]):
        _assert_tree_equal(got["features"], want["features"])
        _assert_tree_equal(got["labels"], want["labels"])
    path = _records_file(tmp_path, name, 2 * BATCH, 1)
    twin, jmod = TWINS[name][1], _jax_module(name)
    records, meta = _read("elasticdl_tpu_torch", path)
    got = twin.dataset_fn(records[:5], Mode.PREDICTION, meta)
    want = jmod.dataset_fn(records[:5], Mode.PREDICTION, meta)
    _assert_tree_equal(got[0], want[0])
    _assert_tree_equal(got[1], want[1])


# ---- the forward -----------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(TWINS))
def test_tabular_twin_forward_matches_jax(name, dtype, tmp_path):
    jdt, tdt, tol = DTYPES[dtype]
    batch = _batches(name, tmp_path, n_batches=1)
    features = batch["jax"][0]["features"]
    params = _init(name, features)
    jmodel = TWINS[name][2](_jax_module(name), jdt)
    model = TWINS[name][3](tdt)
    state = bridge.flax_state_dict(params)
    assert sorted(state) == sorted(model.state_dict())
    model.load_state_dict(state)
    want = np.asarray(jmodel.apply(params, _jnp(features)))
    with torch.no_grad():
        got = model.eval()(_torch(batch["port"][0]["features"]))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert rel(got, want) <= tol


# ---- three train steps at f32 ----------------------------------------------


def _optimizers(name):
    """(optax transformation, the port's factory), with the zoo's
    callbacks folded in as each executor folds them."""
    jmod, twin = _jax_module(name), TWINS[name][1]
    tx, make = jmod.optimizer(), twin.optimizer()
    if hasattr(twin, "callbacks"):
        tx = jax_apply_callbacks(tx, jmod.callbacks())
        make = apply_callbacks_to_optimizer(make, twin.callbacks())
    return tx, make


@pytest.mark.parametrize("name", sorted(TWINS))
def test_tabular_twin_train_steps_match_jax(name, tmp_path):
    batches = _batches(name, tmp_path, n_batches=3, seed=2)
    params = _init(name, batches["jax"][0]["features"], seed=4)
    jmod, twin = _jax_module(name), TWINS[name][1]
    jmodel = TWINS[name][2](jmod, jnp.float32)
    tx, make_optimizer = _optimizers(name)
    jstate = JaxState.create(apply_fn=jmodel.apply, params=params["params"],
                             tx=tx)
    jtrain = jax_step.build_train_step(jmod.loss)
    model = TWINS[name][3](torch.float32)
    model.load_state_dict(bridge.flax_state_dict(params))
    state = init_train_state(model, make_optimizer)
    train = port_step.build_train_step(twin.loss)
    start = bridge.flax_state_dict(params)
    for jbatch, pbatch in zip(batches["jax"], batches["port"]):
        jstate, jmetrics = jtrain(jstate, jbatch)
        state, metrics = train(state, pbatch)
        assert rel(float(metrics["loss"]), float(jmetrics["loss"])) \
            <= LOSS_TOL
    want = bridge.flax_state_dict(jax.tree.map(np.asarray, jstate.params))
    got = model.state_dict()
    for key in want:
        moved = (want[key] - start[key]).numpy()
        assert np.any(moved), key
        assert rel(got[key] - start[key], moved) <= DELTA_TOL, key


def test_census_wide_deep_schedule_matches_jax():
    """The version multiplier (0.3, 0.2 from version 5000, 0.1 from
    12000) equals the JAX module's, and drives the optimizer's rate
    through the port's LearningRateScheduler."""
    jax_schedule = _jax_module("census_wide_deep").callbacks()[0].schedule
    versions = (0, 4999, 5000, 11999, 12000, 50000)
    assert [census_wide_deep.lr_multiplier(v) for v in versions] == \
        pytest.approx([float(jax_schedule(v)) for v in versions])
    weight = torch.nn.Parameter(torch.zeros(2))
    optimizer = apply_callbacks_to_optimizer(
        census_wide_deep.optimizer(), census_wide_deep.callbacks())([weight])
    assert optimizer.param_groups[0]["lr"] == pytest.approx(3e-4)


# ---- through the Local executor and serving --------------------------------


@pytest.mark.parametrize("name", sorted(TWINS))
def test_tabular_twin_trains_through_the_local_executor(name, tmp_path):
    """64 records at B 16 for 2 epochs (8 steps) with validation data:
    finite losses, eval metrics, the twin's own optimizer."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor

    train = _records_file(tmp_path, name, 64, 1)
    valid = _records_file(tmp_path, name, 16, 2)
    family = TWINS[name][0].split("/")[0]
    args = tdata.make_local_args(
        tdata.model_zoo_dir(), f"{family}.{name}.custom_model", train,
        validation_data=valid, minibatch_size=BATCH, num_epochs=2,
        extra=["--device", "cpu"])
    result = LocalExecutor(args).run()
    assert result["steps"] == 8 and np.isfinite(result["final_loss"])
    assert 0.0 <= result["eval_metrics"]["accuracy"] <= 1.0


def _post(port, payload):
    request = urllib.request.Request(
        f"http://localhost:{port}/v1/predict",
        data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_census_wide_deep_bundle_serves_dict_features(tmp_path):
    """``--output`` after a Local run: the bundle records the dict
    feature signature and serves ``{"ids", "dense"}`` on the CPU through
    ``load_served_model`` and a JSON predict to ``InferenceServer``,
    both as the trained model's eval forward answers."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.serving.export import META_FILE
    from elasticdl_tpu_torch.serving.model_store import (
        ModelStore,
        load_served_model,
    )
    from elasticdl_tpu_torch.serving.server import InferenceServer

    name = "census_wide_deep"
    train = _records_file(tmp_path, name, 64, 1)
    out = str(tmp_path / "bundle" / "v1")
    args = tdata.make_local_args(
        tdata.model_zoo_dir(), "census.census_wide_deep.custom_model", train,
        minibatch_size=BATCH, extra=["--device", "cpu", "--output", out])
    executor = LocalExecutor(args)
    executor.run()
    with open(os.path.join(out, META_FILE)) as f:
        signature = json.load(f)["feature_signature"]
    assert signature == {"ids": {"shape": [None, 4], "dtype": "int32"},
                         "dense": {"shape": [None, 2], "dtype": "float32"}}
    features = executor.last_batch["features"]
    with torch.no_grad():
        want = executor.state.model.eval()(_torch(features)).numpy()

    def model_fn():
        return census_wide_deep.custom_model(device="cpu")

    served = load_served_model(out, device="cpu", model_fn=model_fn)
    np.testing.assert_array_equal(served.predict(features), want)
    store = ModelStore(str(tmp_path / "bundle"), device="cpu",
                       model_fn=model_fn)
    store.load_initial()
    server = InferenceServer(store, port=0, batch_deadline_ms=1).start()
    try:
        status, body = _post(server.port, {"features": {
            "ids": features["ids"][:3].tolist(),
            "dense": features["dense"][:3].tolist()}})
    finally:
        server.stop()
    assert status == 200
    assert body["model_version"] == executor.state.step
    assert rel(np.asarray(body["predictions"]), want[:3]) <= 1e-6
