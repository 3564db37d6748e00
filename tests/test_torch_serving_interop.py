"""JAX bundles in the port's server, and the fleet across the two
packages, on the CPU.

- Bundles exported by the JAX package, served by the port
  (``ModelStore(device="cpu")`` with the zoo twin as ``model_fn``), each
  held to the JAX ``load_predictor`` (its StableHLO artifact) on the same
  inputs: deepfm_host with its table materialised dense, deepfm_host in
  row-service mode against a port ``HostRowService`` and against a JAX
  one (the JAX side served by the JAX ``load_served_model`` over the
  same service), mnist_functional (params and ``batch_stats``) and
  census_wide_deep. Tolerance: 1e-5 relative L2 where both sides compute
  in f32 (only the order of float sums differs), 2e-2 at the zoos' bf16
  (every product rounds to bf16; another order moves a rounding).
- Over HTTP: a port replica behind a JAX ``RouterServer`` and a JAX
  replica behind a port one answer as a direct request does, bit for
  bit; a port replica's 429 carries the JAX tier and ``Retry-After``,
  directly and through the JAX router.
- ``python -m elasticdl_tpu_torch serve --device cpu --row_service_addr
  ... --row_cache_capacity 64`` serves a row-service bundle, and
  ``python -m elasticdl_tpu_torch route --replicas ...`` routes to it;
  both exit 0 on SIGTERM.
"""

import http.client
import os
import re
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.core.model_spec import load_module
from elasticdl_tpu.core.train_state import init_train_state as jax_init
from elasticdl_tpu.embedding.optimizer import SGD as JaxSGD
from elasticdl_tpu.embedding.optimizer import (
    HostOptimizerWrapper as JaxWrapper,
)
from elasticdl_tpu.embedding.row_service import (
    HostRowService as JaxRowService,
)
from elasticdl_tpu.embedding.table import EmbeddingTable as JaxTable
from elasticdl_tpu.observability import MetricsRegistry as JaxRegistry
from elasticdl_tpu.serving import export as jax_export
from elasticdl_tpu.serving import model_store as jax_store
from elasticdl_tpu.serving import router as jax_router
from elasticdl_tpu.serving import server as jax_server
from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.embedding.optimizer import SGD, HostOptimizerWrapper
from elasticdl_tpu_torch.embedding.row_service import HostRowService
from elasticdl_tpu_torch.embedding.table import EmbeddingTable
from elasticdl_tpu_torch.model_zoo.census import census_wide_deep
from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host
from elasticdl_tpu_torch.model_zoo.mnist import mnist_functional
from elasticdl_tpu_torch.observability import MetricsRegistry
from elasticdl_tpu_torch.serving.model_store import ModelStore
from elasticdl_tpu_torch.serving.router import RouterServer
from elasticdl_tpu_torch.serving.server import InferenceServer
from elasticdl_tpu_torch.testing import data as tdata

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ZOO = os.path.join(REPO, "model_zoo")
TABLE, KEY, DIM = (deepfm_host.TABLE_NAME, deepfm_host.FEATURE_KEY,
                   deepfm_host.EMBEDDING_DIM)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B = 8


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _jitter(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(
            np.shape(a))).astype(np.asarray(a).dtype), tree)


def _jax_state(model, batch, seed=0, with_stats=False):
    state = jax_init(model, optax.sgd(0.1), batch, seed=0)
    state = state.replace(step=5, params=_jitter(state.params, seed))
    if with_stats:
        stats = jax.tree.map(
            lambda a: np.abs(np.asarray(a)) + np.linspace(
                0.5, 1.5, np.size(a), dtype=np.float32).reshape(
                np.shape(a)), state.batch_stats)
        state = state.replace(batch_stats=stats)
    return state


def _frappe_ids(seed, n=B):
    return np.random.default_rng(seed).integers(0, 5500, (n, 10)).astype(
        np.int32)


def _deepfm_host_models(dtype):
    jdt, tdt, _ = DTYPES[dtype]
    jmod = load_module(os.path.join(JAX_ZOO, "deepfm", "deepfm_host.py"))
    return (jmod.HostDeepFM(compute_dtype=jdt),
            lambda: deepfm_host.HostDeepFM(compute_dtype=tdt))


def _host_batch(ids):
    return {"features": {KEY: ids}, "labels": np.zeros(len(ids), np.int32),
            "mask": np.ones(len(ids), np.float32)}


def _trained_jax_table():
    table = JaxTable(TABLE, DIM)
    rng = np.random.default_rng(7)
    ids = rng.choice(5500, 300, replace=False)
    table.set(ids, rng.standard_normal((300, DIM)).astype(np.float32))
    return table


# ---- JAX bundles served by the port -----------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_jax_host_bundle_serves_its_dense_table(dtype, tmp_path):
    jmodel, port_model = _deepfm_host_models(dtype)
    batch = _host_batch(_frappe_ids(0))
    state = _jax_state(jmodel, batch)
    bundle = str(tmp_path / "host")
    table = _trained_jax_table()
    jax_export.export_serving_bundle(
        bundle, jmodel, state, batch_example=batch,
        model_def="deepfm.deepfm_host.custom_model",
        host_tables={TABLE: table}, host_vocab={TABLE: 5500})
    store = ModelStore(bundle, device="cpu", model_fn=port_model,
                       metrics_registry=MetricsRegistry())
    served = store.load_initial()
    assert served.version == 5
    features = {KEY: _frappe_ids(1)}
    want = np.asarray(jax_export.load_predictor(bundle)(features))
    got = served.predict(features)
    assert got.shape == want.shape == (B,)
    assert rel(got, want) <= DTYPES[dtype][2]


@pytest.mark.parametrize("service", ["port", "jax"])
def test_jax_row_service_bundle_serves_from_either_service(service,
                                                           tmp_path):
    """bf16 (the zoo's dtype): the port's answer against the JAX store's
    over the same live service and rows."""
    jmodel, port_model = _deepfm_host_models("bfloat16")
    batch = _host_batch(_frappe_ids(0))
    state = _jax_state(jmodel, batch)
    bundle = str(tmp_path / "rows")
    jax_export.export_serving_bundle(
        bundle, jmodel, state, batch_example=batch,
        model_def="deepfm.deepfm_host.custom_model",
        host_id_keys={TABLE: KEY})
    if service == "port":
        svc = HostRowService({TABLE: EmbeddingTable(TABLE, DIM)},
                             HostOptimizerWrapper(SGD(lr=0.5)),
                             metrics_registry=MetricsRegistry()).start()
    else:
        svc = JaxRowService({TABLE: JaxTable(TABLE, DIM)},
                            JaxWrapper(JaxSGD(lr=0.5)),
                            metrics_registry=JaxRegistry()).start()
    addr = f"localhost:{svc.port}"
    try:
        store = ModelStore(bundle, device="cpu", model_fn=port_model,
                           row_service_addr=addr, row_cache_capacity=64,
                           row_cache_version_check_secs=0,
                           metrics_registry=MetricsRegistry())
        served = store.load_initial()
        reference = jax_store.load_served_model(
            bundle, row_service_addr=addr, metrics_registry=JaxRegistry())
        features = {KEY: _frappe_ids(2)}
        got = served.predict(dict(features))
        want = np.asarray(reference.predict(dict(features)))
        assert rel(got, want) <= DTYPES["bfloat16"][2]
        # A push moves both sides alike.
        touched = np.unique(features[KEY])[:6].astype(np.int64)
        svc._push_row_grads({"table": TABLE, "ids": touched,
                             "grads": np.full((6, DIM), 3.0, np.float32)})
        moved = served.predict(dict(features))
        assert not np.allclose(moved, got)
        assert rel(moved, np.asarray(reference.predict(dict(features)))) \
            <= DTYPES["bfloat16"][2]
        store.stop()
    finally:
        svc.stop(0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_jax_mnist_bundle_carries_batch_stats(dtype, tmp_path):
    jdt, tdt, tol = DTYPES[dtype]
    jmod = load_module(os.path.join(JAX_ZOO, "mnist", "mnist_functional.py"))
    jmodel = jmod.MnistModel(compute_dtype=jdt)
    images = np.random.default_rng(3).standard_normal(
        (B, 28, 28)).astype(np.float32)
    batch = {"features": images, "labels": np.zeros(B, np.int32),
             "mask": np.ones(B, np.float32)}
    state = _jax_state(jmodel, batch, with_stats=True)
    bundle = str(tmp_path / "mnist")
    jax_export.export_serving_bundle(
        bundle, jmodel, state, batch_example=batch,
        model_def="mnist.mnist_functional.custom_model")
    store = ModelStore(bundle, device="cpu", metrics_registry=MetricsRegistry(),
                       model_fn=lambda: mnist_functional.MnistModel(
                           compute_dtype=tdt))
    served = store.load_initial()
    want = np.asarray(jax_export.load_predictor(bundle)(images))
    got = served.predict(images)
    assert got.shape == want.shape == (B, 10)
    assert rel(got, want) <= tol
    # The statistics crossed: the module holds the bundle's, not its
    # initial ones.
    from elasticdl_tpu_torch.serving.export import load_model

    module = load_model(bundle, device="cpu", model_fn=lambda: (
        mnist_functional.MnistModel(compute_dtype=tdt)))
    for name, value in state.batch_stats["BatchNorm_0"].items():
        np.testing.assert_array_equal(
            module.state_dict()[f"BatchNorm_0.{name}"].numpy(), value)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_jax_census_wide_deep_bundle(dtype, tmp_path):
    jdt, tdt, tol = DTYPES[dtype]
    path = tdata.create_census_record_file(str(tmp_path / "census.rec"), B,
                                           seed=1)
    from elasticdl_tpu_torch.common.task import Task
    from elasticdl_tpu_torch.data.factory import create_data_reader

    reader = create_data_reader(data_origin=path)
    records = []
    for task_id, (shard, (start, count)) in enumerate(
            reader.create_shards().items()):
        records += list(reader.read_records(Task(
            task_id=task_id, shard_name=shard, start=start,
            end=start + count, type=Mode.TRAINING)))
    features, labels = census_wide_deep.dataset_fn(records, Mode.TRAINING,
                                                   reader.metadata)
    jmod = load_module(os.path.join(JAX_ZOO, "census",
                                    "census_wide_deep.py"))
    jmodel = jmod.WideAndDeep(compute_dtype=jdt)
    batch = {"features": features, "labels": labels,
             "mask": np.ones(B, np.float32)}
    state = _jax_state(jmodel, batch)
    bundle = str(tmp_path / "census")
    jax_export.export_serving_bundle(
        bundle, jmodel, state, batch_example=batch,
        model_def="census.census_wide_deep.custom_model")
    store = ModelStore(bundle, device="cpu", metrics_registry=MetricsRegistry(),
                       model_fn=lambda: census_wide_deep.WideAndDeep(
                           compute_dtype=tdt))
    served = store.load_initial()
    want = np.asarray(jax_export.load_predictor(bundle)(features))
    got = served.predict(features)
    assert got.shape == want.shape
    assert rel(got, want) <= tol


# ---- the fleet across the two packages --------------------------------


def _post(port, body, headers=None):
    conn = http.client.HTTPConnection("localhost", port, timeout=30)
    try:
        send = {"Content-Type": "application/x-msgpack"}
        send.update(headers or {})
        conn.request("POST", "/v1/predict", body=body, headers=send)
        resp = conn.getresponse()
        raw = resp.read()
        return (resp.status, raw, resp.getheader("Retry-After"),
                resp.getheader("X-Shed-Tier"))
    finally:
        conn.close()


@pytest.fixture(scope="module")
def host_bundle(tmp_path_factory):
    """A JAX deepfm_host bundle (bf16, dense table) and its port twin."""
    root = tmp_path_factory.mktemp("fleet")
    jmodel, port_model = _deepfm_host_models("bfloat16")
    batch = _host_batch(_frappe_ids(0))
    bundle = str(root / "v5")
    jax_export.export_serving_bundle(
        bundle, jmodel, _jax_state(jmodel, batch), batch_example=batch,
        model_def="deepfm.deepfm_host.custom_model",
        host_tables={TABLE: _trained_jax_table()},
        host_vocab={TABLE: 5500})
    return bundle, port_model


def _port_replica(bundle, port_model, **kw):
    store = ModelStore(bundle, device="cpu", model_fn=port_model,
                       metrics_registry=MetricsRegistry())
    store.load_initial()
    return InferenceServer(store, port=0, batch_deadline_ms=1.0,
                           metrics_registry=MetricsRegistry(), **kw).start()


def _jax_replica(bundle, **kw):
    store = jax_store.ModelStore(bundle, metrics_registry=JaxRegistry())
    store.load_initial()
    return jax_server.InferenceServer(store, port=0, batch_deadline_ms=1.0,
                                      metrics_registry=JaxRegistry(),
                                      **kw).start()


def test_port_replica_behind_a_jax_router(host_bundle):
    bundle, port_model = host_bundle
    replica = _port_replica(bundle, port_model)
    router = jax_router.RouterServer([f"localhost:{replica.port}"], port=0,
                                     metrics_registry=JaxRegistry()).start()
    try:
        body = tensor_utils.dumps({"features": {KEY: _frappe_ids(4)}})
        direct = _post(replica.port, body)
        routed = _post(router.port, body, headers={"X-Priority": "high",
                                                   "X-User-Id": "u1"})
        assert direct[0] == routed[0] == 200
        np.testing.assert_array_equal(
            tensor_utils.loads(routed[1])["predictions"],
            tensor_utils.loads(direct[1])["predictions"])
    finally:
        router.stop()
        replica.stop()


@pytest.mark.parametrize("policy", ["least_loaded", "hash"])
def test_jax_replica_behind_a_port_router(host_bundle, policy):
    bundle, _ = host_bundle
    replicas = [_jax_replica(bundle), _jax_replica(bundle)]
    router = RouterServer([f"localhost:{r.port}" for r in replicas], port=0,
                          policy=policy,
                          metrics_registry=MetricsRegistry()).start()
    try:
        body = tensor_utils.dumps({"features": {KEY: _frappe_ids(5)}})
        direct = _post(replicas[0].port, body)
        for user in ("a", "b", "c"):
            routed = _post(router.port, body, headers={"X-User-Id": user})
            assert routed[0] == 200
            np.testing.assert_array_equal(
                tensor_utils.loads(routed[1])["predictions"],
                tensor_utils.loads(direct[1])["predictions"])
    finally:
        router.stop()
        for r in replicas:
            r.stop()


def test_port_replica_429_carries_the_jax_tier(host_bundle):
    bundle, port_model = host_bundle
    replica = _port_replica(bundle, port_model, max_queue=0)
    router = jax_router.RouterServer([f"localhost:{replica.port}"], port=0,
                                     hedge=False,
                                     metrics_registry=JaxRegistry()).start()
    try:
        body = tensor_utils.dumps({"features": {KEY: _frappe_ids(6)}})
        status, _, retry_after, tier = _post(replica.port, body)
        assert status == 429 and int(retry_after) >= 1
        assert tier == "capacity"
        status, _, retry_after, _ = _post(router.port, body)
        assert status == 429 and int(retry_after) >= 1
    finally:
        router.stop()
        replica.stop()


def _wait_for_port(proc, pattern, lines, timeout=120.0):
    """Read the child's stderr until ``pattern`` names its port."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stderr.readline()
        if not line:
            if proc.poll() is not None:
                break
            continue
        lines.append(line)
        found = re.search(pattern, line)
        if found:
            return int(found.group(1))
    raise AssertionError(f"no port from {proc.args}: {''.join(lines)}")


def test_serve_and_route_cli_serve_a_row_service_bundle(tmp_path):
    """The two entry points in subprocesses over a row service in this
    process: the routed answer equals the in-process port store's over
    the same service, bit for bit."""
    jmodel, port_model = _deepfm_host_models("bfloat16")
    batch = _host_batch(_frappe_ids(0))
    bundle = str(tmp_path / "rows")
    jax_export.export_serving_bundle(
        bundle, jmodel, _jax_state(jmodel, batch), batch_example=batch,
        model_def="deepfm.deepfm_host.custom_model",
        host_id_keys={TABLE: KEY})
    svc = HostRowService({TABLE: EmbeddingTable(TABLE, DIM)},
                         HostOptimizerWrapper(SGD(lr=0.5)),
                         metrics_registry=MetricsRegistry()).start()
    addr = f"localhost:{svc.port}"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = []
    try:
        serve = subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch", "serve",
             "--device", "cpu", "--model_dir", bundle, "--port", "0",
             "--model_zoo", tdata.model_zoo_dir(),
             "--row_service_addr", addr, "--row_cache_capacity", "64",
             "--batch_deadline_ms", "1"],
            cwd=REPO, env=env, stderr=subprocess.PIPE, text=True)
        procs.append(serve)
        serve_log = []
        serve_port = _wait_for_port(serve, r"Inference server on port (\d+)",
                                    serve_log)
        route = subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch", "route",
             "--replicas", f"localhost:{serve_port}", "--port", "0"],
            cwd=REPO, env=env, stderr=subprocess.PIPE, text=True)
        procs.append(route)
        route_port = _wait_for_port(route, r"Router on port (\d+)", [])
        features = {KEY: _frappe_ids(8)}
        status, raw, _, _ = _post(route_port,
                                  tensor_utils.dumps({"features": features}))
        assert status == 200, raw
        store = ModelStore(bundle, device="cpu", model_fn=port_model,
                           row_service_addr=addr,
                           metrics_registry=MetricsRegistry())
        want = store.load_initial().predict(dict(features))
        np.testing.assert_array_equal(
            tensor_utils.loads(raw)["predictions"], want)
        for proc in reversed(procs):
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        svc.stop(0)
