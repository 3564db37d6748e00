"""The port's serving plane against the JAX package's.

A transformer-LM bundle exported by elasticdl_tpu's
``export_serving_bundle`` (flax msgpack params + StableHLO) is loaded by
the port's ``ModelStore(device="cpu")`` and served by its
``InferenceServer``; JSON and msgpack answers are held against the JAX
bundle's own ``load_predictor`` (the StableHLO artifact) on the same
tokens. Tolerance: rtol/atol 1e-4 in f32 compute (f32 sums in another
order through two blocks and the head); 2e-2 relative L2 error where
the port infers the config and so computes in bf16.
"""

import ast
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.core.train_state import init_train_state
from elasticdl_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    TransformerLM as JaxLM,
)
from elasticdl_tpu.serving import export as jax_export
from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
)
from elasticdl_tpu_torch.serving import export as port_export
from elasticdl_tpu_torch.serving.model_store import (
    ModelStore,
    load_served_model,
)
from elasticdl_tpu_torch.serving.server import (
    BatchingPredictor,
    InferenceServer,
)

V, S = 97, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_bundle(tmp_path_factory):
    """(bundle root, JAX predictor, f32 port-config factory)."""
    root = tmp_path_factory.mktemp("jax_bundles")
    model = JaxLM(JaxConfig(vocab_size=V, d_model=128, n_heads=2,
                            n_layers=2, d_ff=128, max_len=S,
                            compute_dtype=jnp.float32))
    batch = {"features": np.zeros((2, S), np.int32),
             "labels": np.zeros((2, S), np.int32),
             "mask": np.ones((2,), np.float32)}
    state = init_train_state(model, optax.sgd(0.1), batch, seed=0)
    rng = np.random.default_rng(0)
    state = state.replace(step=3, params=jax.tree.map(
        lambda x: x + 0.05 * rng.standard_normal(np.shape(x)).astype(
            np.float32), state.params))
    bundle = str(root / "v3")
    jax_export.export_serving_bundle(
        bundle, model, state, batch_example=batch,
        model_def="transformer.transformer_lm.custom_model",
    )
    predict = jax_export.load_predictor(bundle)
    cfg = bridge.config_from_params(
        jax.tree.map(np.asarray, state.params), compute_dtype=torch.float32)
    return str(root), lambda x: np.asarray(predict(x)), (
        lambda: TransformerLM(cfg))


def _tokens(seed, b=1):
    return np.random.default_rng(seed).integers(
        0, V, (b, S)).astype(np.int32)


def _request(port, path, payload=None, msgpack=False, method=None):
    headers = {}
    data = None
    if payload is not None:
        if msgpack:
            data = tensor_utils.dumps(payload)
            headers["Content-Type"] = "application/x-msgpack"
        else:
            data = json.dumps(payload).encode("utf-8")
            headers["Content-Type"] = "application/json"
    request = urllib.request.Request(f"http://localhost:{port}{path}",
                                     data=data, headers=headers,
                                     method=method)
    try:
        with urllib.request.urlopen(request, timeout=60) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        status, raw = exc.code, exc.read()
    if msgpack and raw:
        return status, tensor_utils.loads(raw)
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw


@pytest.fixture(scope="module")
def server(jax_bundle):
    root, _, model_fn = jax_bundle
    store = ModelStore(root, device="cpu", model_fn=model_fn)
    store.load_initial()
    srv = InferenceServer(store, max_batch_size=8, batch_deadline_ms=200,
                          port=0).start()
    yield srv
    srv.stop()


@pytest.mark.parametrize("msgpack", [False, True])
def test_answers_match_jax_predictor(jax_bundle, server, msgpack):
    _, jax_predict, _ = jax_bundle
    tokens = _tokens(1, b=2)
    features = tokens if msgpack else tokens.tolist()
    status, body = _request(server.port, "/v1/predict",
                            {"features": features}, msgpack=msgpack)
    assert status == 200
    assert body["model_version"] == 3
    np.testing.assert_allclose(np.asarray(body["predictions"]),
                               jax_predict(tokens), **F32_TOL)


def test_concurrent_requests_are_batched(jax_bundle, server):
    _, jax_predict, _ = jax_bundle
    requests = [_tokens(10 + i) for i in range(3)]
    replies = [None] * 3
    before = sum(server.predictor.batch_occupancy.values())

    def send(i):
        replies[i] = _request(server.port, "/v1/predict",
                              {"features": requests[i].tolist()})

    threads = [threading.Thread(target=send, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert [status for status, _ in replies] == [200, 200, 200]
    assert max(server.predictor.batch_occupancy) > 1
    assert sum(server.predictor.batch_occupancy.values()) - before < 3
    for tokens, (_, body) in zip(requests, replies):
        np.testing.assert_allclose(np.asarray(body["predictions"]),
                                   jax_predict(tokens), **F32_TOL)


def test_models_and_health_endpoints(server):
    status, body = _request(server.port, "/v1/models")
    assert status == 200 and body["current"] == 3
    assert body["meta"]["model_def"] == (
        "transformer.transformer_lm.custom_model")
    assert _request(server.port, "/healthz")[0] == 200


@pytest.mark.parametrize("payload,code", [
    ({"features": "not tokens"}, 400),
    ({"no_features": 1}, 400),
    ({"features": [[V + 5] * 8]}, 400),         # id outside the vocab
    ({"features": [[1, 2], [3]]}, 400),         # ragged
])
def test_bad_features_answer_400(server, payload, code):
    status, body = _request(server.port, "/v1/predict", payload)
    assert status == code and "error" in body


def test_unknown_paths_answer_404(server):
    assert _request(server.port, "/nope")[0] == 404
    assert _request(server.port, "/v1/nope", {"features": [[1]]})[0] == 404


def test_inferred_config_serves_jax_bundle_in_bf16(jax_bundle):
    root, jax_predict, _ = jax_bundle
    served = load_served_model(os.path.join(root, "v3"), device="cpu")
    tokens = _tokens(2)
    got = served.predict(tokens)
    want = jax_predict(tokens)
    assert got.shape == want.shape == (1, S, V)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-2


def test_flax_msgpack_decodes_with_numpy_alone(jax_bundle):
    root, _, _ = jax_bundle
    from flax import serialization

    path = os.path.join(root, "v3", port_export.FLAX_PARAMS_FILE)
    with open(path, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    got = port_export.load_flax_params(path)
    jax.tree.map(np.testing.assert_array_equal, got, want)


def _port_bundle(path, version, seed):
    """Export a one-block f32 port model with seeded weights."""
    cfg = TransformerConfig(vocab_size=V, d_model=128, n_heads=2,
                            n_layers=1, d_ff=64, max_len=S,
                            compute_dtype=torch.float32)
    model = TransformerLM(cfg)
    model.load_state_dict(bridge.state_dict_from_flax(
        bridge.init_flax_params(cfg, seed)))
    port_export.export_serving_bundle(
        path, model, batch_example=np.zeros((2, S), np.int32),
        model_def="transformer.transformer_lm.custom_model",
        version=version)
    return model.eval()


def test_port_export_round_trips(tmp_path):
    model = _port_bundle(str(tmp_path), version=5, seed=1)
    with open(tmp_path / port_export.META_FILE) as f:
        meta = json.load(f)
    assert {"model_version", "model_def", "format", "feature_signature",
            "batch_polymorphic", "batch_size", "self_contained"} <= set(meta)
    assert meta["self_contained"] is False
    assert meta["feature_signature"] == {"shape": [None, S],
                                         "dtype": "int32"}
    tokens = _tokens(3, b=2)
    with torch.inference_mode():
        want = model(torch.from_numpy(tokens)).numpy()
    got = port_export.load_predictor(str(tmp_path), device="cpu")(tokens)
    np.testing.assert_array_equal(got, want)


def test_hot_reload_and_rollback(tmp_path):
    _port_bundle(str(tmp_path / "v1"), version=1, seed=1)
    store = ModelStore(str(tmp_path), device="cpu", poll_seconds=60)
    store.load_initial()
    srv = InferenceServer(store, port=0, batch_deadline_ms=1).start()
    try:
        tokens = _tokens(4)
        _, v1 = _request(srv.port, "/v1/predict",
                         {"features": tokens.tolist()})
        assert v1["model_version"] == 1
        assert store.poll_once() is False
        _port_bundle(str(tmp_path / "v2"), version=2, seed=2)
        assert store.poll_once() is True
        _, v2 = _request(srv.port, "/v1/predict",
                         {"features": tokens.tolist()})
        assert v2["model_version"] == 2
        assert not np.allclose(v1["predictions"], v2["predictions"])
        assert _request(srv.port, "/v1/models")[1]["versions"] == [1, 2]
        status, body = _request(srv.port, "/v1/models/rollback", {})
        assert status == 200 and body["current"] == 1
        _, back = _request(srv.port, "/v1/predict",
                           {"features": tokens.tolist()})
        np.testing.assert_array_equal(back["predictions"], v1["predictions"])
        assert store.poll_once() is False           # v2 stays pinned out
        assert _request(srv.port, "/v1/models/rollback", {})[0] == 409
    finally:
        srv.stop()


def test_full_queue_sheds_with_429(tmp_path):
    from elasticdl_tpu_torch.observability import MetricsRegistry

    _port_bundle(str(tmp_path), version=1, seed=1)
    store = ModelStore(str(tmp_path), device="cpu")
    store.load_initial()
    registry = MetricsRegistry()
    srv = InferenceServer(store, port=0, max_queue=0,
                          metrics_registry=registry).start()
    try:
        status, body = _request(srv.port, "/v1/predict",
                                {"features": _tokens(5).tolist()})
        assert status == 429 and "queue full" in body["error"]
        (family,) = [f for f in registry.snapshot()["families"]
                     if f["name"] == "edl_tpu_serving_requests_total"]
        assert [(s["labels"], s["value"]) for s in family["series"]] == [
            (["429"], 1.0)]
    finally:
        srv.stop()


def test_drain_flushes_queued_work_then_refuses(tmp_path):
    _port_bundle(str(tmp_path), version=1, seed=1)
    store = ModelStore(str(tmp_path), device="cpu")
    store.load_initial()
    srv = InferenceServer(store, port=0, batch_deadline_ms=100).start()
    predictor = srv.predictor
    tokens = _tokens(6)
    result = {}
    sender = threading.Thread(
        target=lambda: result.update(out=predictor.submit(tokens)))
    sender.start()
    deadline = time.monotonic() + 10
    while not (predictor._queue or predictor._busy
               or predictor.batch_occupancy):
        assert time.monotonic() < deadline, "request never queued"
        time.sleep(0.005)
    assert srv.drain(grace=10) is True
    sender.join()
    outputs, version = result["out"]
    assert outputs.shape == (1, S, V) and version == 1
    with pytest.raises(BatchingPredictor.QueueFullError, match="draining"):
        predictor.submit(tokens)


@pytest.mark.parametrize("n,limit,bucket", [(1, 64, 1), (3, 64, 4),
                                            (5, 6, 6), (9, 8, 9)])
def test_bucket_batch(n, limit, bucket):
    assert BatchingPredictor.bucket_batch(n, limit) == bucket


def test_row_service_bundle_is_refused(tmp_path):
    """A row-service bundle with no row source is refused, as the JAX
    store refuses it: no --row_service_addr."""
    with open(tmp_path / "metadata.json", "w") as f:
        json.dump({"model_version": 1, "host_serving": {"id_keys": {}}}, f)
    with pytest.raises(ValueError, match="row_service_addr"):
        load_served_model(str(tmp_path), device="cpu")


def test_server_needs_cuda_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    _port_bundle(str(tmp_path), version=1, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelStore(str(tmp_path))
    from elasticdl_tpu_torch.serving.server import main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--model_dir", str(tmp_path), "--port", "0"])


def test_cli_dispatch():
    from elasticdl_tpu_torch.__main__ import main

    assert main(["train"]) == 2
    assert main([]) == 2


def test_port_imports_nothing_of_jax():
    """No file of the port (nor chip_smoke.py, nor the kernel tests that
    run on the card) imports jax, flax, optax or elasticdl_tpu; the
    package imports no framework at import."""
    banned = ("jax", "flax", "optax", "elasticdl_tpu")
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "test_torch_cuda_kernels.py")]
    for dirpath, _, names in os.walk(os.path.join(REPO,
                                                  "elasticdl_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in banned, (path, mod)
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, elasticdl_tpu_torch; "
         "print(sorted(m for m in ('torch', 'jax') if m in sys.modules))"],
        cwd=REPO, capture_output=True, text=True, check=True,
    ).stdout.strip()
    assert out == "[]"
