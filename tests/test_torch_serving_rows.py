"""The port's host-tier serving against the JAX package's: the hot-row
cache, the row resolver, the row service's table versions, dense
materialisation of host tables, and deepfm_host served from a live
row service end to end, on the CPU.

- The JAX cases (tests/test_serving_router.py ``TestHotRowCache``,
  ``TestRowServiceVersions``; tests/test_serving.py
  ``test_row_resolver_emits_traced_id_dtype`` and
  ``TestSparseEndToEnd``) run against ``elasticdl_tpu_torch``.
- The JAX ``materialize_host_rows`` and the port's give bit-equal dense
  tables for the same trained rows, on the Python table and on the
  native one, and neither grows the live store.
- The JAX ``HostRowResolver`` and the port's give bit-equal inverse
  maps and padded row blocks for the same ids, through a cache too.
- deepfm_host exported in row-service mode by the port and served by
  its ``InferenceServer`` over a port ``HostRowService`` (one shard, and
  two by a comma list): the answers equal the module's forward over the
  service's rows for the same ids, bit for bit (the same CPU ops on the
  same batch), follow a push, and a repeated request is served from the
  cache with no pull.
"""

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.embedding.host_engine import bucket_size
from elasticdl_tpu_torch.embedding.optimizer import SGD, HostOptimizerWrapper
from elasticdl_tpu_torch.embedding.row_service import (
    HostRowService,
    make_remote_engine,
)
from elasticdl_tpu_torch.embedding.table import EmbeddingTable
from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host
from elasticdl_tpu_torch.observability import MetricsRegistry
from elasticdl_tpu_torch.serving import export as port_export
from elasticdl_tpu_torch.serving.model_store import (
    HostRowResolver,
    HotRowCache,
    ModelStore,
)
from elasticdl_tpu_torch.serving.server import InferenceServer

TABLE, KEY, DIM = (deepfm_host.TABLE_NAME, deepfm_host.FEATURE_KEY,
                   deepfm_host.EMBEDDING_DIM)


def _snap(registry):
    return {f["name"]: f for f in registry.snapshot()["families"]}


def _series_value(snap, family, **labels):
    fam = snap.get(family)
    if fam is None:
        return 0.0
    want = list(labels.values())
    for series in fam["series"]:
        if series["labels"] == want:
            return series["value"]
    return 0.0


class _CountingTable:
    """Table-like with a bumpable version (the remote table's duck
    type)."""

    def __init__(self, dim=3):
        self.dim = dim
        self.version = 0
        self.pulls = []

    def get(self, ids):
        ids = np.asarray(ids)
        self.pulls.append(ids.copy())
        return np.stack([np.full((self.dim,), float(i), np.float32)
                         for i in ids]) if len(ids) else np.zeros(
            (0, self.dim), np.float32)

    def pull_version(self):
        return self.version


def _resolver(table, cache, registry=None):
    return HostRowResolver(
        {"id_keys": {"tbl": "ids"}, "tables": {"tbl": table.dim}},
        {"tbl": table}, row_cache=cache,
        metrics_registry=registry or MetricsRegistry())


class TestHotRowCache:
    def test_warm_resolve_skips_row_pull(self):
        registry = MetricsRegistry()
        table = _CountingTable()
        cache = HotRowCache(capacity=100, version_check_secs=0,
                            metrics_registry=registry)
        resolver = _resolver(table, cache, registry=registry)
        features = {"ids": np.array([[1, 2, 3]], np.int64)}
        out1 = resolver.resolve(dict(features))
        assert len(table.pulls) == 1
        out2 = resolver.resolve(dict(features))
        assert len(table.pulls) == 1
        np.testing.assert_array_equal(out1["__host_rows__:tbl"],
                                      out2["__host_rows__:tbl"])
        snap = _snap(registry)
        assert snap["edl_tpu_serving_row_cache_hits_total"]["series"][0][
            "value"] == 3.0
        assert _series_value(snap, "edl_tpu_serving_row_resolve_rows_total",
                             source="cache") == 3.0
        assert snap["edl_tpu_serving_row_resolve_seconds"]["series"][0][
            "count"] == 2

    def test_partial_hit_pulls_only_misses(self):
        table = _CountingTable()
        cache = HotRowCache(capacity=100, version_check_secs=0,
                            metrics_registry=MetricsRegistry())
        resolver = _resolver(table, cache)
        resolver.resolve({"ids": np.array([[1, 2]], np.int64)})
        resolver.resolve({"ids": np.array([[2, 5]], np.int64)})
        assert [list(p) for p in table.pulls] == [[1, 2], [5]]

    def test_version_bump_invalidates_read_your_writes(self):
        registry = MetricsRegistry()
        table = _CountingTable()
        cache = HotRowCache(capacity=100, version_check_secs=0,
                            metrics_registry=registry)
        resolver = _resolver(table, cache)
        features = {"ids": np.array([[7, 8]], np.int64)}
        resolver.resolve(dict(features))
        resolver.resolve(dict(features))
        assert len(table.pulls) == 1
        table.version += 1
        resolver.resolve(dict(features))
        assert len(table.pulls) == 2
        assert [list(p) for p in table.pulls][1] == [7, 8]
        snap = _snap(registry)
        assert snap["edl_tpu_serving_row_cache_invalidations_total"][
            "series"][0]["value"] == 2.0

    def test_lru_eviction_under_capacity(self):
        registry = MetricsRegistry()
        table = _CountingTable()
        cache = HotRowCache(capacity=2, version_check_secs=-1,
                            metrics_registry=registry)
        resolver = _resolver(table, cache)
        resolver.resolve({"ids": np.array([[1, 2]], np.int64)})
        resolver.resolve({"ids": np.array([[3]], np.int64)})  # evicts 1
        resolver.resolve({"ids": np.array([[1]], np.int64)})  # miss
        assert [list(p) for p in table.pulls] == [[1, 2], [3], [1]]
        snap = _snap(registry)
        assert snap["edl_tpu_serving_row_cache_evictions_total"][
            "series"][0]["value"] >= 1.0

    def test_fill_straddling_invalidation_is_dropped(self):
        table = _CountingTable()
        cache = HotRowCache(capacity=100, version_check_secs=0,
                            metrics_registry=MetricsRegistry())
        cache._check_versions({"tbl": table})  # records v0
        epoch = cache.table_epoch("tbl")
        stale_rows = np.ones((1, 3), np.float32)
        table.version += 1  # a push lands while the pull is in flight
        cache._check_versions({"tbl": table})  # the probe invalidates
        cache.put_many("tbl", np.array([9]), stale_rows, epoch=epoch)
        out = np.zeros((1, 3), np.float32)
        assert cache.get_many("tbl", np.array([9]), out).all(), \
            "stale fill was cached past an invalidation"
        cache.put_many("tbl", np.array([9]), stale_rows,
                       epoch=cache.table_epoch("tbl"))
        assert not cache.get_many("tbl", np.array([9]), out).any()

    def test_background_probe_invalidates_without_inline_rpc(self):
        """A positive interval probes on its own thread: a warm resolve
        issues no version read, and a bump is seen within a few
        intervals."""
        table = _CountingTable()
        cache = HotRowCache(capacity=100, version_check_secs=0.01,
                            metrics_registry=MetricsRegistry())
        resolver = _resolver(table, cache)
        features = {"ids": np.array([[4, 5]], np.int64)}
        try:
            resolver.resolve(dict(features))
            deadline = time.monotonic() + 5
            while "tbl" not in cache.stats()["versions"]:
                assert time.monotonic() < deadline, "never probed"
                time.sleep(0.005)
            assert len(cache) == 2
            table.version += 1
            while len(cache):
                assert time.monotonic() < deadline, "never invalidated"
                time.sleep(0.005)
            resolver.resolve(dict(features))
            assert len(table.pulls) == 2
        finally:
            cache.stop()

    def test_uncached_resolver_still_counts_rows(self):
        registry = MetricsRegistry()
        table = _CountingTable()
        resolver = HostRowResolver(
            {"id_keys": {"tbl": "ids"}, "tables": {"tbl": table.dim}},
            {"tbl": table}, metrics_registry=registry)
        resolver.resolve({"ids": np.array([[4, 4, 9]], np.int64)})
        snap = _snap(registry)
        assert _series_value(snap, "edl_tpu_serving_row_resolve_rows_total",
                             source="pull") == 2.0
        assert snap["edl_tpu_serving_row_resolve_seconds"]["series"][0][
            "count"] == 1


class TestRowServiceVersions:
    def test_push_bumps_version_duplicate_does_not(self):
        service = HostRowService({"tbl": EmbeddingTable("tbl", 3)},
                                 HostOptimizerWrapper(SGD(lr=0.5)),
                                 metrics_registry=MetricsRegistry())

        def version():
            return service._table_versions_handler({})["versions"]["tbl"]

        assert version() == 0
        push = {"table": "tbl", "ids": np.array([1, 2], np.int64),
                "grads": np.ones((2, 3), np.float32), "client": "c",
                "seq": 1}
        service._push_row_grads(dict(push))
        assert version() == 1
        service._push_row_grads(dict(push))   # a retried duplicate
        assert version() == 1
        assert service._table_versions_handler({})["versions"] == {"tbl": 1}

    def test_remote_and_sharded_pull_version(self):
        services = [HostRowService({"tbl": EmbeddingTable("tbl", 3)},
                                   HostOptimizerWrapper(SGD(lr=0.5)),
                                   metrics_registry=MetricsRegistry()).start()
                    for _ in range(2)]
        try:
            addr = ",".join(f"localhost:{s.port}" for s in services)
            engine = make_remote_engine(addr, id_keys={"tbl": "ids"},
                                        retries=2, backoff_secs=0.05)
            sharded = engine.tables["tbl"]
            assert sharded.pull_version() == 0
            services[1]._push_row_grads({
                "table": "tbl", "ids": np.array([4], np.int64),
                "grads": np.ones((1, 3), np.float32)})
            assert sharded.pull_version() == 1
        finally:
            for s in services:
                s.stop(0)


def test_row_resolver_emits_traced_id_dtype():
    class Table:
        def get(self, ids):
            return np.zeros((len(ids), 4), np.float32)

    resolver = HostRowResolver(
        {"id_keys": {"tbl": "ids"}, "tables": {"tbl": 4}}, {"tbl": Table()},
        feature_signature={"ids": {"shape": [None, 3], "dtype": "int64"}},
        metrics_registry=MetricsRegistry())
    out = resolver.resolve({"ids": np.array([[5, 5, 9]], np.int64)})
    assert out["ids"].dtype == np.int64
    assert out["__host_rows__:tbl"].shape == (8, 4)
    resolver32 = HostRowResolver(
        {"id_keys": {"tbl": "ids"}, "tables": {"tbl": 4}}, {"tbl": Table()},
        metrics_registry=MetricsRegistry())
    out32 = resolver32.resolve({"ids": np.array([[5, 5, 9]], np.int64)})
    assert out32["ids"].dtype == np.int32


# ---- parity with the JAX package's helpers ---------------------------


def _table_pair(kind):
    """(JAX table, port table) of one name and width: the Python
    EmbeddingTable or the native store of each package."""
    if kind == "python":
        from elasticdl_tpu.embedding.table import EmbeddingTable as JaxTable

        return JaxTable("emb", 8), EmbeddingTable("emb", 8)
    from elasticdl_tpu.native.row_store import (
        NativeEmbeddingTable as JaxNative,
    )
    from elasticdl_tpu_torch.native.row_store import NativeEmbeddingTable

    return JaxNative("emb", 8), NativeEmbeddingTable("emb", 8)


@pytest.mark.parametrize("kind", ["python", "native"])
def test_materialize_host_rows_matches_jax(kind):
    from elasticdl_tpu.serving.export import (
        materialize_host_rows as jax_materialize,
    )

    jax_table, port_table = _table_pair(kind)
    rng = np.random.default_rng(0)
    ids = rng.choice(300, 40, replace=False).astype(np.int64)
    ids = np.concatenate([ids, [1000]])   # a trained row beyond the vocab
    rows = rng.standard_normal((len(ids), 8)).astype(np.float32)
    jax_table.set(ids, rows)
    port_table.set(ids, rows)
    before = (jax_table.num_rows, port_table.num_rows)
    want = jax_materialize({"emb": jax_table}, {"emb": 300}, chunk=64)
    got = port_export.materialize_host_rows({"emb": port_table},
                                            {"emb": 300}, chunk=64)
    assert got["emb"].shape == (300, 8)
    np.testing.assert_array_equal(got["emb"], want["emb"])
    assert (jax_table.num_rows, port_table.num_rows) == before
    with pytest.raises(ValueError, match="unknown tables"):
        port_export.materialize_host_rows({"emb": port_table}, {"x": 4})


def test_row_resolver_matches_jax():
    """The same ids through each package's resolver over one table, with
    and then without its cache: bit-equal inverse maps (and dtypes) and
    padded row blocks."""
    from elasticdl_tpu.observability import MetricsRegistry as JaxRegistry
    from elasticdl_tpu.serving.model_store import (
        HostRowResolver as JaxResolver,
    )
    from elasticdl_tpu.serving.model_store import HotRowCache as JaxCache

    serving = {"id_keys": {"tbl": "ids"}, "tables": {"tbl": 5}}
    signature = {"ids": {"shape": [None, 6], "dtype": "int32"}}
    table = _CountingTable(dim=5)
    ours = HostRowResolver(
        serving, {"tbl": table}, feature_signature=signature,
        row_cache=HotRowCache(16, version_check_secs=-1,
                              metrics_registry=MetricsRegistry()),
        metrics_registry=MetricsRegistry())
    theirs = JaxResolver(
        serving, {"tbl": table}, feature_signature=signature,
        row_cache=JaxCache(16, version_check_secs=-1,
                           metrics_registry=JaxRegistry()),
        metrics_registry=JaxRegistry())
    rng = np.random.default_rng(1)
    for _ in range(4):
        ids = rng.integers(0, 30, (3, 6)).astype(np.int32)
        got = ours.resolve({"ids": ids, "dense": np.ones((3, 2))})
        want = theirs.resolve({"ids": ids, "dense": np.ones((3, 2))})
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key])


# ---- deepfm_host served from a live row service ----------------------


def _post(port, payload, msgpack=True):
    if msgpack:
        data = tensor_utils.dumps(payload)
        ctype = "application/x-msgpack"
    else:
        data = json.dumps(payload).encode("utf-8")
        ctype = "application/json"
    request = urllib.request.Request(f"http://localhost:{port}/v1/predict",
                                     data=data,
                                     headers={"Content-Type": ctype})
    with urllib.request.urlopen(request, timeout=60) as resp:
        raw = resp.read()
        return resp.status, (tensor_utils.loads(raw) if msgpack
                             else json.loads(raw))


@pytest.mark.parametrize("shards", [1, 2])
def test_deepfm_host_bundle_serves_through_row_service(shards, tmp_path):
    """A row-service bundle serves over HTTP with rows pulled from live
    services, reflects a push made after export, and serves a repeated
    request from the hot-row cache without a pull."""
    torch.manual_seed(0)
    model = deepfm_host.custom_model(device="cpu").eval()
    rng = np.random.default_rng(0)
    batch = {"features": {KEY: rng.integers(0, 500, (4, 10)).astype(
        np.int32)}, "labels": np.zeros(4, np.int32),
        "mask": np.ones(4, np.float32)}
    bundle = str(tmp_path / "bundle")
    port_export.export_serving_bundle(
        bundle, model, batch_example=batch,
        model_def="deepfm.deepfm_host.custom_model", version=7,
        host_id_keys={TABLE: KEY})
    meta = json.loads(open(os.path.join(bundle, "metadata.json")).read())
    assert meta["host_serving"] == {
        "id_keys": {TABLE: KEY}, "tables": {TABLE: DIM},
        "rows_feature_prefix": "__host_rows__:"}
    assert meta["self_contained"] is False
    assert not os.path.exists(os.path.join(bundle, port_export.HOST_ROWS_FILE))

    registries = [MetricsRegistry() for _ in range(shards)]
    services = [HostRowService({TABLE: EmbeddingTable(TABLE, DIM)},
                               HostOptimizerWrapper(SGD(lr=0.5)),
                               metrics_registry=r).start()
                for r in registries]
    addr = ",".join(f"localhost:{s.port}" for s in services)
    client = make_remote_engine(addr, id_keys={TABLE: KEY}, retries=2,
                                backoff_secs=0.05)
    reader = client.tables[TABLE]
    registry = MetricsRegistry()
    store = ModelStore(
        bundle, device="cpu", row_service_addr=addr,
        model_fn=lambda: deepfm_host.custom_model(device="cpu"),
        row_cache_capacity=64, row_cache_version_check_secs=0,
        metrics_registry=registry)
    store.load_initial()
    server = InferenceServer(store, max_batch_size=8, batch_deadline_ms=2.0,
                             port=0, metrics_registry=registry).start()

    def reference(q_ids):
        uniq, inverse = np.unique(q_ids, return_inverse=True)
        rows = np.zeros((bucket_size(len(uniq)), DIM), np.float32)
        rows[:len(uniq)] = reader.get(uniq)
        with torch.inference_mode():
            return model(
                {KEY: torch.from_numpy(
                    inverse.reshape(q_ids.shape).astype(np.int32))},
                host_rows={TABLE: torch.from_numpy(rows)}).numpy()

    def pulls():
        return sum(_snap(r)["edl_tpu_row_service_pull_seconds"]["series"][0][
            "count"] for r in registries
            if "edl_tpu_row_service_pull_seconds" in _snap(r))

    try:
        q_ids = rng.integers(0, 500, (4, 10)).astype(np.int32)
        status, out = _post(server.port, {"features": {KEY: q_ids}})
        assert status == 200 and out["model_version"] == 7
        np.testing.assert_array_equal(out["predictions"], reference(q_ids))
        status, out_json = _post(server.port,
                                 {"features": {KEY: q_ids.tolist()}},
                                 msgpack=False)
        assert status == 200
        np.testing.assert_array_equal(np.asarray(out_json["predictions"],
                                                 np.float32),
                                      out["predictions"])
        # The repeat came from the cache: every unique id a hit, no pull.
        snap = _snap(registry)
        hits = snap["edl_tpu_serving_row_cache_hits_total"]["series"][0][
            "value"]
        assert hits == len(np.unique(q_ids))
        before = pulls()
        _post(server.port, {"features": {KEY: q_ids}})
        assert pulls() == before
        # A push after export moves the next answer (read-your-writes).
        touched = np.unique(q_ids)[:4]
        client.optimizer.apply_gradients(
            reader, touched, np.full((len(touched), DIM), 2.0, np.float32))
        status, after = _post(server.port, {"features": {KEY: q_ids}})
        assert status == 200
        np.testing.assert_array_equal(after["predictions"],
                                      reference(q_ids))
        assert not np.allclose(after["predictions"], out["predictions"])
    finally:
        server.stop()
        for s in services:
            s.stop(0)


def test_row_service_export_checks_its_arguments(tmp_path):
    model = deepfm_host.custom_model(device="cpu")
    batch = {KEY: np.zeros((2, 10), np.int32)}
    with pytest.raises(ValueError, match="mutually exclusive"):
        port_export.export_serving_bundle(
            str(tmp_path / "a"), model, batch_example=batch,
            host_tables={TABLE: EmbeddingTable(TABLE, DIM)},
            host_vocab={TABLE: 10}, host_id_keys={TABLE: KEY})
    with pytest.raises(ValueError, match="requires batch_example"):
        port_export.export_serving_bundle(str(tmp_path / "b"), model,
                                          host_id_keys={TABLE: KEY})
    with pytest.raises(ValueError, match="exactly the model's host tables"):
        port_export.export_serving_bundle(
            str(tmp_path / "c"), model, batch_example=batch,
            host_id_keys={"other": KEY})
    with pytest.raises(ValueError, match="missing entries"):
        port_export.export_serving_bundle(
            str(tmp_path / "d"), model, batch_example=batch,
            host_tables={TABLE: EmbeddingTable(TABLE, DIM)},
            host_vocab={"other": 10})


def test_dense_host_bundle_answers_400_for_an_id_outside_its_tables(
        tmp_path):
    """A dense host bundle's raw ids index its tables: an id outside
    [0, vocab) answers 400 (checked on the host) instead of reaching the
    gather."""
    model = deepfm_host.custom_model(device="cpu")
    table = EmbeddingTable(TABLE, DIM)
    bundle = str(tmp_path / "dense")
    port_export.export_serving_bundle(
        bundle, model, batch_example={KEY: np.zeros((2, 10), np.int32)},
        model_def="deepfm.deepfm_host.custom_model", version=1,
        host_tables={TABLE: table}, host_vocab={TABLE: 50})
    assert table.num_rows == 0
    store = ModelStore(bundle, device="cpu",
                       model_fn=lambda: deepfm_host.custom_model(device="cpu"),
                       metrics_registry=MetricsRegistry())
    store.load_initial()
    server = InferenceServer(store, port=0, batch_deadline_ms=1.0,
                             metrics_registry=MetricsRegistry()).start()
    try:
        ok = np.arange(10, dtype=np.int32)[None] * 4
        assert _post(server.port, {"features": {KEY: ok}})[0] == 200
        bad = ok.copy()
        bad[0, 3] = 50
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(server.port, {"features": {KEY: bad}})
        assert exc.value.code == 400
    finally:
        server.stop()
