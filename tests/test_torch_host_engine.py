"""The port's host tier (``embedding/host_engine.py``) against the JAX
package's, on the CPU.

The same numpy batches (ids from a seeded ``RandomState``) go through
both engines. Dedup is ``np.unique`` on both sides and lazy rows come
from the same (name, id) hash, so inverse maps, uniques and row blocks
are bit-equal. The train step runs at f32 with the JAX weights carried
across through ``bridge.deepfm_state_dict_from_flax``: loss, dense and
row gradients within 1e-5 relative (another summation order in XLA's
and PyTorch's CPU kernels). Six synchronous runner steps (SGD rows, SGD
MLP, so no gradient near 0 is divided by its own size) keep the tables
within 1e-5 relative L2.
"""

import flax.linen as jnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from elasticdl_tpu.core.train_state import init_train_state as jax_state
from elasticdl_tpu.embedding import host_engine as jhe
from elasticdl_tpu.embedding.combiner import RaggedIds as JaxRagged
from elasticdl_tpu.embedding.optimizer import SGD as JaxSGD
from elasticdl_tpu.embedding.optimizer import HostOptimizerWrapper as JaxWrap
from elasticdl_tpu.embedding.table import EmbeddingTable as JaxTable
from elasticdl_tpu.ops import masked_sigmoid_cross_entropy as jax_loss
from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.core.train_state import init_train_state
from elasticdl_tpu_torch.embedding import host_engine as the
from elasticdl_tpu_torch.embedding.combiner import RaggedIds
from elasticdl_tpu_torch.embedding.optimizer import SGD, HostOptimizerWrapper
from elasticdl_tpu_torch.embedding.table import EmbeddingTable
from elasticdl_tpu_torch.model_zoo.deepfm.fm_layers import DeepTower
from elasticdl_tpu_torch.ops.losses import masked_sigmoid_cross_entropy

VOCAB = 1000
DIM = 8
FIELDS = 4
TABLES = {"items": ("item_ids", FIELDS), "users": ("user_ids", 2),
          "ctx": ("ctx_ids", 3)}
REL = 1e-5


def make_batch(seed, batch=16, tables=("items",), ragged=False, lo=0,
               span=VOCAB):
    rng = np.random.RandomState(seed)
    features = {}
    for name in tables:
        key, width = TABLES[name]
        ids = lo + rng.randint(0, span, (batch, width)).astype(np.int64)
        if ragged:
            lens = rng.randint(0, width + 1, batch)
            features[key] = RaggedIds.from_lists(
                [row[:n] for row, n in zip(ids, lens)], max_ids=width)
        else:
            features[key] = ids
    first = np.asarray(features[TABLES[tables[0]][0]].ids if ragged
                       else features[TABLES[tables[0]][0]])
    return {"features": features,
            "labels": (first[:, 0] % 2).astype(np.int32),
            "mask": np.ones((batch,), np.float32)}


def jax_batch(batch):
    """The same batch with the JAX package's RaggedIds."""
    features = {k: (JaxRagged(ids=v.ids, weights=v.weights)
                    if isinstance(v, RaggedIds) else v)
                for k, v in batch["features"].items()}
    return dict(batch, features=features)


def engines(tables=("items",), native=False, lr=0.5):
    if native:
        from elasticdl_tpu.native.row_store import NativeEmbeddingTable as JN
        from elasticdl_tpu.native.row_store import NativeOptimizerWrapper as JW
        from elasticdl_tpu_torch.native.row_store import (
            NativeEmbeddingTable as TN,
            NativeOptimizerWrapper as TW,
        )
    else:
        JN, JW, TN, TW = JaxTable, JaxWrap, EmbeddingTable, \
            HostOptimizerWrapper
    keys = {name: TABLES[name][0] for name in tables}
    jax_engine = jhe.HostEmbeddingEngine(
        {n: JN(n, DIM) for n in tables}, JW(JaxSGD(lr=lr)), id_keys=keys)
    port_engine = the.HostEmbeddingEngine(
        {n: TN(n, DIM) for n in tables}, TW(SGD(lr=lr)), id_keys=keys)
    return jax_engine, port_engine


class JaxTiny(jnn.Module):
    ragged: bool = False

    @jnn.compact
    def __call__(self, features, training=False):
        if self.ragged:
            emb = jhe.HostEmbedding("items", DIM, combiner="mean")(
                features["item_ids"])
            return jnn.Dense(1)(emb)[..., 0]
        emb = jhe.HostEmbedding("items", DIM)(features["item_ids"])
        x = jnn.relu(jnn.Dense(16)(emb.reshape((emb.shape[0], -1))))
        return jnn.Dense(1)(x)[..., 0]


class PortTiny(nn.Module):
    def __init__(self, ragged=False):
        super().__init__()
        self.ragged = ragged
        self.emb = the.HostEmbedding("items", DIM,
                                     combiner="mean" if ragged else None)
        self.deep = DeepTower(DIM if ragged else FIELDS * DIM,
                              () if ragged else (16,), torch.float32)

    def forward(self, features, host_rows=None):
        emb = self.emb(features["item_ids"], host_rows)
        return self.deep(emb.reshape(emb.shape[0], -1))[..., 0]


def grad_recorder():
    """An optax transformation that applies nothing and keeps the
    gradient in its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (
            jax.tree.map(jnp.zeros_like, updates), updates))


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def test_bucket_size():
    assert the.MIN_BUCKET == jhe.MIN_BUCKET
    for n in (0, 1, 7, 8, 9, 100, 1000, 4097):
        assert the.bucket_size(n) == jhe.bucket_size(n)
    assert the.bucket_size(9) == 16 and the.bucket_size(100) == 128


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
@pytest.mark.parametrize("tables", [("items",), ("items", "users", "ctx")],
                         ids=["one", "three"])
def test_prepare_batch_matches_jax(tables, ragged, native):
    jax_engine, port_engine = engines(tables, native=native)
    for seed in range(3):
        batch = make_batch(seed, tables=tables, ragged=ragged, span=200)
        jb, jrows, juniq = jax_engine.prepare_batch(jax_batch(batch))
        tb, trows, tuniq = port_engine.prepare_batch(batch)
        assert sorted(trows) == sorted(jrows) == sorted(tables)
        for name in tables:
            key = TABLES[name][0]
            jf, tf = jb["features"][key], tb["features"][key]
            if ragged:
                assert isinstance(tf, RaggedIds)
                np.testing.assert_array_equal(tf.weights, jf.weights)
                jf, tf = jf.ids, tf.ids
            assert tf.dtype == np.int32
            np.testing.assert_array_equal(tf, jf)
            assert trows[name].dtype == np.float32
            np.testing.assert_array_equal(trows[name], jrows[name])
            np.testing.assert_array_equal(tuniq[name][0], juniq[name][0])
            assert tuniq[name][1] == juniq[name][1]
            u = tuniq[name][1]
            assert trows[name].shape == (the.bucket_size(u), DIM)
            assert not trows[name][u:].any()


@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
def test_host_train_step_matches_jax(ragged):
    """One step at f32: loss, dense gradients and row gradients."""
    jax_engine, port_engine = engines()
    batch = make_batch(7, ragged=ragged, span=60)
    jb, jrows, _ = jax_engine.prepare_batch(jax_batch(batch))
    tb, trows, tuniq = port_engine.prepare_batch(batch)
    jmodel = JaxTiny(ragged=ragged)
    jstate = jax_state(jmodel, grad_recorder(), jb, seed=0)
    jstep = jhe.build_host_train_step(
        jax_loss, jhe.host_rows_template(jmodel, jb))
    params = jax.tree.map(np.asarray, jstate.params)
    jstate, jrow_grads, jmetrics = jstep(jstate, jb, jrows)
    jgrads = bridge.deepfm_state_dict_from_flax(
        jax.tree.map(np.asarray, jstate.opt_state))

    model = PortTiny(ragged=ragged)
    model.load_state_dict(bridge.deepfm_state_dict_from_flax(params))
    state = init_train_state(
        model, lambda p: torch.optim.SGD(p, lr=0.0), seed=0)
    step = the.build_host_train_step(masked_sigmoid_cross_entropy,
                                     the.host_rows_template(model))
    state, row_grads, metrics = step(state, tb, trows)
    assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= (
        REL * abs(float(jmetrics["loss"])))
    for name, p in model.named_parameters():
        assert rel(p.grad.numpy(), jgrads[name].numpy()) <= REL, name
    got = row_grads["items"].numpy()
    want = np.asarray(jrow_grads["items"])
    assert got.shape == want.shape
    assert rel(got, want) <= REL
    u = tuniq["items"][1]
    assert not got[u:].any()


def _jax_runner_run(batches, tables=("items",), async_apply=False):
    jax_engine, _ = engines(tables)
    runner = jhe.HostStepRunner(jax_engine, async_apply=async_apply)
    model = JaxTiny()
    state = runner.init_state(model, optax.sgd(0.1), jax_batch(batches[0]))
    params = jax.tree.map(np.asarray, state.params)
    step = runner.train_step(jax_loss)
    losses = []
    for b in batches:
        state, metrics = step(state, jax_batch(b))
        losses.append(float(metrics["loss"]))
    runner.flush()
    return params, losses, runner


def _port_runner(async_apply=False, optimizer=None, engine=None):
    if engine is None:
        _, engine = engines()
    if optimizer is not None:
        engine.optimizer = optimizer
    return the.HostStepRunner(engine, async_apply=async_apply)


def _port_run(batches, params=None, async_apply=False, prepared=False,
              runner=None):
    runner = runner or _port_runner(async_apply)
    model = PortTiny()
    state = runner.init_state(
        model, lambda p: torch.optim.SGD(p, lr=0.1), batches[0], seed=0)
    if params is not None:
        model.load_state_dict(bridge.deepfm_state_dict_from_flax(params))
    step = runner.train_step(masked_sigmoid_cross_entropy)
    losses = []
    if prepared:
        with runner.iter_prepared(iter(batches), depth=2) as it:
            for pb in it:
                assert pb.device_rows is not None
                state, metrics = step(state, pb)
                losses.append(float(metrics["loss"]))
    else:
        for b in batches:
            state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))
    runner.flush()
    return losses, runner


def test_six_sync_runner_steps_match_jax():
    batches = [make_batch(s, span=120) for s in range(6)]
    params, jlosses, jrunner = _jax_runner_run(batches)
    tlosses, trunner = _port_run(batches, params=params)
    np.testing.assert_allclose(tlosses, jlosses, rtol=REL)
    jids, jrows = jrunner.engine.tables["items"].to_arrays()
    tids, trows = trunner.engine.tables["items"].to_arrays()
    np.testing.assert_array_equal(tids, jids)
    assert rel(trows, jrows) <= REL


def _disjoint_batches():
    """Six batches on disjoint id ranges: an async pull never races an
    apply of a shared id."""
    return [make_batch(s, lo=100 * s, span=100) for s in range(6)]


@pytest.mark.parametrize("prepared", [False, True],
                         ids=["inline", "pull_ahead"])
def test_async_apply_bit_equal_to_sync_on_disjoint_ids(prepared):
    batches = _disjoint_batches()
    torch.manual_seed(0)
    sync_losses, sync = _port_run(batches)
    torch.manual_seed(0)
    async_losses, runner = _port_run(batches, async_apply=True,
                                     prepared=prepared)
    assert runner.pull_ahead and not sync.pull_ahead
    assert async_losses == sync_losses
    a_ids, a_rows = runner.engine.tables["items"].to_arrays()
    s_ids, s_rows = sync.engine.tables["items"].to_arrays()
    np.testing.assert_array_equal(a_ids, s_ids)
    np.testing.assert_array_equal(a_rows, s_rows)


def test_applier_errors_surface_on_flush():
    class Boom(HostOptimizerWrapper):
        def apply_gradients(self, table, ids, grads):
            raise RuntimeError("row store down")

    runner = _port_runner(async_apply=True, optimizer=Boom(SGD(lr=0.5)))
    batch = make_batch(0)
    state = runner.init_state(PortTiny(),
                              lambda p: torch.optim.SGD(p, lr=0.1), batch)
    step = runner.train_step(masked_sigmoid_cross_entropy)
    step(state, batch)
    with pytest.raises(RuntimeError, match="row store down"):
        runner.flush()
    runner.flush()   # raised once, then cleared


def test_host_tables_drain_pending_applies():
    """A snapshot through ``host_tables`` right after an async step
    carries that step's rows, slot tables and step counters."""
    batch = make_batch(1)
    torch.manual_seed(0)
    _, sync = _port_run([batch])
    torch.manual_seed(0)
    runner = _port_runner(async_apply=True)
    state = runner.init_state(PortTiny(),
                              lambda p: torch.optim.SGD(p, lr=0.1), batch)
    runner.train_step(masked_sigmoid_cross_entropy)(state, batch)
    views = runner.host_tables   # no flush before the read
    ids, rows = views["items"].to_arrays()
    want_ids, want_rows = sync.engine.tables["items"].to_arrays()
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(rows, want_rows)
    steps_ids, steps = views["__row_optimizer_steps__"].to_arrays()
    assert steps.ravel().tolist() == [1.0]
    # Dirty tracking passes through the view under the engine's lock.
    view = views["items"]
    assert not view.supports_dirty_rows
    runner.engine.tables["items"].enable_dirty_tracking()
    runner.train_step(masked_sigmoid_cross_entropy)(state, make_batch(2))
    assert view.supports_dirty_rows and view.dirty_count > 0
    full_ids, _ = view.capture_arrays()   # a full base clears the dirt
    assert view.dirty_count == 0 and full_ids.size == view.num_rows


@pytest.mark.parametrize("place_rows", [False, True],
                         ids=["pull", "pull_and_place"])
def test_closing_prepared_batches_stops_its_producer(place_rows):
    _, engine = engines()
    pulled = []

    def batches():
        for s in range(100):
            pulled.append(s)
            yield make_batch(s)

    it = engine.prepared_batches(batches(), depth=2, place_rows=place_rows,
                                 device="cpu" if place_rows else None)
    first = next(iter(it))
    if place_rows:
        assert isinstance(first.device_rows["items"], torch.Tensor)
        assert torch.equal(first.device_rows["items"],
                           torch.from_numpy(first.host_rows["items"]))
    it.close()
    threads = [it._thread] + ([it._upstream._thread] if place_rows else [])
    assert not any(t.is_alive() for t in threads)
    assert len(pulled) < 100


def test_engine_rejects_bad_keys():
    with pytest.raises(ValueError, match="unique across tables"):
        the.HostEmbeddingEngine(
            {"a": EmbeddingTable("a", DIM), "b": EmbeddingTable("b", DIM)},
            HostOptimizerWrapper(SGD(lr=0.1)), id_keys={"a": "x", "b": "x"})
    with pytest.raises(ValueError, match="unknown tables"):
        the.HostEmbeddingEngine({"a": EmbeddingTable("a", DIM)},
                                HostOptimizerWrapper(SGD(lr=0.1)),
                                id_keys={"typo": "x"})


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_bridge_copies_host_tables(native):
    """A JAX host table trained for two steps, carried into a fresh port
    table through ``bridge.copy_host_table``: the same ids and rows, and
    lazy rows elsewhere as before."""
    jax_engine, port_engine = engines(native=native)
    runner = jhe.HostStepRunner(jax_engine, async_apply=False)
    batches = [jax_batch(make_batch(s, span=300)) for s in range(2)]
    state = runner.init_state(JaxTiny(), optax.sgd(0.1), batches[0])
    step = runner.train_step(jax_loss)
    for b in batches:
        state, _ = step(state, b)
    src = jax_engine.tables["items"]
    dst = bridge.copy_host_table(src, port_engine.tables["items"])
    want_ids, want_rows = src.to_arrays()
    got_ids, got_rows = dst.to_arrays()
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_rows, want_rows)
    np.testing.assert_array_equal(dst.get([VOCAB + 5]), src.get([VOCAB + 5]))


def test_concurrent_safe_stores_fan_out_per_table():
    """Over stores that declare ``concurrent_safe``, a three-table batch
    pulls and applies its tables on the pool at once (each table's get
    and apply wait at a barrier of three) and gives the serial loop's
    result."""
    import threading

    barrier = threading.Barrier(3, timeout=30)

    class SafeTable(EmbeddingTable):
        concurrent_safe = True

        def get(self, ids):
            barrier.wait()
            return super().get(ids)

    class SafeWrapper(HostOptimizerWrapper):
        concurrent_safe = True

        def apply_gradients(self, table, ids, grads):
            barrier.wait()
            return super().apply_gradients(table, ids, grads)

    tables = ("items", "users", "ctx")
    keys = {name: TABLES[name][0] for name in tables}
    safe = the.HostEmbeddingEngine({n: SafeTable(n, DIM) for n in tables},
                                   SafeWrapper(SGD(lr=0.5)), id_keys=keys)
    _, serial = engines(tables)
    assert safe.concurrent_io and not serial.concurrent_io
    batch = make_batch(4, tables=tables, span=50)
    got, want = safe.prepare_batch(batch), serial.prepare_batch(batch)
    for name in tables:
        np.testing.assert_array_equal(got[1][name], want[1][name])
    grads = {n: np.full((got[1][n].shape[0], DIM), 0.1, np.float32)
             for n in tables}
    safe.apply_row_grads(grads, got[2])
    serial.apply_row_grads(grads, want[2])
    for name in tables:
        for a, b in zip(safe.tables[name].to_arrays(),
                        serial.tables[name].to_arrays()):
            np.testing.assert_array_equal(a, b)
    safe.close()
    assert safe._table_pool is None


@pytest.mark.parametrize("tables", [("items",), ("items", "users", "ctx")])
def test_telemetry_families_as_jax(tables):
    """The engine's telemetry as the JAX engine's: the same families
    (names, kinds, labels) in its registry, the same id, unique-id and
    updated-row counts and rows-materialized gauge, one lookup and one
    update observation a batch, one dedup, pull and pad observation a
    table and batch."""
    from elasticdl_tpu.observability.registry import MetricsRegistry as JR
    from elasticdl_tpu_torch.observability.registry import MetricsRegistry

    keys = {name: TABLES[name][0] for name in tables}
    regs = {"jax": JR(), "port": MetricsRegistry()}
    made = {
        "jax": jhe.HostEmbeddingEngine(
            {n: JaxTable(n, DIM) for n in tables},
            JaxWrap(JaxSGD(lr=0.5)), id_keys=keys,
            metrics_registry=regs["jax"]),
        "port": the.HostEmbeddingEngine(
            {n: EmbeddingTable(n, DIM) for n in tables},
            HostOptimizerWrapper(SGD(lr=0.5)), id_keys=keys,
            metrics_registry=regs["port"]),
    }
    readings = {}
    for name, engine in made.items():
        for seed in range(3):
            batch = make_batch(seed, tables=tables, span=40)
            if name == "jax":
                batch = jax_batch(batch)
            _, rows, uniques = engine.prepare_batch(batch)
            engine.apply_row_grads(
                {t: np.ones_like(r) for t, r in rows.items()}, uniques)
        families = {}
        for fam in regs[name].snapshot()["families"]:
            values = [s.get("count", s.get("value"))
                      for s in fam["series"]]
            families[fam["name"]] = (fam["kind"], fam["labelnames"],
                                     values)
        readings[name] = families
    assert readings["port"] == readings["jax"]
    fams = readings["port"]
    assert fams["edl_tpu_embedding_lookup_seconds"][2] == [3]
    assert fams["edl_tpu_embedding_row_pull_seconds"][2] == [3 * len(tables)]
    assert fams["edl_tpu_embedding_rows_materialized"][2][0] > 0
