"""The port's device-tier sparse plane (embedding/device_sparse.py,
embedding/layer.py, the recsys zoo twin) against the JAX package's, on
the same numpy-seeded batches, mirroring tests/test_device_sparse.py.

Both sides start from the same numbers: the JAX runner's initial dense
params, tables and accumulators are carried into the port's state with
``bridge.sparse_state_from_flax`` (the JAX tables come from
``jax.random`` and cannot be redrawn in torch). The JAX side runs
``use_pallas="never"`` and, for "always", its Pallas kernels in
interpret mode; the port's CPU side runs the same modes through the
kernels' plain versions.

The dense params train with SGD 0.1 here, as in the JAX tests (Adam's
early steps are lr * sign(g): an output-bias gradient near 0 whose last
bits differ flips a whole step), except in the Local-executor test of
the zoo contract, which runs the zoo's own Adam for a few steps.

Tolerances: f32 compute at rtol 1e-5 (losses, tables, accumulators,
dense params after 4 steps: the same math, with sums over a batch and
over duplicate ids in another order); bf16 compute at 2e-2 relative L2
(the model's products round to bf16 in both, in another order).
"""

import os
import textwrap

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.embedding import combiner as jcomb
from elasticdl_tpu.embedding import device_sparse as jds
from elasticdl_tpu.embedding import optimizer as jopt
from elasticdl_tpu.embedding.layer import Embedding as JaxEmbedding
from elasticdl_tpu.ops import masked_sigmoid_cross_entropy as jax_loss
from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.embedding import combiner as tcomb
from elasticdl_tpu_torch.embedding import device_sparse as tds
from elasticdl_tpu_torch.embedding import optimizer as topt
from elasticdl_tpu_torch.embedding.layer import Embedding
from elasticdl_tpu_torch.model_zoo.recsys import recsys_sparse as twin
from elasticdl_tpu_torch.ops.losses import masked_sigmoid_cross_entropy
from model_zoo.recsys import recsys_sparse as jax_zoo

VOCAB, DIM, FIELDS, BATCH = 512, 128, 6, 16
HIDDEN = (32, 16)


def _models(compute="f32"):
    jdt, tdt = ((jnp.float32, torch.float32) if compute == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jm = jax_zoo.RecsysRanker(hidden=HIDDEN, compute_dtype=jdt,
                              table_name="items", emb_dim=DIM)
    tm = twin.RecsysRanker(hidden=HIDDEN, compute_dtype=tdt,
                           table_name="items", emb_dim=DIM)
    return jm, tm


def make_batch(rng, batch=BATCH, combiner="sum", ragged_cls=None):
    """Slot 0 is one of two marker ids and the label says which (learnable
    from the summed embedding). With ``ragged_cls`` the ids come as a
    RaggedIds batch with weights, zero-weight slots and an empty row."""
    ids = rng.randint(0, VOCAB, (batch, FIELDS)).astype(np.int64)
    marker = rng.randint(0, 2, batch)
    ids[:, 0] = np.where(marker == 1, 3, VOCAB - 5)
    features = {"ids": ids}
    if ragged_cls is not None:
        weights = rng.rand(batch, FIELDS).astype(np.float32)
        weights[1] = 0.0
        weights[2, 3:] = 0.0
        features = {"ids": ragged_cls(ids=ids.astype(np.int32),
                                      weights=weights)}
    return {"features": features, "labels": marker.astype(np.int32),
            "mask": np.ones((batch,), np.float32)}


def _batches(n, combiner="sum", seed=0, dup=False):
    pairs = []
    for s in range(n):
        rng = np.random.RandomState(seed + s)
        if combiner == "sum":
            b = make_batch(rng)
            if dup:
                b["features"]["ids"][:, 1:] = 7      # id 7 in every slot
            pairs.append((b, b))
        else:
            jb = make_batch(rng, ragged_cls=jcomb.RaggedIds)
            tb = make_batch(np.random.RandomState(seed + s),
                            ragged_cls=tcomb.RaggedIds)
            pairs.append((jb, tb))
    return pairs


def _specs(combiner):
    return ((jds.TableSpec("items", vocab=VOCAB, dim=DIM, combiner=combiner,
                           feature_key="ids"),),
            (tds.TableSpec("items", vocab=VOCAB, dim=DIM, combiner=combiner,
                           feature_key="ids"),))


def _carry(jstate):
    return bridge.sparse_state_from_flax(
        jax.tree.map(np.asarray, jstate.params),
        {k: np.asarray(v) for k, v in jstate.tables.items()},
        {k: {s: np.asarray(a) for s, a in v.items()}
         for k, v in jstate.slot_tables.items()},
        {k: np.asarray(v) for k, v in jstate.table_steps.items()})


def _both(mode="never", combiner="sum", compute="f32", steps=4, dup=False,
          opt="Adagrad"):
    """Train both runners ``steps`` steps from the same state; returns
    (jax state, jax losses, port state, port losses, initial carry)."""
    jspecs, tspecs = _specs(combiner)
    jm, tm = _models(compute)
    pairs = _batches(steps, combiner, dup=dup)
    jrunner = jds.DeviceSparseRunner(
        jspecs, jopt.make_row_optimizer(opt, lr=0.05), use_pallas=mode)
    trunner = tds.DeviceSparseRunner(
        tspecs, topt.make_row_optimizer(opt, lr=0.05), use_pallas=mode)
    jstate = jrunner.init_state(jm, optax.sgd(0.1), pairs[0][0], seed=0)
    start = _carry(jstate)
    tstate = trunner.init_state(tm, _sgd, pairs[0][1], seed=0)
    bridge.load_sparse_state(tstate, start)
    jstep = jrunner.train_step(jax_loss)
    tstep = trunner.train_step(masked_sigmoid_cross_entropy)
    jl, tl = [], []
    for jb, tb in pairs:
        jstate, jmet = jstep(jstate, jb)
        tstate, tmet = tstep(tstate, tb)
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
    return jstate, jl, tstate, tl, start, (jrunner, trunner, pairs)


def _sgd(params):
    return torch.optim.SGD(params, lr=0.1)


def _dense_pairs(jstate, tstate):
    params = jax.tree.map(np.asarray, jstate.params)
    for k in range(len(HIDDEN) + 1):
        yield (tstate.model.layers[k].weight.detach().numpy(),
               params[f"Dense_{k}"]["kernel"].T)
        yield (tstate.model.layers[k].bias.detach().numpy(),
               params[f"Dense_{k}"]["bias"])


@pytest.mark.parametrize("mode", ["never", "always"])
def test_runner_matches_jax_f32(mode):
    jstate, jl, tstate, tl, _, _ = _both(mode)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tstate.tables["items"].numpy(),
                               np.asarray(jstate.tables["items"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tstate.slot_tables["items"]["accumulator"].numpy(),
        np.asarray(jstate.slot_tables["items"]["accumulator"]),
        rtol=1e-5, atol=1e-6)
    assert tstate.table_steps == {"items": 4}
    assert int(jstate.table_steps["items"]) == 4
    for got, want in _dense_pairs(jstate, tstate):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_runner_matches_jax_bf16():
    jstate, jl, tstate, tl, start, _ = _both("never", compute="bf16")
    assert max(abs(a - b) / abs(b) for a, b in zip(tl, jl)) <= 2e-2
    t0 = start["tables"]["items"].numpy()
    assert _rel(tstate.tables["items"].numpy() - t0,
                np.asarray(jstate.tables["items"]) - t0) <= 2e-2
    for (got, want), (_, w0) in zip(_dense_pairs(jstate, tstate),
                                    _initial_dense(start)):
        assert _rel(got - w0, want - w0) <= 2e-2


def _initial_dense(start):
    for k in range(len(HIDDEN) + 1):
        for name in ("weight", "bias"):
            w = start["model"][f"layers.{k}.{name}"].numpy()
            yield w, w


@pytest.mark.parametrize("combiner,mode", [("mean", "never"),
                                           ("sqrtn", "never"),
                                           ("mean", "always")])
def test_ragged_mean_and_sqrtn_match_jax(combiner, mode):
    jstate, jl, tstate, tl, _, _ = _both(mode, combiner=combiner, steps=3)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tstate.tables["items"].numpy(),
                               np.asarray(jstate.tables["items"]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("opt", ["SGD", "Adam"])
def test_duplicate_ids_and_other_row_optimizers_match_jax(opt):
    jstate, jl, tstate, tl, start, _ = _both("never", steps=2, dup=True,
                                             opt=opt)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    got = tstate.tables["items"].numpy()
    np.testing.assert_allclose(got, np.asarray(jstate.tables["items"]),
                               rtol=1e-5, atol=1e-6)
    # Id 7's row took the summed gradient of all its occurrences.
    assert not np.allclose(got[7], start["tables"]["items"].numpy()[7])


def test_untouched_rows_and_slots_stay_put():
    _, _, tstate, _, start, (_, _, pairs) = _both("never", steps=2)
    touched = np.unique(np.concatenate(
        [tb["features"]["ids"].ravel() for _, tb in pairs]))
    mask = np.ones(VOCAB, bool)
    mask[touched] = False
    table0 = start["tables"]["items"].numpy()
    np.testing.assert_array_equal(tstate.tables["items"].numpy()[mask],
                                  table0[mask])
    np.testing.assert_array_equal(
        tstate.slot_tables["items"]["accumulator"].numpy()[mask],
        start["slot_tables"]["items"]["accumulator"].numpy()[mask])
    assert not np.allclose(tstate.tables["items"].numpy()[touched],
                           table0[touched])


def test_multi_step_matches_per_step():
    from elasticdl_tpu_torch.core.step import stack_batches

    _, _, tspecs = (None, None, _specs("sum")[1])
    states, losses = [], []
    batches = [tb for _, tb in _batches(3)]
    for multi in (False, True):
        runner = tds.DeviceSparseRunner(tspecs, topt.Adagrad(lr=0.05))
        torch.manual_seed(0)
        state = runner.init_state(_models()[1], twin.optimizer(),
                                  batches[0], seed=0)
        if multi:
            state, metrics = runner.train_multi_step(
                masked_sigmoid_cross_entropy)(state, stack_batches(batches))
            losses.append(metrics["loss"].numpy())
        else:
            step = runner.train_step(masked_sigmoid_cross_entropy)
            out = [float(step(state, b)[1]["loss"]) for b in batches]
            losses.append(np.asarray(out, np.float32))
        states.append(state)
    np.testing.assert_array_equal(losses[0], losses[1])
    assert torch.equal(states[0].tables["items"], states[1].tables["items"])


def test_eval_step_matches_jax():
    jstate, _, tstate, _, _, (jrunner, trunner, pairs) = _both(
        "never", steps=2)
    jb, tb = pairs[0]
    want = np.asarray(jrunner.eval_step()(jstate, jb))
    got = trunner.eval_step()(tstate, tb)
    assert got.shape == (BATCH,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_packed_slots_match_jax():
    jspecs, tspecs = _specs("sum")
    jm, tm = _models()
    pairs = _batches(2)
    jrunner = jds.DeviceSparseRunner(jspecs, jopt.Adagrad(lr=0.05),
                                     packed_slots=True)
    trunner = tds.DeviceSparseRunner(tspecs, topt.Adagrad(lr=0.05),
                                     packed_slots=True)
    jstate = jrunner.init_state(jm, optax.sgd(0.1), pairs[0][0])
    tstate = trunner.init_state(tm, _sgd, pairs[0][1])
    assert tstate.tables["items"].shape == (VOCAB, 2 * DIM)
    carried = bridge.sparse_state_from_flax(
        jax.tree.map(np.asarray, jstate.params),
        {"items": np.asarray(jstate.tables["items"])}, {}, {"items": 0})
    bridge.load_sparse_state(tstate, carried)
    for jb, tb in pairs:
        jstate, _ = jrunner.train_step(jax_loss)(jstate, jb)
        tstate, _ = trunner.train_step(masked_sigmoid_cross_entropy)(
            tstate, tb)
    np.testing.assert_allclose(tstate.tables["items"].numpy(),
                               np.asarray(jstate.tables["items"]),
                               rtol=1e-5, atol=1e-6)


def test_runner_contract():
    _, tspecs = _specs("sum")
    # With a mesh (tests/test_torch_sparse_sharded.py): packed slots
    # stay single-mesh, and sharded tables need a mesh, as JAX words it.
    from elasticdl_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((2,), ("dp",), [torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="packed_slots is single-mesh"):
        tds.DeviceSparseRunner(tspecs, topt.SGD(), mesh=mesh,
                               packed_slots=True)
    runner = tds.DeviceSparseRunner(tspecs, topt.SGD())
    # No mesh: place_state makes every table whole on the state's device
    # (what a failed resize from no mesh puts back), and a resize before
    # init retargets.
    from types import SimpleNamespace

    from elasticdl_tpu_torch.parallel.mesh import NamedSharding, ShardedTensor
    from elasticdl_tpu_torch.parallel.rules import PartitionSpec

    table = torch.arange(8.0).reshape(4, 2)
    state = SimpleNamespace(
        model=torch.nn.Linear(1, 1), device=torch.device("cpu"),
        tables={"items": ShardedTensor.from_whole(
            NamedSharding(mesh, PartitionSpec("dp", None)), table)},
        slot_tables={"items": {}})
    assert runner.place_state(state) is state
    assert torch.equal(state.tables["items"], table)
    assert runner.resize(mesh) is None and runner.mesh is mesh
    runner = tds.DeviceSparseRunner(tspecs, topt.SGD())
    with pytest.raises(ValueError, match="requires a mesh"):
        tds.build_sparse_train_step(masked_sigmoid_cross_entropy, tspecs,
                                    topt.SGD(), {"items": DIM},
                                    sharded_tables=frozenset({"items"}))
    with pytest.raises(ValueError, match="packed_slots"):
        tds.DeviceSparseRunner(tspecs, topt.SGD(), use_pallas="fused",
                               packed_slots=True)
    with pytest.raises(RuntimeError, match="init_state"):
        runner.train_step(masked_sigmoid_cross_entropy)
    batch = _batches(1)[0][1]
    with pytest.raises(ValueError, match="SparseEmbed"):
        runner.init_state(torch.nn.Linear(2, 2), twin.optimizer(), batch)
    with pytest.raises(ValueError, match="combiner"):
        tds.TableSpec("t", 4, 4, combiner="max")


class _JaxLayerModel(nn.Module):
    combiner: str
    pallas: bool

    @nn.compact
    def __call__(self, ragged):
        return JaxEmbedding(64, 128, combiner=self.combiner,
                            pallas=self.pallas)(ragged)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("pallas", [True, False])
def test_embedding_layer_matches_jax(combiner, pallas):
    rng = np.random.RandomState(9)
    ids = rng.randint(0, 64, (5, 4)).astype(np.int32)
    weights = rng.rand(5, 4).astype(np.float32)
    weights[1] = 0.0
    cot = rng.randn(5, 128).astype(np.float32)
    jmodel = _JaxLayerModel(combiner, pallas)
    jr = jcomb.RaggedIds(ids=jnp.asarray(ids), weights=jnp.asarray(weights))
    params = jmodel.init(jax.random.PRNGKey(0), jr)
    table = np.array(params["params"]["Embedding_0"]["embedding"])
    out, vjp = jax.vjp(lambda p: jmodel.apply(p, jr), params)
    (grads,) = vjp(jnp.asarray(cot))
    layer = Embedding(64, 128, combiner=combiner, pallas=pallas)
    with torch.no_grad():
        layer.embedding.copy_(torch.from_numpy(table))
    got = layer(tcomb.RaggedIds(ids=ids, weights=weights))
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        layer.embedding.grad.numpy(),
        np.asarray(grads["params"]["Embedding_0"]["embedding"]),
        rtol=1e-5, atol=1e-6)


def test_embedding_layer_dense_ids_and_init():
    layer = Embedding(10, 4)
    assert float(layer.embedding.detach().abs().max()) <= 0.05
    out = layer(np.array([[1, 2], [3, 9]]))
    assert out.shape == (2, 2, 4)
    assert torch.equal(out[1, 1], layer.embedding[9])
    with pytest.raises(ValueError, match="combiner"):
        layer(tcomb.RaggedIds.from_lists([[1, 2], [3]]))
    ragged = tcomb.RaggedIds.from_lists([[1, 2], [3]], max_ids=3)
    assert ragged.ids.tolist() == [[1, 2, 0], [3, 0, 0]]
    assert ragged.weights.tolist() == [[1, 1, 0], [1, 0, 0]]


def test_recsys_zoo_contract_resolves():
    from elasticdl_tpu_torch.core.model_spec import get_model_spec
    from elasticdl_tpu_torch.testing.data import model_zoo_dir

    spec = get_model_spec(model_zoo_dir(),
                          "recsys.recsys_sparse.custom_model", device="cpu")
    assert spec.make_sparse_runner is not None
    runner = spec.make_sparse_runner(use_pallas="always")
    assert isinstance(runner, tds.DeviceSparseRunner)
    assert runner.use_pallas == "always"
    assert (runner.specs[0].vocab, runner.specs[0].dim) == (1_000_000, 256)
    assert isinstance(runner.row_opt, topt.Adagrad)
    assert runner.row_opt.lr == 0.05


# ---- the recsys twin through the Local executor ----------------------------

TINY_VOCAB, TINY_DIM, TINY_IDS = 1024, 16, 8

PORT_ZOO = '''
import torch

from elasticdl_tpu_torch.model_zoo.recsys import recsys_sparse as twin
from elasticdl_tpu_torch.model_zoo.recsys.recsys_sparse import (
    dataset_fn, eval_metrics_fn, loss, make_sparse_runner, optimizer)


def custom_model(device=None):
    return twin.RecsysRanker(compute_dtype=torch.float32,
                             emb_dim=twin.DIM).to(device)
'''


def test_local_executor_trains_the_recsys_twin_like_jax(tmp_path,
                                                       monkeypatch):
    """The twin and the JAX recsys module at VOCAB 1024 x DIM 16 (module
    globals patched) through each package's LocalExecutor on the same
    frappe records, the port from the JAX executor's initial state, f32:
    the losses of every step and the eval accuracy agree."""
    from elasticdl_tpu.api.local_executor import LocalExecutor as JaxExecutor
    from elasticdl_tpu.testing import data as jdata
    from elasticdl_tpu.testing.tiny_zoo import tiny_recsys_zoo
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.callbacks import Callback
    from elasticdl_tpu_torch.testing import data as tdata

    train = tdata.create_frappe_record_file(
        str(tmp_path / "train.rec"), 96, seed=1, input_length=TINY_IDS,
        max_id=TINY_VOCAB)
    evalf = tdata.create_frappe_record_file(
        str(tmp_path / "eval.rec"), 40, seed=2, input_length=TINY_IDS,
        max_id=TINY_VOCAB)
    jtrain = jdata.create_frappe_record_file(
        str(tmp_path / "jtrain.rec"), 96, seed=1, input_length=TINY_IDS,
        max_id=TINY_VOCAB)
    with open(train, "rb") as a, open(jtrain, "rb") as b:
        assert a.read() == b.read()

    monkeypatch.setattr(twin, "VOCAB", TINY_VOCAB)
    monkeypatch.setattr(twin, "DIM", TINY_DIM)
    monkeypatch.setattr(twin, "TABLE_SPECS", (tds.TableSpec(
        twin.TABLE_NAME, vocab=TINY_VOCAB, dim=TINY_DIM,
        feature_key=twin.FEATURE_KEY),))
    zoo = tmp_path / "zoo" / "tiny"
    zoo.mkdir(parents=True)
    (zoo / "rec.py").write_text(textwrap.dedent(PORT_ZOO))

    jax_losses = []
    with tiny_recsys_zoo(vocab=TINY_VOCAB, dim=TINY_DIM) as jzoo:
        monkeypatch.setattr(jzoo, "custom_model", lambda: jzoo.RecsysRanker(
            compute_dtype=jnp.float32, table_name=jzoo.TABLE_NAME,
            emb_dim=jzoo.DIM))
        jargs = jdata.make_local_args(
            jdata.model_zoo_dir(), "recsys.recsys_sparse.custom_model",
            train, str(tmp_path / "jax"), validation_data=evalf,
            minibatch_size=16, num_epochs=2)
        jex = JaxExecutor(jargs)
        real_step = None

        def record(state, batch):
            state, metrics = real_step(state, batch)
            jax_losses.append(float(metrics["loss"]))
            return state, metrics

        orig_init = jex._maybe_init_state

        def init(batch):
            nonlocal real_step
            if jex.state is None:
                orig_init(batch)
                real_step = jex._train_step
                jex._train_step = record
                init.start = _carry(jex.state)

        jex._maybe_init_state = init
        want = jex.run()

    losses = []

    class Carry(Callback):
        def on_train_batch_begin(self, owner=None):
            if owner.state.step == 0:
                bridge.load_sparse_state(owner.state, init.start)

        def on_train_batch_end(self, owner=None, metrics=None):
            losses.append(float(metrics["loss"]))

    args = tdata.make_local_args(
        str(tmp_path / "zoo"), "tiny.rec.custom_model", train,
        validation_data=evalf, minibatch_size=16, num_epochs=2,
        extra=["--device", "cpu"])
    got = LocalExecutor(args, callbacks=[Carry()]).run()
    assert got["steps"] == want["steps"] == 12
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    assert got["eval_metrics"]["accuracy"] == want["eval_metrics"][
        "accuracy"]


def test_local_executor_refuses_output_for_a_sparse_model(tmp_path):
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.testing import data as tdata

    train = tdata.create_frappe_record_file(str(tmp_path / "t.rec"), 4)
    args = tdata.make_local_args(
        tdata.model_zoo_dir(), "recsys.recsys_sparse.custom_model", train,
        minibatch_size=4, extra=["--device", "cpu", "--output",
                                 os.path.join(str(tmp_path), "out")])
    with pytest.raises(NotImplementedError, match="no serving bundle"):
        LocalExecutor(args)
