"""The row-sharded sparse plane (elasticdl_tpu_torch/embedding/
device_sparse.py with a mesh, ops/pallas_embedding
.lookup_combine_sharded, device_sparse.sparse_apply_sharded) against the
JAX package's on the CPU, mirroring tests/test_device_sparse.py's mesh
cases and tests/test_elastic_mesh_resize.py:184-380.

JAX runs on 4 of the conftest's 8 virtual CPU devices with
``use_pallas="never"``, the port on ``[cpu] * 4``, where the kernel
routes ("always": #6 and #7, "fused": #8) take their plain versions.
States cross with ``bridge.sparse_state_from_flax`` and
``bridge.load_sparse_state``.

Tolerances:

- the lookup: a sharded output element is the same L products
  ``w_l·x_l`` summed in another association (each shard's partial over
  its own ids, zeros for the others', then the n partials), so against
  the unsharded lookup and against JAX's psum it may differ by at most
  the bound of a recursive f32 sum of L + n terms, ``(L + n)·u·Σ|w_l
  x_l|`` with u = 2^-24, one more u of the result for the mean/sqrtn
  division. The test holds every element to that bound.
- the row update: elementwise on the same rows, so the port's sharded
  apply equals its unsharded apply bit for bit, and JAX's within 1e-6
  relative (XLA may contract a multiply-add that torch rounds twice).
- the runners, 4 steps: losses, tables, accumulators and dense
  parameters within rtol 1e-5 of JAX's (tests/test_torch_device_
  sparse.py's f32 tolerance: the dense model's sums over the batch run
  in another order), and the port's dp4 against its unsharded run
  within the same (the lookup's association above feeds the model).
- resizes and checkpoints move rows without arithmetic: the state on
  the new mesh equals the state on the old one bit for bit. A run that
  goes on at dp2 sums each lookup over 2 partials instead of 4, so its
  trajectory is held to the unresized dp4 run at rtol 1e-5, as above
  (the JAX test holds its resized run at 1e-4).
"""

import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.embedding import device_sparse as jds
from elasticdl_tpu.embedding import optimizer as jopt
from elasticdl_tpu.ops import masked_sigmoid_cross_entropy as jax_loss
from elasticdl_tpu.ops import pallas_embedding as jpe
from elasticdl_tpu.parallel import mesh as jmesh
from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.checkpoint import (
    CheckpointHook,
    CheckpointSaver,
    restore_from_dir,
    state_io,
)
from elasticdl_tpu_torch.embedding import device_sparse as tds
from elasticdl_tpu_torch.embedding import optimizer as topt
from elasticdl_tpu_torch.model_zoo.recsys import recsys_sparse as twin
from elasticdl_tpu_torch.ops import pallas_embedding as tpe
from elasticdl_tpu_torch.ops.losses import masked_sigmoid_cross_entropy
from elasticdl_tpu_torch.parallel import mesh as tmesh
from elasticdl_tpu_torch.parallel.mesh import ShardedTensor
from elasticdl_tpu_torch.testing.cluster import MiniCluster
from elasticdl_tpu_torch.testing.in_process_master import InProcessMaster
from elasticdl_tpu_torch.worker.worker import Worker
from model_zoo.recsys import recsys_sparse as jax_zoo

CPU = torch.device("cpu")
VOCAB, DIM, FIELDS, BATCH = 512, 128, 6, 16
HIDDEN = (32, 16)
U = 2.0 ** -24


def _meshes(n):
    return (jmesh.make_mesh((n,), ("dp",), devices=jax.devices()[:n]),
            tmesh.make_mesh((n,), ("dp",), [CPU] * n))


# ---- lookup_combine_sharded ------------------------------------------------


def _lookup_inputs(seed=0, vocab=VOCAB, dim=DIM, batch=12, ids=8):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((vocab, dim)).astype(np.float32)
    idx = rng.integers(0, vocab, (batch, ids)).astype(np.int32)
    w = rng.uniform(0.1, 2.0, (batch, ids)).astype(np.float32)
    w[1] = 0.0                       # an empty row: mean/sqrtn give 0
    w[2, 4:] = 0.0
    idx[3] = vocab - 1               # the last row of the last shard
    idx[4, :2] = vocab // 4 - 1      # a shard's last row
    idx[4, 2:4] = vocab // 4         # the next shard's first
    return table, idx, w


def _bound(table, idx, w, combiner, n):
    mag = np.abs(table[idx] * w[..., None]).sum(axis=1)
    bound = (idx.shape[1] + n) * U * mag
    if combiner != "sum":
        denom = (w.sum(-1, keepdims=True) if combiner == "mean"
                 else np.sqrt((w * w).sum(-1, keepdims=True)))
        bound = bound / np.where(denom > 0, denom, 1.0) * (1 + U) + U * (
            mag / np.where(denom > 0, denom, 1.0))
    return bound + 1e-30


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("force_pallas", [True, False])
def test_lookup_combine_sharded_matches_jax_and_unsharded(combiner,
                                                          force_pallas):
    table, idx, w = _lookup_inputs()
    jm, tm = _meshes(4)
    want = np.asarray(jax.jit(lambda t, i, ww: jpe.lookup_combine_sharded(
        t, i, ww, combiner, jm, "dp", force_xla=True))(table, idx, w))
    sharding = tmesh.NamedSharding(tm, tmesh.PartitionSpec("dp", None))
    shards = sharding.split(torch.from_numpy(table))
    got = tpe.lookup_combine_sharded(
        shards, torch.from_numpy(idx), torch.from_numpy(w), combiner,
        force_pallas=force_pallas, force_xla=not force_pallas).numpy()
    whole = tpe.lookup_combine(
        torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(w),
        combiner, force_xla=True).numpy()
    bound = _bound(table, idx, w, combiner, 4)
    assert np.all(np.abs(got - want) <= bound)
    assert np.all(np.abs(got - whole) <= bound)
    assert np.all(got[1] == 0.0) or combiner == "sum"


def test_lookup_combine_sharded_refuses_bad_inputs():
    table, idx, w = _lookup_inputs()
    _, tm = _meshes(4)
    shards = tmesh.NamedSharding(
        tm, tmesh.PartitionSpec("dp", None)).split(torch.from_numpy(table))
    with pytest.raises(ValueError, match="exclusive"):
        tpe.lookup_combine_sharded(shards, torch.from_numpy(idx),
                                   torch.from_numpy(w), "sum",
                                   force_pallas=True, force_xla=True)
    with pytest.raises(ValueError, match="unequal"):
        tpe.lookup_combine_sharded(shards[:1] + [shards[1][:-1]],
                                   torch.from_numpy(idx),
                                   torch.from_numpy(w), "sum")


def test_lookup_combine_sharded_is_differentiable():
    table, idx, w = _lookup_inputs()
    _, tm = _meshes(4)
    shards = [s.requires_grad_(True) for s in tmesh.NamedSharding(
        tm, tmesh.PartitionSpec("dp", None)).split(torch.from_numpy(table))]
    out = tpe.lookup_combine_sharded(shards, torch.from_numpy(idx),
                                     torch.from_numpy(w), "mean")
    out.sum().backward()
    whole = torch.from_numpy(table).requires_grad_(True)
    tpe.lookup_combine(whole, torch.from_numpy(idx), torch.from_numpy(w),
                       "mean").sum().backward()
    torch.testing.assert_close(torch.cat([s.grad for s in shards]),
                               whole.grad, rtol=1e-6, atol=1e-7)


# ---- sparse_apply_sharded --------------------------------------------------

OPTS = {"SGD": dict(lr=0.1), "Adagrad": dict(lr=0.05),
        "Momentum": dict(lr=0.1, momentum=0.9)}


def _apply_inputs(opt_name, ids, seed=1, vocab=64, dim=16):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((vocab, dim)).astype(np.float32)
    opt = topt.make_row_optimizer(opt_name, **OPTS[opt_name])
    slots = {n: rng.uniform(0.1, 1.0, (vocab, dim)).astype(np.float32)
             for n in opt.slot_names}
    uids = np.full(24, vocab, np.int32)     # padded with the sentinel V
    uids[:len(ids)] = np.sort(ids)
    grads = rng.standard_normal((24, dim)).astype(np.float32)
    grads[len(ids):] = 0.0
    return table, slots, uids, grads


def _port_sharded(opt_name, table, slots, uids, grads, n, mode):
    _, tm = _meshes(n)
    sharding = tmesh.NamedSharding(tm, tmesh.PartitionSpec("dp", None))
    st = ShardedTensor.from_whole(sharding, torch.from_numpy(table))
    ss = {k: ShardedTensor.from_whole(sharding, torch.from_numpy(v))
          for k, v in slots.items()}
    opt = topt.make_row_optimizer(opt_name, **OPTS[opt_name])
    tds.sparse_apply_sharded(opt, st, ss, torch.from_numpy(uids),
                             torch.from_numpy(grads), 1, use_pallas=mode)
    return st, ss


@pytest.mark.parametrize("mode", ["never", "always", "fused"])
@pytest.mark.parametrize("opt_name", sorted(OPTS))
def test_sparse_apply_sharded_matches_jax_and_unsharded(opt_name, mode):
    ids = np.array([0, 5, 15, 16, 17, 31, 40, 47, 48, 63], np.int32)
    table, slots, uids, grads = _apply_inputs(opt_name, ids)
    st, ss = _port_sharded(opt_name, table, slots, uids, grads, 4, mode)
    # Unsharded, the same mode.
    t1 = torch.from_numpy(table.copy())
    s1 = {k: torch.from_numpy(v.copy()) for k, v in slots.items()}
    topt.sparse_apply(topt.make_row_optimizer(opt_name, **OPTS[opt_name]),
                      t1, s1, torch.from_numpy(uids),
                      torch.from_numpy(grads), 1, use_pallas=mode)
    torch.testing.assert_close(st.gather(), t1, rtol=0, atol=0)
    for k in s1:
        torch.testing.assert_close(ss[k].gather(), s1[k], rtol=0, atol=0)
    # JAX's shard_map body, the library route.
    jm, _ = _meshes(4)
    jo = jopt.make_row_optimizer(opt_name, **OPTS[opt_name])
    jt, js = jax.jit(lambda t, s, u, g: jds.sparse_apply_sharded(
        jo, t, s, u, g, jnp.int32(1), jm, "dp", use_pallas="never"))(
            table, slots, uids, grads)
    np.testing.assert_allclose(st.gather().numpy(), np.asarray(jt),
                               rtol=1e-6, atol=1e-7)
    for k in slots:
        np.testing.assert_allclose(ss[k].gather().numpy(),
                                   np.asarray(js[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["never", "always", "fused"])
@pytest.mark.parametrize("opt_name", ["Adagrad", "Momentum"])
def test_pad_edge_cases(opt_name, mode):
    """The library route writes every pad through an anchor row. A shard
    that receives no real id must come out bit-unchanged (its anchor is
    the clamped row, written with its old value), and a shard whose only
    real id is its last row must update just that row."""
    vocab = 64
    shard_rows = vocab // 4
    # Shard 1 gets nothing; shard 2's only id is its last row (47);
    # shards 0 and 3 get ids; the rest are pads (V).
    ids = np.array([3, 9, shard_rows * 3 - 1, 50, 63], np.int32)
    table, slots, uids, grads = _apply_inputs(opt_name, ids)
    st, ss = _port_sharded(opt_name, table, slots, uids, grads, 4, mode)
    got = st.gather().numpy()
    rows1 = slice(shard_rows, 2 * shard_rows)
    np.testing.assert_array_equal(got[rows1], table[rows1])
    for k in slots:
        np.testing.assert_array_equal(ss[k].gather().numpy()[rows1],
                                      slots[k][rows1])
    rows2 = np.arange(2 * shard_rows, 3 * shard_rows)
    untouched = rows2[rows2 != shard_rows * 3 - 1]
    np.testing.assert_array_equal(got[untouched], table[untouched])
    assert not np.array_equal(got[shard_rows * 3 - 1],
                              table[shard_rows * 3 - 1])
    # Every row no id names is bit-unchanged.
    others = np.setdiff1d(np.arange(vocab), ids)
    np.testing.assert_array_equal(got[others], table[others])


# ---- the runner ------------------------------------------------------------


def _batches(n, seed=0):
    out = []
    for s in range(n):
        rng = np.random.RandomState(seed + s)
        ids = rng.randint(0, VOCAB, (BATCH, FIELDS)).astype(np.int64)
        marker = rng.randint(0, 2, BATCH)
        ids[:, 0] = np.where(marker == 1, 3, VOCAB - 5)
        out.append({"features": {"ids": ids},
                    "labels": marker.astype(np.int32),
                    "mask": np.ones((BATCH,), np.float32)})
    return out


def _carry(jstate):
    return bridge.sparse_state_from_flax(
        jax.tree.map(np.asarray, jstate.params),
        {k: np.asarray(v) for k, v in jstate.tables.items()},
        {k: {s: np.asarray(a) for s, a in v.items()}
         for k, v in jstate.slot_tables.items()},
        {k: np.asarray(v) for k, v in jstate.table_steps.items()})


def _sgd(params):
    return torch.optim.SGD(params, lr=0.1)


def _port_runner(n, mode="never", opt="Adagrad"):
    mesh = _meshes(n)[1] if n else None
    return tds.DeviceSparseRunner(
        (tds.TableSpec("items", vocab=VOCAB, dim=DIM, feature_key="ids"),),
        topt.make_row_optimizer(opt, lr=0.05), use_pallas=mode, mesh=mesh,
        partition_threshold_bytes=0)


def _port_model():
    return twin.RecsysRanker(hidden=HIDDEN, compute_dtype=torch.float32,
                             table_name="items", emb_dim=DIM)


def _port_train(runner, start, batches, state=None):
    if state is None:
        state = runner.init_state(_port_model(), _sgd, batches[0], seed=0)
        bridge.load_sparse_state(state, start)
    step = runner.train_step(masked_sigmoid_cross_entropy)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(m["loss"].item())
    return state, losses


@pytest.fixture(scope="module")
def jax_dp4():
    """The JAX DeviceSparseRunner on dp4, 4 steps: (initial carry,
    losses, final carry)."""
    jm, _ = _meshes(4)
    runner = jds.DeviceSparseRunner(
        (jds.TableSpec("items", vocab=VOCAB, dim=DIM, feature_key="ids"),),
        jopt.make_row_optimizer("Adagrad", lr=0.05), use_pallas="never",
        mesh=jm, partition_threshold_bytes=0)
    model = jax_zoo.RecsysRanker(hidden=HIDDEN, compute_dtype=jnp.float32,
                                 table_name="items", emb_dim=DIM)
    batches = _batches(4)
    state = runner.init_state(model, optax.sgd(0.1), batches[0], seed=0)
    assert runner.sharded_tables == frozenset({"items"})
    start = _carry(state)
    step = runner.train_step(jax_loss)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return start, losses, _carry(state)


def _assert_state_close(tstate, carried, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(
        state_io.named_leaves_from_state(tstate)["tables.items"],
        carried["tables"]["items"].numpy(), rtol=rtol, atol=atol)
    np.testing.assert_allclose(
        state_io.named_leaves_from_state(tstate)[
            "slot_tables.items.accumulator"],
        carried["slot_tables"]["items"]["accumulator"].numpy(),
        rtol=rtol, atol=atol)
    got = tstate.model.state_dict()
    for key, value in carried["model"].items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   rtol=rtol, atol=atol, err_msg=key)


@pytest.mark.parametrize("mode", ["never", "always"])
def test_dp4_runner_matches_jax_dp4(jax_dp4, mode):
    start, want_losses, want = jax_dp4
    runner = _port_runner(4, mode)
    state, losses = _port_train(runner, start, _batches(4))
    assert isinstance(state.tables["items"], ShardedTensor)
    assert len(state.tables["items"].shards) == 4
    assert state.tables["items"].shards[0].shape == (VOCAB // 4, DIM)
    assert isinstance(state.slot_tables["items"]["accumulator"],
                      ShardedTensor)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _assert_state_close(state, want)
    assert state.table_steps == {"items": 4}
    # The unsharded port run from the same start.
    single, single_losses = _port_train(_port_runner(0, mode), start,
                                        _batches(4))
    np.testing.assert_allclose(losses, single_losses, rtol=1e-5)
    flat = state_io.named_leaves_from_state(single)
    _assert_state_close(state, {
        "tables": {"items": torch.from_numpy(flat["tables.items"])},
        "slot_tables": {"items": {"accumulator": torch.from_numpy(
            flat["slot_tables.items.accumulator"])}},
        "model": single.model.state_dict()})


def test_dp4_eval_step_matches_unsharded(jax_dp4):
    start = jax_dp4[0]
    batch = _batches(1, seed=9)[0]
    preds = []
    for n in (4, 0):
        runner = _port_runner(n)
        state = runner.init_state(_port_model(), _sgd, batch, seed=0)
        bridge.load_sparse_state(state, start)
        preds.append(runner.eval_step()(state, batch))
    torch.testing.assert_close(preds[0], preds[1], rtol=1e-5, atol=1e-6)


def test_runner_state_shardings_and_refusals():
    runner = _port_runner(4)
    state = runner.init_state(_port_model(), _sgd, _batches(1)[0])
    sh = runner.state_shardings(state)
    assert sh["tables.items"].spec == tmesh.PartitionSpec("dp", None)
    assert sh["slot_tables.items.accumulator"].num_shards == 4
    assert sh["step"].is_replicated
    assert all(v.is_replicated for k, v in sh.items()
               if k.startswith("params."))
    # A vocab the axis does not divide, or a table under the threshold,
    # stays whole.
    small = tds.DeviceSparseRunner(
        (tds.TableSpec("items", vocab=VOCAB, dim=DIM),), topt.SGD(),
        mesh=_meshes(4)[1])
    assert small.sharded_tables == frozenset()
    odd = tds.DeviceSparseRunner(
        (tds.TableSpec("items", vocab=VOCAB, dim=DIM),), topt.SGD(),
        mesh=_meshes(3)[1], partition_threshold_bytes=0)
    assert odd.sharded_tables == frozenset()
    with pytest.raises(ValueError, match="packed_slots"):
        tds.DeviceSparseRunner(
            (tds.TableSpec("items", vocab=VOCAB, dim=DIM),), topt.SGD(),
            mesh=_meshes(4)[1], packed_slots=True)


def test_live_resize_dp4_dp2_dp4_equals_unresized(jax_dp4):
    start = jax_dp4[0]
    batches = _batches(6)
    control, control_losses = _port_train(_port_runner(4), start, batches)
    runner = _port_runner(4)
    state, losses = _port_train(runner, start, batches[:2])
    before = state_io.named_leaves_from_state(state)
    state = runner.resize(_meshes(2)[1], state)
    after = state_io.named_leaves_from_state(state)
    for key in before:
        np.testing.assert_array_equal(after[key], before[key], err_msg=key)
    assert len(state.tables["items"].shards) == 2
    assert len(state.slot_tables["items"]["accumulator"].shards) == 2
    state, more = _port_train(runner, start, batches[2:4], state)
    state = runner.resize(_meshes(4)[1], state)
    state, last = _port_train(runner, start, batches[4:], state)
    np.testing.assert_allclose(losses + more + last, control_losses,
                               rtol=1e-5)
    _assert_leaves_close(state, control)


def test_failed_live_resize_puts_the_tables_back(jax_dp4, monkeypatch):
    """A dp4 -> dp2 resize whose second table leaf cannot be allocated on
    dp2 (out of memory on the device, and again after the host bounce)
    raises with every table and accumulator back on their dp4 shards,
    values kept, and training goes on equal to the unresized run."""
    start = jax_dp4[0]
    batches = _batches(4)
    control, control_losses = _port_train(_port_runner(4), start, batches)
    runner = _port_runner(4)
    state, losses = _port_train(runner, start, batches[:2])
    before = state_io.named_leaves_from_state(state)
    real = ShardedTensor.from_whole.__func__
    placed = []

    def from_whole(cls, sharding, tensor):
        if sharding.num_shards == 2:
            placed.append(len(placed))
            if len(placed) > 1:
                raise torch.OutOfMemoryError("simulated: the card is full")
        return real(cls, sharding, tensor)

    monkeypatch.setattr(ShardedTensor, "from_whole",
                        classmethod(from_whole))
    with pytest.raises(torch.OutOfMemoryError, match="simulated"):
        runner.resize(_meshes(2)[1], state)
    monkeypatch.undo()
    assert len(placed) == 3   # dp2: one leaf, then refused twice
    assert runner.mesh == _meshes(4)[1]
    for leaf in (state.tables["items"],
                 state.slot_tables["items"]["accumulator"]):
        assert isinstance(leaf, ShardedTensor) and len(leaf.shards) == 4
        assert all(s.device == CPU for s in leaf.shards)
    after = state_io.named_leaves_from_state(state)
    for key in before:
        np.testing.assert_array_equal(after[key], before[key], err_msg=key)
    state, more = _port_train(runner, start, batches[2:], state)
    np.testing.assert_allclose(losses + more, control_losses, rtol=1e-5)
    _assert_leaves_close(state, control)


def _assert_leaves_close(state, control):
    a = state_io.named_leaves_from_state(state)
    b = state_io.named_leaves_from_state(control)
    assert a.keys() == b.keys()
    for key in b:
        if key == "rng":
            np.testing.assert_array_equal(a[key], b[key])
            continue
        np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)


def test_checkpoint_resize_trajectory_equals_unresized(tmp_path, jax_dp4):
    """dp4 -> checkpoint -> dp2 -> checkpoint -> dp4, each a new runner
    and state from another seed, restored and placed: the placed state
    holds the saved leaves bit for bit, and the run meets an unresized
    dp4 run within the lookup's tolerance."""
    start = jax_dp4[0]
    batches = _batches(6)
    ckpt = str(tmp_path / "ckpt")
    _, control_losses = _port_train(_port_runner(4), start, batches)
    control, _ = _port_train(_port_runner(4), start, batches)

    runner_a = _port_runner(4)
    state_a, losses = _port_train(runner_a, start, batches[:2])
    assert CheckpointHook(checkpoint_dir=ckpt, checkpoint_steps=1,
                          async_save=False).maybe_save(state_a)
    whole, _ = _port_train(_port_runner(0), start, batches[:2])
    assert CheckpointHook(checkpoint_dir=str(tmp_path / "whole"),
                          checkpoint_steps=1,
                          async_save=False).maybe_save(whole)
    saver = CheckpointSaver(ckpt)
    assert saver.get_valid_latest_version() == 2
    for name in os.listdir(os.path.join(ckpt, "version-2")):
        with open(os.path.join(ckpt, "version-2", name), "rb") as f, \
                open(os.path.join(str(tmp_path / "whole"), "version-2",
                                  name), "rb") as g:
            # The unsharded run's lookups associate otherwise: compare
            # layout, not bytes, there; the dense dp tests hold bytes.
            assert len(f.read()) == len(g.read())

    for n, seed, lo, hi in ((2, 7, 2, 4), (4, 11, 4, 6)):
        runner = _port_runner(n)
        state = runner.init_state(_port_model(), _sgd, batches[0],
                                  seed=seed)
        state = restore_from_dir(state, ckpt, required=True)
        state = runner.place_state(state)
        assert len(state.tables["items"].shards) == n
        _, saved, _ = CheckpointSaver(ckpt).restore(state.step)
        placed = state_io.named_leaves_from_state(state)
        assert placed.keys() == saved.keys()
        for key, value in saved.items():
            np.testing.assert_array_equal(placed[key], value, err_msg=key)
        hook = CheckpointHook(checkpoint_dir=ckpt, checkpoint_steps=1,
                              async_save=False)
        hook.note_version(state.step)
        state, more = _port_train(runner, start, batches[lo:hi], state)
        losses += more
        assert hook.maybe_save(state)
    np.testing.assert_allclose(losses, control_losses, rtol=1e-5)
    _assert_leaves_close(state, control)


# ---- the job seam (tests/test_elastic_mesh_resize.py:278) -----------------

TINY_ZOO = '''
import torch

from elasticdl_tpu_torch.embedding.device_sparse import (
    DeviceSparseRunner, TableSpec)
from elasticdl_tpu_torch.embedding.optimizer import Adagrad
from elasticdl_tpu_torch.model_zoo.recsys import recsys_sparse as twin
from elasticdl_tpu_torch.model_zoo.recsys.recsys_sparse import (
    dataset_fn, eval_metrics_fn, loss)

SPECS = (TableSpec(twin.TABLE_NAME, vocab=1024, dim=16,
                   feature_key=twin.FEATURE_KEY),)


def custom_model(device=None):
    return twin.RecsysRanker(hidden=(32, 16), compute_dtype=torch.float32,
                             emb_dim=16).to(device)


def optimizer(lr=0.1):
    return lambda params: torch.optim.SGD(params, lr=lr)


def make_sparse_runner(mesh=None, axis="dp"):
    return DeviceSparseRunner(SPECS, Adagrad(lr=0.05), use_pallas="always",
                              mesh=mesh, axis=axis,
                              partition_threshold_bytes=0)
'''


class WorkerKilled(RuntimeError):
    pass


def test_sparse_job_dies_on_dp4_resumes_on_dp2_and_regrows(tmp_path):
    """A recsys job with a live row-sharded table dies on dp4 after 3
    tasks, a replacement worker resumes on dp2 from the checkpoint and
    drains the job, and the final checkpoint placed on dp4 holds the
    replacement's rows."""
    from elasticdl_tpu_torch.core.model_spec import get_model_spec
    from elasticdl_tpu_torch.testing.data import create_frappe_record_file

    zoo = tmp_path / "zoo" / "tiny"
    zoo.mkdir(parents=True)
    (zoo / "rec.py").write_text(textwrap.dedent(TINY_ZOO))
    train = create_frappe_record_file(str(tmp_path / "t.rec"), 192, seed=1,
                                      input_length=4, max_id=1024)
    ckpt_dir = str(tmp_path / "ckpt")
    calls = {"n": 0}

    def die_after_three(request):
        calls["n"] += 1
        if calls["n"] > 3:
            raise WorkerKilled("simulated preemption")

    cluster = MiniCluster(
        model_zoo=str(tmp_path / "zoo"), model_def="tiny.rec.custom_model",
        training_data=train, minibatch_size=16, num_minibatches_per_task=2,
        checkpoint_dir=ckpt_dir, checkpoint_steps=2, device="cpu",
        mesh=_meshes(4)[1], worker_callbacks={"get_task": die_after_three})
    with pytest.raises(WorkerKilled):
        cluster.workers[0].run()
    assert not cluster.finished
    table = cluster.workers[0].state.tables[twin.TABLE_NAME]
    assert isinstance(table, ShardedTensor) and len(table.shards) == 4
    cluster.workers[0]._checkpoint.flush()
    cluster.dispatcher.recover_tasks(0)
    version = CheckpointSaver(ckpt_dir).get_valid_latest_version()
    assert version is not None and version >= 2

    spec2 = get_model_spec(str(tmp_path / "zoo"), "tiny.rec.custom_model",
                           device="cpu")
    replacement = Worker(
        worker_id=1,
        master_client=InProcessMaster(cluster.servicer, worker_id=1),
        model_spec=spec2, data_reader=cluster.train_reader,
        minibatch_size=16,
        step_runner=spec2.make_sparse_runner(mesh=_meshes(2)[1]),
        checkpoint_dir_for_init=ckpt_dir,
        checkpoint_hook=CheckpointHook(checkpoint_dir=ckpt_dir,
                                       checkpoint_steps=2, async_save=False))
    result = replacement.run()
    assert cluster.finished
    assert replacement.state.step > version
    assert np.isfinite(result["final_loss"])
    table = replacement.state.tables[twin.TABLE_NAME]
    assert len(table.shards) == 2

    runner4 = spec2.make_sparse_runner(mesh=_meshes(4)[1])
    state4 = runner4.init_state(spec2.make_model(), spec2.make_optimizer(),
                                replacement.last_batch, seed=13)
    state4 = restore_from_dir(state4, ckpt_dir, required=True)
    state4 = runner4.place_state(state4)
    assert len(state4.tables[twin.TABLE_NAME].shards) == 4
    assert state4.step == replacement.state.step
    np.testing.assert_array_equal(
        state4.tables[twin.TABLE_NAME].gather().numpy(),
        replacement.state.tables[twin.TABLE_NAME].gather().numpy())


def _worker_argv(zoo, train, *extra):
    return ["--worker_id", "0", "--model_zoo", zoo,
            "--model_def", "tiny.rec.custom_model", "--training_data", train,
            "--minibatch_size", "16", "--device", "cpu",
            "--master_addr", "localhost:1", *extra]


def test_worker_main_mesh_strategy_row_shards_the_sparse_model(tmp_path):
    """``worker.main`` under MeshStrategy gives a device-tier sparse
    model its runner with the mesh (worker/main.py:120-156 of the JAX
    package): the table row-shards over the first axis, and the job
    drains through it. ``--grads_to_wait`` > 1 is refused, and so are
    the multi-host flags where they cannot start a job: no coordinator,
    a process id out of range, no MeshStrategy. (A checkpoint directory
    is no longer refused: tests/test_torch_orbax_backend_procs.py runs
    such a job across two processes.)"""
    from elasticdl_tpu_torch.common.args import parse_worker_args
    from elasticdl_tpu_torch.master.evaluation_service import (
        EvaluationService,
    )
    from elasticdl_tpu_torch.master.servicer import MasterServicer
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.testing.data import create_frappe_record_file
    from elasticdl_tpu_torch.worker.main import build_worker

    zoo = tmp_path / "zoo" / "tiny"
    zoo.mkdir(parents=True)
    (zoo / "rec.py").write_text(textwrap.dedent(TINY_ZOO))
    train = create_frappe_record_file(str(tmp_path / "t.rec"), 64, seed=1,
                                      input_length=4, max_id=1024)
    mesh_flags = ("--distribution_strategy", "MeshStrategy", "--mesh_shape",
                  "4", "--mesh_axes", "dp")
    args = parse_worker_args(_worker_argv(str(tmp_path / "zoo"), train,
                                          *mesh_flags))
    dispatcher = TaskDispatcher(
        training_shards={train: (0, 64)}, evaluation_shards={},
        prediction_shards={}, records_per_task=32, num_epochs=1)
    servicer = MasterServicer(dispatcher, EvaluationService(dispatcher, {}))
    worker = build_worker(args, master_client=InProcessMaster(servicer))
    runner = worker._step_runner
    assert isinstance(runner, tds.DeviceSparseRunner)
    assert runner.mesh.shape == {"dp": 4} and runner.mesh.device == CPU
    assert runner.sharded_tables == frozenset({twin.TABLE_NAME})
    result = worker.run()
    assert dispatcher.finished() and np.isfinite(result["final_loss"])
    table = worker.state.tables[twin.TABLE_NAME]
    assert isinstance(table, ShardedTensor) and len(table.shards) == 4
    with pytest.raises(ValueError, match="grads_to_wait"):
        build_worker(parse_worker_args(_worker_argv(
            str(tmp_path / "zoo"), train, *mesh_flags,
            "--grads_to_wait", "2")), master_client=InProcessMaster(servicer))
    multi = ("--num_jax_processes", "2", "--coordinator_addr",
             "localhost:1234")
    for flags, error, match in (
            (multi[:2], ValueError, "coordinator_addr"),
            (multi + ("--jax_process_id", "5"), ValueError, "out of range"),
            (multi, ValueError, "MeshStrategy")):
        with pytest.raises(error, match=match):
            build_worker(parse_worker_args(_worker_argv(
                str(tmp_path / "zoo"), train, *flags)),
                master_client=InProcessMaster(servicer))
