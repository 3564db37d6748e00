"""The port's embedding kernels' plain versions (ops/pallas_embedding.py)
against the JAX package's Pallas kernels in interpret mode, on the same
numpy-seeded inputs, mirroring tests/test_pallas_embedding.py and
tests/test_sparse_path.py's fused cases. On the CPU each wrapper runs
its plain version; the CUDA kernels are held against the plain versions
on the card in the ``cuda``-marked test and in chip_smoke.py.

Tolerances (f32): lookups at rtol 1e-5 / atol 1e-6 (both sum the L rows
in id order; XLA may fuse a multiply-add where torch rounds the
product); row updates at rtol 1e-5 / atol 1e-6 on the touched rows (the
same expressions in the same order); rows a pad or nobody names, and
their slots, bit-equal to before.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.embedding.combiner import combine as jax_combine
from elasticdl_tpu.ops import pallas_embedding as jpe
from elasticdl_tpu_torch.ops import pallas_embedding as pe

V, B, L = 64, 8, 5
TOL = dict(rtol=1e-5, atol=1e-6)


def _lookup_inputs(dim, seed=0, batch=B):
    rng = np.random.RandomState(seed)
    table = rng.randn(V, dim).astype(np.float32)
    ids = rng.randint(0, V, (batch, L)).astype(np.int32)
    weights = rng.rand(batch, L).astype(np.float32)
    weights[2] = 0.0        # an empty row: zeros, not NaN
    weights[3, 2:] = 0.0    # a padded row
    return table, ids, weights


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("dim", [128, 256])
@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_lookup_matches_pallas_interpret(dim, combiner):
    table, ids, weights = _lookup_inputs(dim)
    want = jpe.lookup_combine_pallas(jnp.asarray(table), jnp.asarray(ids),
                                     jnp.asarray(weights), combiner,
                                     interpret=True)
    got = pe.lookup_combine_pallas(*_t(table, ids, weights), combiner)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not torch.isnan(got).any()


@pytest.mark.parametrize("dim", [128, 256])
@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_aligned_lookup_matches_pallas_interpret(dim, combiner):
    table, ids, weights = _lookup_inputs(dim, seed=1)
    want = jpe.lookup_combine_aligned(jnp.asarray(table), jnp.asarray(ids),
                                      jnp.asarray(weights), combiner,
                                      interpret=True)
    got = pe.lookup_combine_aligned(*_t(table, ids, weights), combiner)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_aligned_lookup_rejects_unaligned_vocab():
    table, ids, weights = _t(*_lookup_inputs(128))
    with pytest.raises(ValueError, match="vocab % 8"):
        pe.lookup_combine_aligned(table[:-3], ids, weights, "sum")


def test_lookup_odd_batch():
    table, ids, weights = _lookup_inputs(128, seed=2, batch=5)
    want = jpe.lookup_combine_pallas(jnp.asarray(table), jnp.asarray(ids),
                                     jnp.asarray(weights), "mean",
                                     interpret=True)
    got = pe.lookup_combine_pallas(*_t(table, ids, weights), "mean")
    assert got.shape == (5, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_lookup_reads_out_of_range_ids_as_zero_rows():
    table, ids, weights = _lookup_inputs(16, seed=3)
    ids[0, 0], ids[1, 1] = V, -1
    got = pe.lookup_combine_pallas(*_t(table, ids, weights), "sum")
    w = weights.copy()
    w[0, 0] = w[1, 1] = 0.0
    want = (table[np.clip(ids, 0, V - 1)] * w[..., None]).sum(axis=1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_lookup_combine_dispatch_contract():
    table, ids, weights = _t(*_lookup_inputs(48, seed=4))
    assert pe.use_pallas_lookup(256, 32) is False
    assert pe.use_pallas_apply(256, 16384) is False
    want = jax_combine(jnp.take(jnp.asarray(table.numpy()),
                                jnp.asarray(ids.numpy()), axis=0),
                       jnp.asarray(weights.numpy()), "mean")
    for kw in ({}, {"force_xla": True}, {"force_pallas": True}):
        got = pe.lookup_combine(table, ids, weights, "mean", **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="exclusive"):
        pe.lookup_combine(table, ids, weights, "sum", force_pallas=True,
                          force_xla=True)
    with pytest.raises(ValueError, match="combiner"):
        pe.lookup_combine(table, ids, weights, "max")
    with pytest.raises(NotImplementedError, match="parallel slice"):
        pe.lookup_combine_sharded(table, ids, weights, "sum", None, "dp")


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_lookup_backward_matches_jax_vjp(combiner):
    table, ids, weights = _lookup_inputs(128, seed=5)
    cot = np.random.RandomState(6).randn(B, 128).astype(np.float32)
    _, vjp = jax.vjp(
        lambda t, w: jpe.lookup_combine(t, jnp.asarray(ids), w, combiner,
                                        interpret=True, force_pallas=True),
        jnp.asarray(table), jnp.asarray(weights))
    want_t, want_w = vjp(jnp.asarray(cot))
    t, i, w = _t(table, ids, weights)
    t.requires_grad_()
    w.requires_grad_()
    before = pe.lookup_launches
    out = pe.lookup_combine(t, i, w, combiner, force_pallas=True)
    out.backward(torch.from_numpy(cot))
    assert pe.lookup_launches == before     # the CPU took the plain version
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_t), **TOL)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(want_w),
                               rtol=1e-5, atol=1e-5)


# ---- row updates (#7) ------------------------------------------------------

D = 128


def _row_inputs(rule, dim=D, seed=0, n_real=6, n_pad=2):
    rng = np.random.RandomState(seed)
    table = rng.randn(V, dim).astype(np.float32)
    slots = {
        "sgd": [],
        "momentum": [rng.randn(V, dim).astype(np.float32) * 0.1],
        "adagrad": [np.full((V, dim), 0.1, np.float32)],
        "adam": [rng.randn(V, dim).astype(np.float32) * 0.01,
                 np.abs(rng.randn(V, dim)).astype(np.float32) * 0.01],
    }
    slots["amsgrad"] = slots["adam"] + [
        np.abs(rng.randn(V, dim)).astype(np.float32) * 0.01]
    real = rng.choice(V, n_real, replace=False)
    ids = rng.permutation(np.concatenate([real, np.full(n_pad, V)]))
    grads = rng.randn(ids.size, dim).astype(np.float32)   # pads nonzero too
    return [table] + slots[rule], ids.astype(np.int32), grads, real


def _jax_update(rule, tables, ids, grads, step, nesterov):
    args = [jnp.asarray(t) for t in tables] + [jnp.asarray(ids),
                                              jnp.asarray(grads)]
    if rule == "sgd":
        return [jpe.sparse_sgd_update(*args, lr=0.05, interpret=True)]
    if rule == "momentum":
        return jpe.sparse_momentum_update(*args, lr=0.05, momentum=0.9,
                                          nesterov=nesterov, interpret=True)
    if rule == "adagrad":
        return jpe.sparse_adagrad_update(*args, lr=0.05, interpret=True)
    if rule == "adam":
        return jpe.sparse_adam_update(*args, lr=0.01, step=step,
                                      interpret=True)
    return jpe.sparse_adam_amsgrad_update(*args, lr=0.01, step=step,
                                          interpret=True)


def _port_update(rule, tables, ids, grads, step, nesterov):
    tables = [torch.from_numpy(t.copy()) for t in tables]
    i, g = _t(ids, grads)
    if rule == "sgd":
        return [pe.sparse_sgd_update(*tables, i, g, lr=0.05)]
    if rule == "momentum":
        return pe.sparse_momentum_update(*tables, i, g, lr=0.05,
                                         momentum=0.9, nesterov=nesterov)
    if rule == "adagrad":
        return pe.sparse_adagrad_update(*tables, i, g, lr=0.05)
    if rule == "adam":
        return pe.sparse_adam_update(*tables, i, g, lr=0.01, step=step)
    return pe.sparse_adam_amsgrad_update(*tables, i, g, lr=0.01, step=step)


@pytest.mark.parametrize("rule,step,nesterov,dim", [
    ("sgd", 1, False, 128),
    ("momentum", 1, False, 128),
    ("momentum", 1, True, 256),
    ("adagrad", 1, False, 128),
    ("adagrad", 1, False, 256),
    ("adam", 1, False, 128),
    ("adam", 7, False, 256),
    ("amsgrad", 7, False, 128),
])
def test_row_update_matches_pallas_interpret(rule, step, nesterov, dim):
    tables, ids, grads, real = _row_inputs(rule, dim=dim, seed=dim + step)
    want = _jax_update(rule, tables, ids, grads, step, nesterov)
    got = _port_update(rule, tables, ids, grads, step, nesterov)
    untouched = np.ones(V, bool)
    untouched[real] = False
    for g, w, before in zip(got, want, tables):
        np.testing.assert_allclose(g.numpy()[real], np.asarray(w)[real],
                                   **TOL)
        # Pads (id V) and untouched rows: no read, no write — Adam's and
        # momentum's slots do not decay there.
        np.testing.assert_array_equal(g.numpy()[untouched],
                                      before[untouched])


def test_row_update_is_in_place_and_validates():
    tables, ids, grads, real = _row_inputs("adagrad")
    table, accum = (torch.from_numpy(t) for t in tables)
    out = pe.sparse_adagrad_update(table, accum, *_t(ids, grads), lr=0.05)
    assert out[0] is table and out[1] is accum
    assert not np.array_equal(table.numpy()[real], _row_inputs(
        "adagrad")[0][0][real])
    with pytest.raises(ValueError, match="float32"):
        pe.sparse_sgd_update(table.double(), *_t(ids, grads), lr=0.1)
    with pytest.raises(ValueError, match="grads"):
        pe.sparse_sgd_update(table, *_t(ids, grads[:, :64]), lr=0.1)


def test_bias_corrections_in_f32_from_the_host_step():
    bc1, bc2 = pe.bias_corrections(0.9, 0.999, 7)
    step = jnp.asarray(7, jnp.float32)
    assert bc1 == float(1.0 - jnp.float32(0.9) ** step)
    assert abs(bc2 - float(1.0 - jnp.float32(0.999) ** step)) <= 1e-9


# ---- fused row updates (#8) ------------------------------------------------

FN = 11   # not a multiple of the 8 rows a block takes


def _fused_inputs(seed):
    rng = np.random.RandomState(seed)
    table = rng.randn(V, D).astype(np.float32)
    real = np.unique(rng.randint(0, V, FN))
    uids = np.concatenate([real, np.full(FN - real.size, V)]).astype(
        np.int32)
    grads = rng.randn(FN, D).astype(np.float32)
    return table, uids, grads, real


def test_fused_sgd_matches_pallas_interpret():
    table, uids, grads, _ = _fused_inputs(0)
    want = jpe.fused_sgd_scatter_apply(jnp.asarray(table), jnp.asarray(uids),
                                       jnp.asarray(grads), lr=0.1,
                                       interpret=True)
    got = pe.fused_sgd_scatter_apply(*_t(table, uids, grads), lr=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("nesterov", [False, True])
def test_fused_momentum_matches_pallas_interpret(nesterov):
    table, uids, grads, real = _fused_inputs(1)
    vel = np.random.RandomState(2).randn(V, D).astype(np.float32) * 0.1
    want_t, want_v = jpe.fused_momentum_scatter_apply(
        jnp.asarray(table), jnp.asarray(vel), jnp.asarray(uids),
        jnp.asarray(grads), lr=0.05, momentum=0.9, nesterov=nesterov,
        interpret=True)
    got_t, got_v = pe.fused_momentum_scatter_apply(
        *_t(table, vel, uids, grads), lr=0.05, momentum=0.9,
        nesterov=nesterov)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **TOL)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)
    untouched = np.ones(V, bool)
    untouched[real] = False
    np.testing.assert_array_equal(got_v.numpy()[untouched], vel[untouched])


def test_fused_apply_is_autodiff_exempt():
    table, uids, grads, _ = _fused_inputs(4)
    t, i, g = _t(table, uids, grads)
    g.requires_grad_()
    out = pe.fused_sgd_scatter_apply(t, i, g, lr=0.1)
    with pytest.raises(ValueError, match="autodiff-exempt"):
        out.sum().backward()


# ---- on the card -----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [16, 130, 256])
def test_cuda_kernels_match_plain(dim):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    table, ids, weights = _lookup_inputs(dim, seed=7, batch=37)
    t, i, w = (x.cuda() for x in _t(table, ids, weights))
    for fn, counter in ((pe.lookup_combine_pallas, "lookup_launches"),
                        (pe.lookup_combine_aligned, "aligned_launches")):
        for combiner in ("sum", "mean", "sqrtn"):
            before = getattr(pe, counter)
            got = fn(t, i, w, combiner)
            torch.cuda.synchronize()
            assert getattr(pe, counter) == before + 1
            want = pe.lookup_combine_reference(t, i, w, combiner)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    for rule in ("sgd", "momentum", "adagrad", "adam", "amsgrad"):
        tables, uids, grads, real = _row_inputs(rule, dim=dim, seed=8)
        for fused in ((False, True) if rule in ("sgd", "momentum")
                      else (False,)):
            got = [torch.from_numpy(x).cuda() for x in tables]
            want = [x.clone() for x in got]
            i, g = (x.cuda() for x in _t(uids, grads))
            pe.row_update(rule, i, g, got, fused=fused, lr=0.05,
                          momentum=0.9, nesterov=True, eps=1e-8,
                          beta1=0.9, beta2=0.999, step=3)
            pe.row_update_reference(rule, i, g, want, lr=0.05, momentum=0.9,
                                    nesterov=True, eps=1e-8, beta1=0.9,
                                    beta2=0.999,
                                    bc=pe.bias_corrections(0.9, 0.999, 3))
            torch.cuda.synchronize()
            for a, b, before in zip(got, want, tables):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
                untouched = np.ones(V, bool)
                untouched[real] = False
                assert np.array_equal(a.cpu().numpy()[untouched],
                                      before[untouched])


def test_sweep_bounds_count_each_byte_once():
    """The bounds the sweep and chip_smoke.py report: the recsys step's
    lookup (16,384 ids, ~16,250 distinct, D 256) and Adagrad apply
    (16,384 rows) at 3.35 TB/s."""
    from elasticdl_tpu_torch.tools import bench_kernel_device_sweep as tool

    ms, by = tool.lookup_bound(512, 32, 256, 16384)
    assert by == "bytes"
    assert ms == pytest.approx((16384 * 1024 + 512 * 32 * 8 + 512 * 1024)
                               / 3.35e12 * 1e3)
    assert 5.2e-3 < ms < 5.3e-3
    ms, by = tool.row_update_bound(16384, 16385, 256, slots=1)
    assert by == "bytes" and 24e-3 < ms < 26e-3       # 5 KB a row
    assert tool.row_update_bound(16384, 16385, 256, 0)[0] == pytest.approx(
        ms * 3 / 5, rel=1e-3)                         # SGD: 3 KB a row
    assert tool.sets_for(16.8e6) == 7 and tool.sets_for(1e9) == 2
    assert tool.sets_for(1e3) == 64
