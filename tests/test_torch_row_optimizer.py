"""The port's row optimizers (embedding/optimizer.py) against the JAX
package's, on the same numpy-seeded inputs, mirroring
tests/test_row_optimizer.py (TestSparseApply,
TestSparseApplyKernelDispatch) and tests/test_sparse_path.py's fused
routing cases.

The JAX side runs ``use_pallas="never"`` (XLA gather/scatter) and, for
the kernel modes, its Pallas kernels in interpret mode; the port's CPU
side runs the same modes, whose kernels take their plain versions on
the CPU. Tolerances (f32): rtol 1e-5 / atol 1e-6 (the same update
expressions; Adam's bias correction is computed in f32 on the host on
the port's side and by XLA's pow on the JAX side); the library routes'
untouched rows and slots bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.embedding import optimizer as jopt
from elasticdl_tpu_torch.embedding import optimizer as topt

TOL = dict(rtol=1e-5, atol=1e-6)
RULES = ["SGD", "Momentum", "Nesterov", "Adagrad", "Adam", "AdamAmsgrad"]


def _pair(name, lr=0.05):
    """The same optimizer in both packages."""
    if name == "Nesterov":
        return (jopt.Momentum(lr=lr, nesterov=True),
                topt.Momentum(lr=lr, nesterov=True))
    if name == "AdamAmsgrad":
        return (jopt.make_row_optimizer("Adam", lr=lr, amsgrad=True),
                topt.make_row_optimizer("Adam", lr=lr, amsgrad=True))
    return (jopt.make_row_optimizer(name, lr=lr),
            topt.make_row_optimizer(name, lr=lr))


def _slots(opt, shape, rng):
    return {name: (np.abs(rng.randn(*shape)) * 0.1).astype(np.float32)
            for name in opt.slot_names}


@pytest.mark.parametrize("name", RULES)
@pytest.mark.parametrize("step", [1, 7])
def test_apply_rows_matches_jax(name, step):
    jo, to = _pair(name)
    rng = np.random.RandomState(step)
    rows = rng.randn(6, 16).astype(np.float32)
    grads = rng.randn(6, 16).astype(np.float32)
    slots = _slots(jo, rows.shape, rng)
    want_rows, want_slots = jo.apply_rows(
        jnp.asarray(rows), jnp.asarray(grads),
        {k: jnp.asarray(v) for k, v in slots.items()}, step)
    got_rows, got_slots = to.apply_rows(
        torch.from_numpy(rows), torch.from_numpy(grads),
        {k: torch.from_numpy(v) for k, v in slots.items()}, step)
    np.testing.assert_allclose(got_rows.numpy(), np.asarray(want_rows),
                               **TOL)
    assert set(got_slots) == set(want_slots) == set(to.slot_names)
    for k in want_slots:
        np.testing.assert_allclose(got_slots[k].numpy(),
                                   np.asarray(want_slots[k]), **TOL)


def test_factory_and_slot_init():
    assert isinstance(topt.make_row_optimizer("SGD", lr=0.5), topt.SGD)
    assert isinstance(topt.make_row_optimizer("Adam"), topt.Adam)
    assert isinstance(topt.make_row_optimizer("Adam", amsgrad=True),
                      topt.AdamAmsgrad)
    assert topt.AdamAmsgrad().slot_names == ("m", "v", "max_v")
    with pytest.raises(ValueError):
        topt.make_row_optimizer("LBFGS")
    with pytest.raises(ValueError, match="max_v"):
        topt.Adam(amsgrad=True)
    slots = topt.init_slot_tables(topt.Adagrad(), 4, 3)
    assert torch.equal(slots["accumulator"], torch.full((4, 3), 0.1))
    assert topt.slot_init_value(topt.Adam(), "m") == 0.0


@pytest.mark.parametrize("shape", [(12,), (4, 6), (3, 5)])
def test_unique_pad_matches_jnp_unique(shape):
    rng = np.random.RandomState(sum(shape))
    ids = rng.randint(0, 7, shape).astype(np.int32)
    want_u, want_inv = jopt.unique_pad(jnp.asarray(ids), fill_id=7)
    got_u, got_inv = topt.unique_pad(torch.from_numpy(ids), fill_id=7)
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    np.testing.assert_array_equal(got_inv.numpy(),
                                  np.asarray(want_inv).reshape(shape))
    assert got_inv.shape == shape


def _state(opt, vocab, dim, seed):
    rng = np.random.RandomState(seed)
    table = rng.randn(vocab, dim).astype(np.float32)
    slots = _slots(opt, (vocab, dim), rng)
    return table, slots


def _run_both(name, mode, vocab=64, dim=128, n=9, seed=0, step=3):
    """sparse_apply in ``mode`` on both sides from the same state, ids
    deduplicated and padded with the vocab size (pads carry nonzero
    gradients)."""
    jo, to = _pair(name)
    table, slots = _state(jo, vocab, dim, seed)
    rng = np.random.RandomState(seed + 100)
    real = np.unique(rng.randint(0, vocab, n))
    uids = np.concatenate([real, np.full(n - real.size + 2, vocab)]).astype(
        np.int32)
    grads = rng.randn(uids.size, dim).astype(np.float32)
    want_t, want_s = jopt.sparse_apply(
        jo, jnp.asarray(table), {k: jnp.asarray(v) for k, v in slots.items()},
        jnp.asarray(uids), jnp.asarray(grads), step=step,
        use_pallas=mode, interpret=mode != "never")
    t = torch.from_numpy(table.copy())
    s = {k: torch.from_numpy(v.copy()) for k, v in slots.items()}
    got_t, got_s = topt.sparse_apply(to, t, s, torch.from_numpy(uids),
                                     torch.from_numpy(grads), step=step,
                                     use_pallas=mode)
    assert got_t is t and got_s is s         # updated in place
    return (table, slots, real, (np.asarray(want_t), want_s),
            (got_t.numpy(), got_s))


@pytest.mark.parametrize("name", RULES)
@pytest.mark.parametrize("mode", ["never", "always"])
def test_sparse_apply_matches_jax(name, mode):
    table, slots, real, want, got = _run_both(name, mode)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    for k in slots:
        np.testing.assert_allclose(got[1][k].numpy(), np.asarray(want[1][k]),
                                   **TOL, err_msg=k)
    untouched = np.ones(table.shape[0], bool)
    untouched[real] = False
    np.testing.assert_array_equal(got[0][untouched], table[untouched])
    for k in slots:
        np.testing.assert_array_equal(got[1][k].numpy()[untouched],
                                      slots[k][untouched])


@pytest.mark.parametrize("name", ["SGD", "Momentum", "Nesterov"])
def test_fused_mode_takes_the_fused_kernel(name, monkeypatch):
    from elasticdl_tpu_torch.ops import pallas_embedding as pe

    calls = []
    real = pe.row_update
    monkeypatch.setattr(pe, "row_update", lambda *a, **k: calls.append(
        k.get("fused", False)) or real(*a, **k))
    table, slots, _, want, got = _run_both(name, "fused", seed=2)
    assert calls == [True]
    np.testing.assert_allclose(got[0], want[0], **TOL)


@pytest.mark.parametrize("name", ["Adagrad", "Adam"])
def test_fused_mode_falls_back_cleanly(name, monkeypatch):
    """No fused kernel for the optimizer: the library route, no error."""
    from elasticdl_tpu_torch.ops import pallas_embedding as pe

    monkeypatch.setattr(pe, "row_update", None)   # must not be reached
    table, slots, _, want, got = _run_both(name, "fused", seed=3)
    np.testing.assert_allclose(got[0], want[0], **TOL)


def test_auto_takes_the_library_route(monkeypatch):
    from elasticdl_tpu_torch.ops import pallas_embedding as pe

    monkeypatch.setattr(pe, "row_update", None)
    _, _, _, want, got = _run_both("Momentum", "auto", seed=4)
    np.testing.assert_allclose(got[0], want[0], **TOL)


def test_always_raises_up_front():
    class Custom(topt.RowOptimizer):
        pass

    table = torch.zeros(8, 4)
    ids = torch.tensor([1, 8], dtype=torch.int32)
    grads = torch.ones(2, 4)
    assert topt.kernelizable(topt.SGD(), 4)
    assert topt.kernelizable(topt.AdamAmsgrad(), 130)
    assert not topt.kernelizable(Custom(), 4)
    assert topt.fused_apply_supported(topt.Momentum(nesterov=True), 256)
    assert not topt.fused_apply_supported(topt.Adagrad(), 256)
    with pytest.raises(ValueError, match="kernelizable"):
        topt.sparse_apply(Custom(), table, {}, ids, grads, step=1,
                          use_pallas="always")
    with pytest.raises(ValueError, match="use_pallas"):
        topt.sparse_apply(topt.SGD(), table, {}, ids, grads, step=1,
                          use_pallas="sometimes")


def test_pad_id_never_corrupts_row_zero_or_the_last_row():
    """The library route's pads write their anchor row's own new value:
    rows 0 and V-1 (the clamp target) stay put unless named."""
    vocab, dim = 8, 2
    opt = topt.Adagrad(lr=0.1)
    for ids in ([2, 2, 2, 2], [8, 8, 8, 8]):
        table = torch.ones(vocab, dim)
        slots = topt.init_slot_tables(opt, vocab, dim)
        uniq, _ = topt.unique_pad(torch.tensor(ids, dtype=torch.int32),
                                  fill_id=vocab)
        grads = torch.where((uniq < vocab)[:, None], 1.0, 5.0)
        topt.sparse_apply(opt, table, slots, uniq, grads, step=1)
        moved = {i for i in range(vocab) if not torch.equal(
            table[i], torch.ones(dim))}
        assert moved == ({2} if ids[0] == 2 else set())
        assert torch.equal(slots["accumulator"][[0, 7]],
                           torch.full((2, dim), 0.1))


@pytest.mark.parametrize("name", ["Adagrad", "AdamAmsgrad"])
def test_pack_unpack_and_sparse_apply_packed(name):
    jo, to = _pair(name)
    vocab, dim = 32, 8
    table, slots = _state(jo, vocab, dim, seed=5)
    packed = topt.pack_table(torch.from_numpy(table),
                             {k: torch.from_numpy(v) for k, v in
                              slots.items()}, to)
    assert packed.shape == (vocab, topt.packed_width(to, dim))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jopt.pack_table(
            jnp.asarray(table), {k: jnp.asarray(v) for k, v in
                                 slots.items()}, jo)))
    t_back, s_back = topt.unpack_table(packed, to, dim)
    np.testing.assert_array_equal(t_back.numpy(), table)
    for k in slots:
        np.testing.assert_array_equal(s_back[k].numpy(), slots[k])
    rng = np.random.RandomState(6)
    uids = np.concatenate([np.unique(rng.randint(0, vocab, 6)),
                           [vocab, vocab]]).astype(np.int32)
    grads = rng.randn(uids.size, dim).astype(np.float32)
    want = jopt.sparse_apply_packed(jo, jnp.asarray(packed.numpy()),
                                    jnp.asarray(uids), jnp.asarray(grads),
                                    2, dim)
    got = topt.sparse_apply_packed(to, packed, torch.from_numpy(uids),
                                   torch.from_numpy(grads), 2, dim)
    assert got is packed
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
