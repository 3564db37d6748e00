"""The port's ring attention, its chunk-update kernel (#2) and its mesh,
against the JAX package's.

Inputs are made with numpy from a seed and fed to both frameworks. The
JAX side runs ``flash_chunk_update`` and the kernel ring in interpret
mode on the virtual CPU devices (tests/conftest.py), as
tests/test_ring_attention.py does; the port's CPU side runs the kernels'
plain versions on a mesh of the CPU repeated (``[cpu] * n``: one
controller, every entry one device). The CUDA kernel is held against
the plain version on the card in tests/test_torch_cuda_kernels.py and
in chip_smoke.py.

Tolerances:
- chunk update, f32: |got - want| <= 2e-5 * (1 + |want|) for m, l and
  acc (f32 sums over at most 37 keys in another order), for the
  whole-chunk plain version and for the one folded in the wgmma
  kernel's order (key tiles of 8 or 64, two running states merged).
  JAX's default blocks take a whole small chunk as one tile, so both
  sides take p against the same maximum; bf16 rounds p once on both
  sides, and an exp that differs in the last f32 bit can flip that
  rounding: acc at 2e-2 * max(1, |want|), as the flash forward's bf16
  test; m exact in the maximum's inputs (2e-5), l at 1e-4 relative.
- chunk update, bf16, folded in the kernel's order against the whole
  chunk: p rounded against other maxima, held to chip_smoke.py's
  CHUNK_WHOLE_TOL (elem 6e-2, L2 5e-3; elem = max |g - w| / (|w| +
  median|w|)).
- rings, f32 (values 2e-5, gradients rtol 2e-4 / atol 2e-5): the JAX
  ring tests' own tolerances (tests/test_ring_attention.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import flash_attention as jfa
from elasticdl_tpu.ops import ring_attention as jra
from elasticdl_tpu.parallel import mesh as jmesh
from elasticdl_tpu_torch.ops import flash_attention as tfa
from elasticdl_tpu_torch.ops import ring_attention as tra
from elasticdl_tpu_torch.parallel import mesh as tmesh

B, S, H = 2, 32, 4
CPU = torch.device("cpu")
F32_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
NEG = np.float32(-1e30)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _qkv(shape, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) * scale
            for _ in range(3)]


def _meshes(shape, axes):
    n = int(np.prod(shape))
    return (jmesh.make_mesh(shape, axes, devices=jax.devices()[:n]),
            tmesh.make_mesh(shape, axes, devices=[CPU] * n))


# ---- the chunk update (#2) ------------------------------------------------

# (sq, sk, q_offset, k_offset, causal): the kernel check's case kinds.
CHUNK_CASES = {
    "diagonal": (16, 16, 16, 16, True),
    "past": (16, 16, 32, 0, True),
    "future": (16, 16, 0, 16, True),         # every key after every query
    "first_rows_masked": (16, 24, 8, 12, True),
    "ragged": (20, 37, 40, 10, True),        # Sq != Sk, not tile multiples
    "full": (16, 24, 0, 0, False),
}


def _carry(bh, sq, d, seed):
    """A carry already folded from an earlier chunk: (m, l, acc) as a
    previous update leaves them (finite m, l > 0)."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((bh, sq, 1), dtype=np.float32)
    l = rng.uniform(0.5, 3.0, (bh, sq, 1)).astype(np.float32)
    acc = rng.standard_normal((bh, sq, d), dtype=np.float32)
    return m, l, acc


def _initial(bh, sq, d):
    return (np.full((bh, sq, 1), NEG, np.float32),
            np.zeros((bh, sq, 1), np.float32),
            np.zeros((bh, sq, d), np.float32))


def _chunk_inputs(case, carry):
    """The chunk-update test's inputs for a CHUNK_CASES entry, as numpy
    (q, k, v) and carry (m, l, acc)."""
    sq, sk, q_off, _, _ = CHUNK_CASES[case]
    bh, d = 4, 16
    rng = np.random.default_rng(sq + sk + q_off)
    q = rng.standard_normal((bh, sq, d), dtype=np.float32)
    k, v = (rng.standard_normal((bh, sk, d), dtype=np.float32)
            for _ in range(2))
    state = (_initial(bh, sq, d) if carry == "initial"
             else _carry(bh, sq, d, seed=sk))
    return (q, k, v), state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carry", ["initial", "folded"])
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunk_update_reference_matches_jax(case, carry, dtype):
    sq, sk, q_off, k_off, causal = CHUNK_CASES[case]
    (q, k, v), state = _chunk_inputs(case, carry)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jfa.flash_chunk_update(
        *(jnp.asarray(x, jdt) for x in (q, k, v)),
        *(jnp.asarray(x) for x in state), q_off, k_off, causal=causal,
        interpret=True)
    got = tfa.flash_chunk_update(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        *(torch.from_numpy(x) for x in state), q_off, k_off, causal=causal)
    assert tfa.chunk_launches == 0          # the CPU launches no kernel
    for name, g, w in zip(("m", "l", "acc"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        g, w = _np(g), np.asarray(w)
        if dtype == "float32" or name == "m":
            tol = 2e-5 * (1 + np.abs(w))
        elif name == "l":
            tol = 1e-4 * np.abs(w)
        else:
            tol = 2e-2 * np.maximum(1.0, np.abs(w))
        assert np.all(np.abs(g - w) <= tol), (name, np.abs(g - w).max())
    if case == "future":       # a wholly future chunk leaves the carry
        for g, s in zip(got, state):
            np.testing.assert_array_equal(_np(g), s)
    if case == "first_rows_masked" and carry == "initial":
        # rows 0-3 (global 8-11) see no key at or before them (keys start
        # at 12): they keep m = -1e30, l = 0 and acc = 0.
        assert np.all(_np(got[0])[:, :4] == NEG)
        assert not np.any(_np(got[1])[:, :4])
        assert not np.any(_np(got[2])[:, :4])


@pytest.mark.parametrize("block_k", [8, 64])
@pytest.mark.parametrize("carry", ["initial", "folded"])
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunk_update_tiled_reference_matches_jax(case, carry, block_k):
    """The plain version folded in the wgmma kernel's order (even key
    tiles into the carry, odd ones into an empty state, merged) against
    JAX's kernel in interpret mode, f32."""
    _, _, q_off, k_off, causal = CHUNK_CASES[case]
    qkv, state = _chunk_inputs(case, carry)
    want = jfa.flash_chunk_update(
        *(jnp.asarray(x) for x in qkv + state), q_off, k_off,
        causal=causal, interpret=True)
    got = tfa.flash_chunk_update_reference(
        *(torch.from_numpy(x) for x in qkv + state), q_off, k_off, causal,
        block_k=block_k, consumers=2)
    for name, g, w in zip(("m", "l", "acc"), got, want):
        g, w = _np(g), np.asarray(w)
        assert np.all(np.abs(g - w) <= 2e-5 * (1 + np.abs(w))), (
            name, np.abs(g - w).max())


@pytest.mark.parametrize("carry", ["initial", "folded"])
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunk_update_tiled_reference_bf16_near_whole(case, carry):
    """bf16: the plain version folded over 8-key tiles into two merged
    states (p rounded against their running maxima) stays within
    CHUNK_WHOLE_TOL of the whole-chunk one."""
    _, _, q_off, k_off, causal = CHUNK_CASES[case]
    qkv, state = _chunk_inputs(case, carry)
    args = [torch.from_numpy(x).to(torch.bfloat16) for x in qkv] + [
        torch.from_numpy(x) for x in state]
    got = tfa.flash_chunk_update_reference(*args, q_off, k_off, causal,
                                           block_k=8, consumers=2)
    want = tfa.flash_chunk_update_reference(*args, q_off, k_off, causal)
    for name, g, w in zip(("m", "l", "acc"), got, want):
        g, w = _np(g).astype(np.float64), _np(w).astype(np.float64)
        # Rows that saw no key keep m -1e30, l 0 and acc 0 exactly.
        seen = (np.abs(w) < 1e29) & (w != 0)
        assert np.array_equal(g[~seen], w[~seen]), name
        if seen.any():
            err = np.abs(g - w)[seen]
            floor = np.median(np.abs(w[seen]))
            elem = (err / (np.abs(w[seen]) + floor)).max()
            l2 = np.linalg.norm(err) / np.linalg.norm(w[seen])
            assert elem <= 6e-2 and l2 <= 5e-3, (name, elem, l2)


@pytest.mark.parametrize("block_k", [8, 64])
@pytest.mark.parametrize("carry", ["initial", "folded"])
def test_chunk_with_nothing_to_fold_returns_its_carry(carry, block_k):
    """A wholly future chunk through the two merged states: the carry
    comes back bit for bit (the empty state merges to nothing)."""
    _, _, q_off, k_off, causal = CHUNK_CASES["future"]
    qkv, state = _chunk_inputs("future", carry)
    for dtype in (torch.float32, torch.bfloat16):
        got = tfa.flash_chunk_update_reference(
            *(torch.from_numpy(x).to(dtype) for x in qkv),
            *(torch.from_numpy(x) for x in state), q_off, k_off, causal,
            block_k=block_k, consumers=2)
        for g, s in zip(got, state):
            np.testing.assert_array_equal(_np(g), s)


@pytest.mark.parametrize("d,dtype,consumers", [
    (128, torch.bfloat16, 2), (64, torch.bfloat16, 2),
    (32, torch.bfloat16, 1), (16, torch.bfloat16, 1),
    (128, torch.float32, 1), (64, torch.float32, 1),
])
def test_chunk_fold_order_follows_the_kernel_route(d, dtype, consumers):
    """bf16 D 64 and 128 take the wgmma kernel (two states); the others
    fold every 64-key tile into the carry in turn."""
    assert tfa.chunk_block_k(d, dtype) == 64
    assert tfa.chunk_consumers(d, dtype) == consumers


def test_chunk_update_folds_like_one_pass():
    """Two chunks folded in turn, then normalised, equal attention over
    their concatenation (the ring's contract)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv((3, 24, 32), seed=4))
    state = tuple(torch.from_numpy(x) for x in _initial(3, 24, 32))
    for lo, hi in ((0, 12), (12, 24)):
        state = tfa.flash_chunk_update(q, k[:, lo:hi].contiguous(),
                                       v[:, lo:hi].contiguous(), *state,
                                       0, lo, causal=True)
    m, l, acc = state
    o_ref, lse_ref = tfa.flash_forward_reference(q, k, v, causal=True)
    np.testing.assert_allclose(_np(acc / l), _np(o_ref), **F32_TOL)
    np.testing.assert_allclose(_np(m + l.log())[..., 0], _np(lse_ref),
                               **F32_TOL)


def test_chunk_update_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(x) for x in _qkv((2, 16, 16), seed=1))
    m, l, acc = (torch.from_numpy(x) for x in _initial(2, 16, 16))
    with pytest.raises(ValueError, match="dtypes"):
        tfa.flash_chunk_update(q, k.to(torch.bfloat16), v, m, l, acc)
    with pytest.raises(ValueError, match="float32"):
        tfa.flash_chunk_update(q, k, v, m.double(), l, acc)
    with pytest.raises(ValueError, match="shapes"):
        tfa.flash_chunk_update(q, k, v, m[..., 0], l, acc)
    with pytest.raises(ValueError, match="kernel takes D"):
        tfa.flash_chunk_update(*(x[..., :8].contiguous()
                                 for x in (q, k, v)), m, l,
                               acc[..., :8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_chunk_update(q, k, v, m, l, acc.transpose(1, 2)
                               .contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="tensors on cpu"):
        tfa.flash_chunk_update_cuda(q, k, v, m, l, acc, 0, 0, True, 0.25)


# ---- the ring -------------------------------------------------------------


def _ring_pair(mesh_shape, axes, causal, d, seed, jax_kwargs, use_pallas):
    """(JAX, port) outputs and (q, k, v) gradients of sum(out * cos out)."""
    arrays = _qkv((B, S, H, d), seed)
    jm, tm = _meshes(mesh_shape, axes)

    def jloss(q, k, v):
        out = jra.ring_attention(q, k, v, jm, causal=causal, **jax_kwargs)
        return jnp.sum(out * jnp.cos(out)), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x) for x in arrays))
    leaves = [torch.from_numpy(x).requires_grad_() for x in arrays]
    got = tra.ring_attention(*leaves, tm, causal=causal,
                             use_pallas=use_pallas)
    (got * got.cos()).sum().backward()
    return (want, jgrads), (got, [x.grad for x in leaves])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mesh_shape,axes", [
    ((4,), ("sp",)),
    ((2, 2, 2), ("dp", "sp", "tp")),
])
def test_kernel_ring_matches_jax_kernel_ring(mesh_shape, axes, causal):
    """The port's kernel flavour (plain chunk updates and chunk grads on
    the CPU) against JAX's flash_chunk_update ring in interpret mode."""
    (want, jgrads), (got, grads) = _ring_pair(
        mesh_shape, axes, causal, 16, seed=6,
        jax_kwargs=dict(use_pallas=True, interpret=True), use_pallas=None)
    assert got.shape == (B, S, H, 16)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    for g, w in zip(grads, jgrads):
        np.testing.assert_allclose(_np(g), np.asarray(w), **GRAD_TOL)
    assert tfa.chunk_launches == tfa.dq_launches == 0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mesh_shape,axes", [
    ((4,), ("sp",)),
    ((8,), ("sp",)),
    ((2, 2, 2), ("dp", "sp", "tp")),
])
def test_einsum_ring_matches_jax_default_ring(mesh_shape, axes, causal):
    """use_pallas=False against JAX's default off the TPU (its jnp ring),
    at the JAX ring tests' own head dim."""
    (want, jgrads), (got, grads) = _ring_pair(
        mesh_shape, axes, causal, 8, seed=7, jax_kwargs={},
        use_pallas=False)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    for g, w in zip(grads, jgrads):
        np.testing.assert_allclose(_np(g), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("use_pallas,d", [(None, 16), (False, 16),
                                          (None, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_flavours_match_port_dense(use_pallas, d, causal):
    """Both flavours (and the gate's choice at an untemplated head dim,
    which takes the einsum flavour on the CPU) against the port's
    dense_attention, values and gradients."""
    arrays = _qkv((B, S, H, d), seed=d + causal)
    mesh = tmesh.make_mesh((4,), ("sp",), devices=[CPU] * 4)
    outs, grads = [], []
    for ring in (True, False):
        leaves = [torch.from_numpy(x).requires_grad_() for x in arrays]
        out = (tra.ring_attention(*leaves, mesh, causal=causal,
                                  use_pallas=use_pallas) if ring
               else tra.dense_attention(*leaves, causal=causal))
        (out ** 2).sum().backward()
        outs.append(_np(out))
        grads.append([_np(x.grad) for x in leaves])
    np.testing.assert_allclose(outs[0], outs[1], **F32_TOL)
    for g, w in zip(*grads):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


@pytest.mark.parametrize("mesh_shape,axes,s_len", [
    ((4,), ("dp",), 32),          # no sp axis
    ((1, 4), ("sp", "dp"), 32),   # sp of size 1
    ((4,), ("sp",), 30),          # sp does not divide S
])
def test_fallbacks_match_jax(mesh_shape, axes, s_len):
    """Where the ring cannot run, both packages take dense attention on
    the CPU (the port takes flash_attention, kernel #1, on the card)."""
    arrays = _qkv((B, s_len, H, 16), seed=s_len)
    jm, tm = _meshes(mesh_shape, axes)
    want = jra.ring_attention(*(jnp.asarray(x) for x in arrays), jm)
    got = tra.ring_attention(*(torch.from_numpy(x) for x in arrays), tm)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    dense = tra.dense_attention(*(torch.from_numpy(x) for x in arrays))
    np.testing.assert_array_equal(_np(got), _np(dense))


def test_ring_rejects_tensors_off_the_mesh_device():
    mesh = tmesh.make_mesh((2,), ("sp",), devices=[torch.device("cuda:0")]
                           * 2)
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="mesh on cuda"):
        tra.ring_attention(q, q, q, mesh)


# ---- the mesh -------------------------------------------------------------


@pytest.mark.parametrize("shape,axes,want", [
    ("", "dp", (None, ("dp",))),
    ("", "", (None, ("dp",))),
    ("4,2", "dp,mp", ((4, 2), ("dp", "mp"))),
    ("1,4,2", "dp, sp ,tp", ((1, 4, 2), ("dp", "sp", "tp"))),
])
def test_parse_mesh_args_matches_jax(shape, axes, want):
    assert jmesh.parse_mesh_args(shape, axes) == want
    assert tmesh.parse_mesh_args(shape, axes) == want


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type and text are compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("call", [
    lambda m, devs: m.parse_mesh_args("4,2", "dp"),
    lambda m, devs: m.make_mesh((4,), ("sp",), devs[:2]),
    lambda m, devs: m.make_mesh((2, 3), ("dp", "sp"), devs[:4]),
])
def test_mesh_errors_match_jax(call):
    want = _error(lambda: call(jmesh, jax.devices()))
    got = _error(lambda: call(tmesh, [CPU] * 8))
    assert want is not None and got == want


@pytest.mark.parametrize("shape,axes,n", [
    ((4,), ("sp",), 4), ((2, 2, 2), ("dp", "sp", "tp"), 8),
    (None, ("sp", "dp"), 3),
])
def test_mesh_shape_matches_jax(shape, axes, n):
    jm, tm = (m.make_mesh(shape, axes, devices=devs[:n]) for m, devs in (
        (jmesh, jax.devices()), (tmesh, [CPU] * n)))
    assert tm.axis_names == jm.axis_names
    assert tm.shape == dict(jm.shape)
    assert tm.devices.shape == jm.devices.shape
    assert tm.device == CPU


def test_mesh_of_distinct_devices_waits_for_the_parallel_slice():
    """A mesh over distinct devices still raises, naming ROADMAP item 6b
    (the multi-device half of the parallel slice)."""
    with pytest.raises(NotImplementedError, match="item 6b"):
        tmesh.make_mesh((2,), ("sp",), [CPU, torch.device("cuda:0")])
    with pytest.raises(NotImplementedError, match="item 6b"):
        tmesh.make_mesh((2,), ("sp",), ["cuda:0", "cuda:1"])


def test_default_mesh_takes_the_cuda_devices():
    if torch.cuda.is_available():
        mesh = tmesh.make_mesh()
        assert mesh.device.type == "cuda" and mesh.axis_names == ("dp",)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()
