"""The port's flash attention, forward and backward, against the JAX
package's.

Inputs are made with numpy from a seed and fed to both frameworks. The
JAX side runs the Pallas kernel in interpret mode, as
tests/test_flash_attention.py does; the port's CPU side runs the plain
version (the CUDA kernel is held against it on the card, in the
``cuda``-marked case and in chip_smoke.py).

Tolerances: f32 at rtol/atol 2e-5 (f32 sums over at most 128 keys in
another order). bf16 at 2e-2 relative to max(1, |o|): o is rounded to
bf16 once (2^-9 relative) and each p once, against the running max in
the tiled JAX kernel but the final max in the plain version; lse stays
f32 (1e-4).

Backward (``flash_chunk_grads``): f32 at 2e-5 relative to (1 + |g|):
f32 sums over at most 128 keys or queries, in another order. bf16 at
2e-2 relative to max(1, |g|): both round ds and p to bf16 once at the
same points (2^-9 relative), but exp and the f32 sums that feed them
differ in the last bits, which can flip a rounding. Gradients through
``flash_attention`` use the JAX test's rtol 2e-4 / atol 2e-5
(tests/test_flash_attention.py).

The backward kernels on the card against the plain version on the same
inputs (``CUDA_BWD_TOL``, as in chip_smoke.py): per tensor,
|g - w| <= elem * (|w| + median|w|) at every element and
||g - w|| / ||w|| <= l2. In bf16 both round at the same points, so only
a rare flipped rounding differs (about 2^-8 of an element that sums few
terms, which sets elem); dropping the roundings altogether differs by
about 2^-9 at every term, above l2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import flash_attention as jfa
from elasticdl_tpu.ops.ring_attention import dense_attention as jdense
from elasticdl_tpu_torch.ops import flash_attention as tfa
from elasticdl_tpu_torch.ops.ring_attention import dense_attention as tdense

B, S, H = 2, 128, 2
BLOCK = 64
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = 2e-2
CUDA_BWD_TOL = {torch.bfloat16: dict(elem=3e-2, l2=2e-4),
                torch.float32: dict(elem=2e-5, l2=1e-6)}


def _qkv(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) * scale
            for _ in range(3)]


def _jax(arrays, dtype):
    return [jnp.asarray(a, dtype) for a in arrays]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _np(x):
    return np.asarray(torch.as_tensor(x).float()) if isinstance(
        x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_reference_matches_jax_flash_forward_f32(causal, d):
    arrays = _qkv((B * H, S, d), seed=d + causal)
    scale = d ** -0.5
    o_j, lse_j = jfa._flash_forward(*_jax(arrays, jnp.float32), causal,
                                    scale, BLOCK, BLOCK, True)
    o_t, lse_t = tfa.flash_forward_reference(
        *_torch(arrays, torch.float32), causal, scale)
    np.testing.assert_allclose(_np(o_t), np.asarray(o_j), **F32_TOL)
    np.testing.assert_allclose(_np(lse_t), np.asarray(lse_j)[..., 0],
                               **F32_TOL)
    assert lse_t.shape == (B * H, S) and lse_t.dtype == torch.float32


@pytest.mark.parametrize("causal", [True, False])
def test_reference_matches_jax_flash_forward_bf16(causal):
    arrays = _qkv((B * H, S, 128), seed=7)
    scale = 128 ** -0.5
    o_j, lse_j = jfa._flash_forward(*_jax(arrays, jnp.bfloat16), causal,
                                    scale, BLOCK, BLOCK, True)
    o_t, lse_t = tfa.flash_forward_reference(
        *_torch(arrays, torch.bfloat16), causal, scale)
    assert o_t.dtype == torch.bfloat16
    want = np.asarray(o_j.astype(jnp.float32))
    assert np.all(np.abs(_np(o_t) - want)
                  <= BF16_TOL * np.maximum(1.0, np.abs(want)))
    np.testing.assert_allclose(_np(lse_t), np.asarray(lse_j)[..., 0],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax(causal):
    arrays = _qkv((B, S, H, 64), seed=3, scale=0.5)
    want = jfa.flash_attention(*_jax(arrays, jnp.float32), causal=causal,
                               block_q=BLOCK, block_k=BLOCK,
                               interpret=True)
    got = tfa.flash_attention(*_torch(arrays, torch.float32),
                              causal=causal)
    assert got.shape == (B, S, H, 64)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    assert tfa.launches == 0  # the CPU path launches no kernel


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_offset", [0, 16])
def test_dense_attention_matches_jax(causal, q_offset):
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, 16, H, 32), dtype=np.float32)
    k, v = (rng.standard_normal((B, 32, H, 32), dtype=np.float32)
            for _ in range(2))
    want = jdense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, q_offset=q_offset)
    got = tdense(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v), causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)


def test_flash_matches_dense_in_port():
    arrays = _qkv((B, S, H, 128), seed=5, scale=0.5)
    q, k, v = _torch(arrays, torch.float32)
    np.testing.assert_allclose(_np(tfa.flash_attention(q, k, v)),
                               _np(tdense(q, k, v)), **F32_TOL)


@pytest.mark.parametrize("shape,dtype,ok", [
    ((2, 1024, 4, 128), torch.bfloat16, True),
    ((2, 64, 4, 64), torch.float32, True),
    ((2, 96, 4, 128), torch.bfloat16, True),    # ragged last tile
    ((2, 100, 8, 16), torch.bfloat16, True),    # the zoo twin's head dim
    ((2, 128, 4, 48), torch.bfloat16, False),   # head dim not templated
    ((2, 0, 4, 128), torch.bfloat16, False),    # empty sequence
    ((2, 128, 4, 128), torch.float16, False),   # dtype not taken
])
def test_supports(shape, dtype, ok):
    assert tfa.supports(shape, dtype) is ok


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = _torch(_qkv((4, 128, 64)), torch.float32)
    with pytest.raises(ValueError, match="dtypes"):
        tfa.flash_forward(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_forward(q.transpose(0, 1).contiguous().transpose(0, 1),
                          k, v)
    with pytest.raises(ValueError, match="takes D in"):
        tfa.flash_forward(*(x[..., :48].contiguous() for x in (q, k, v)))
    with pytest.raises(ValueError, match="shapes"):
        tfa.flash_forward(q, k[:2], v)
    with pytest.raises(ValueError, match="tensors on cpu"):
        tfa.flash_forward_cuda(q, k, v, True, 0.125)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s_len,d", [(100, 16), (37, 32), (130, 128)])
def test_ragged_sequence_matches_jax_dense(causal, s_len, d):
    """Any S takes the flash path (a ragged last tile is masked in the
    kernel); the JAX flash kernel needs tile multiples, so the ragged
    reference is JAX's dense_attention (f32, same tolerance)."""
    arrays = _qkv((B, s_len, H, d), seed=s_len + d, scale=0.5)
    assert tfa.supports((B, s_len, H, d), torch.float32)
    want = jdense(*_jax(arrays, jnp.float32), causal=causal)
    got = tfa.flash_attention(*_torch(arrays, torch.float32), causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)


def _chunk_inputs(bh, sq, sk, d, seed):
    """q, k, v, dO and a plausible lse (logsumexp of the f32 scores,
    plus noise) and delta, as numpy."""
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((bh, sq, d), dtype=np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((bh, sk, d), dtype=np.float32)
            for _ in range(2))
    s = np.einsum("bqd,bkd->bqk", q, k) * d ** -0.5
    lse = (np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1))
           + s.max(-1))[..., None].astype(np.float32)
    delta = rng.standard_normal((bh, sq, 1), dtype=np.float32)
    return q, k, v, do, lse, delta


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,d,q_offset,k_offset,causal", [
    (128, 128, 16, 0, 0, True),
    (128, 128, 64, 0, 0, True),
    (128, 128, 128, 0, 0, True),
    (128, 128, 16, 0, 0, False),
    (128, 128, 64, 0, 0, False),
    (128, 128, 128, 0, 0, False),
    (64, 128, 64, 64, 0, True),        # ring-like: the second q chunk
    (64, 128, 32, 0, 128, True),       # a chunk wholly above the diagonal
])
def test_chunk_grads_reference_matches_jax(dtype, sq, sk, d, q_offset,
                                           k_offset, causal):
    q, k, v, do, lse, delta = _chunk_inputs(2, sq, sk, d, seed=sq + d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jfa.flash_chunk_grads(
        *_jax((q, k, v, do), jdt), jnp.asarray(lse), jnp.asarray(delta),
        q_offset, k_offset, causal=causal, block_q=BLOCK, block_k=BLOCK,
        interpret=True)
    got = tfa.flash_chunk_grads(
        *_torch((q, k, v, do), tdt), torch.from_numpy(lse),
        torch.from_numpy(delta), q_offset, k_offset, causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        w = np.asarray(w)
        if dtype == "float32":
            assert np.all(np.abs(_np(g) - w) <= 2e-5 * (1 + np.abs(w)))
        else:
            assert np.all(np.abs(_np(g) - w)
                          <= BF16_TOL * np.maximum(1.0, np.abs(w)))
        if k_offset > q_offset + sq:
            assert not np.any(_np(g))
    assert tfa.dq_launches == tfa.dkv_launches == 0


def _cos_loss(out):
    return (out * out.cos()).sum()


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_grads_match_jax(causal):
    arrays = _qkv((B, S, H, 64), seed=9, scale=0.5)

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, block_q=BLOCK,
                                  block_k=BLOCK, interpret=True)
        return jnp.sum(out * jnp.cos(out))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*_jax(arrays, jnp.float32))
    q, k, v = (x.requires_grad_() for x in _torch(arrays, torch.float32))
    _cos_loss(tfa.flash_attention(q, k, v, causal=causal)).backward()
    for got, w in zip((q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(_np(got), np.asarray(w), rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("s_len,d", [(40, 64), (100, 16)])
def test_ragged_grads_match_jax_dense(s_len, d):
    """Any S differentiates through the flash path; the JAX flash kernel
    needs tile multiples, so the reference is jax.grad of dense."""
    arrays = _qkv((B, s_len, H, d), seed=s_len, scale=0.5)

    def jloss(q, k, v):
        out = jdense(q, k, v, causal=True)
        return jnp.sum(out * jnp.cos(out))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*_jax(arrays, jnp.float32))
    q, k, v = (x.requires_grad_() for x in _torch(arrays, torch.float32))
    _cos_loss(tfa.flash_attention(q, k, v)).backward()
    for got, w in zip((q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(_np(got), np.asarray(w), rtol=2e-4,
                                   atol=2e-5)


def test_nothing_is_saved_for_backward_under_inference_mode():
    q, k, v = _torch(_qkv((1, 64, 1, 64)), torch.float32)
    with torch.inference_mode():
        out = tfa.flash_attention(q, k, v)
    assert out.grad_fn is None


def test_chunk_grads_wrapper_rejects_what_the_kernels_do_not_take():
    q, k, v, do, lse, delta = _torch(_chunk_inputs(2, 64, 64, 64, 0),
                                     torch.float32)
    with pytest.raises(ValueError, match="dtypes"):
        tfa.flash_chunk_grads(q, k, v, do.to(torch.bfloat16), lse, delta)
    with pytest.raises(ValueError, match="float32"):
        tfa.flash_chunk_grads(q, k, v, do, lse.double(), delta)
    with pytest.raises(ValueError, match="shapes"):
        tfa.flash_chunk_grads(q, k, v, do, lse[..., 0], delta)
    with pytest.raises(ValueError, match="takes D in|kernels take D"):
        tfa.flash_chunk_grads(*(x[..., :48].contiguous()
                                for x in (q, k, v, do)), lse, delta)
    with pytest.raises(ValueError, match="tensors on cpu"):
        tfa.flash_chunk_grads_cuda(q, k, v, do, lse, delta, 0, 0, True,
                                   0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s_len,d,dtype,causal", [
    (32, 1024, 128, torch.bfloat16, True),
    (32, 1024, 128, torch.bfloat16, False),
    (32, 1024, 128, torch.float32, True),
    (8, 100, 128, torch.bfloat16, True),     # ragged last tiles
    (8, 37, 16, torch.bfloat16, False),
    (8, 130, 32, torch.float32, True),
    (8, 200, 64, torch.float32, False),
])
def test_cuda_kernel_matches_plain(bh, s_len, d, dtype, causal):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    arrays = _qkv((bh, s_len, d), seed=1)
    q, k, v = (x.to("cuda", dtype) for x in _torch(arrays, torch.float32))
    before = tfa.launches
    o, lse = tfa.flash_forward(q, k, v, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    o_ref, lse_ref = tfa.flash_forward_reference(q, k, v, causal,
                                                 d ** -0.5)
    tol = BF16_TOL if dtype == torch.bfloat16 else 2e-5
    err = (o.float() - o_ref.float()).abs()
    assert bool((err <= tol * (1 + o_ref.float().abs())).all())
    torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d,dtype,causal,q_offset", [
    (32, 1024, 1024, 128, torch.bfloat16, True, 0),
    (32, 1024, 1024, 128, torch.bfloat16, False, 0),
    (32, 1024, 1024, 128, torch.float32, True, 0),
    (8, 100, 100, 128, torch.bfloat16, True, 0),     # ragged last tiles
    (8, 37, 37, 16, torch.bfloat16, False, 0),
    (8, 130, 130, 32, torch.float32, True, 0),
    (8, 200, 200, 64, torch.float32, False, 0),
    (8, 512, 1024, 128, torch.bfloat16, True, 512),  # a ring chunk
    (64, 127, 127, 16, torch.bfloat16, True, 0),     # the zoo twin's step
])
def test_cuda_bwd_kernels_match_plain(bh, sq, sk, d, dtype, causal,
                                      q_offset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    inputs = _chunk_inputs(bh, sq, sk, d, seed=2)
    q, k, v, do = (torch.from_numpy(x).to("cuda", dtype)
                   for x in inputs[:4])
    lse, delta = (torch.from_numpy(x).cuda() for x in inputs[4:])
    before = (tfa.dq_launches, tfa.dkv_launches)
    got = tfa.flash_chunk_grads(q, k, v, do, lse, delta, q_offset, 0, causal)
    torch.cuda.synchronize()
    assert (tfa.dq_launches, tfa.dkv_launches) == (before[0] + 1,
                                                   before[1] + 1)
    want = tfa.flash_chunk_grads_reference(q, k, v, do, lse, delta,
                                           q_offset, 0, causal)
    tol = CUDA_BWD_TOL[dtype]
    for g, w in zip(got, want):
        err, size = (g - w).abs(), w.abs()
        assert bool((err <= tol["elem"] * (size + size.median())).all())
        assert (err.norm() / w.norm()).item() <= tol["l2"]
