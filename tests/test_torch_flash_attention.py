"""The port's flash attention, forward and backward, against the JAX
package's.

Inputs are made with numpy from a seed and fed to both frameworks. The
JAX side runs the Pallas kernel in interpret mode, as
tests/test_flash_attention.py does; the port's CPU side runs the plain
version (the CUDA kernel is held against it on the card, in
tests/test_torch_cuda_kernels.py and in chip_smoke.py).

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

The plain forward folded over key tiles (``block_k``) against the JAX
kernel with the same tile width (``TILED_TOL``, the limits chip_smoke.py
holds the card's kernel to): both take p against each tile's running
max and round it to bf16 there, so only an exp or an f32 sum that
differs in its last bit flips a rounding of p or o (about 2^-8 of one
element, which sets elem, and rarely, which keeps L2 small); f32 sums
over at most 128 keys in another order.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import flash_attention as jfa
from elasticdl_tpu.ops.ring_attention import dense_attention as jdense
from elasticdl_tpu_torch.ops import flash_attention as tfa
from elasticdl_tpu_torch.ops.ring_attention import dense_attention as tdense
from elasticdl_tpu_torch.tools import chunk_kernel_mutants
from elasticdl_tpu_torch.tools import flash_bwd_mutants
from elasticdl_tpu_torch.tools import flash_fwd_mutants

B, S, H = 2, 128, 2
BLOCK = 64
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = 2e-2
CUDA_BWD_TOL = {torch.bfloat16: dict(elem=3e-2, l2=2e-4),
                torch.float32: dict(elem=2e-5, l2=1e-6)}
TILED_TOL = {torch.bfloat16: dict(elem=3e-2, l2=5e-4, lse=1e-5),
             torch.float32: dict(elem=2e-5, l2=1e-6, lse=1e-5)}
CSRC = os.path.join(os.path.dirname(tfa.__file__), "csrc")


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
    (64, 128, 64, 0, 0, True),         # keys 64-127 after every query
    (192, 128, 64, 0, 64, True),       # q rows 0-63 before every key
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
    if causal:   # keys after every query: dk and dv are 0 on both sides
        beyond = k_offset + np.arange(sk) > q_offset + sq - 1
        for g, w in zip(got[1:], want[1:]):
            assert not np.any(_np(g)[:, beyond])
            assert not np.any(np.asarray(w)[:, beyond])
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


def _readings(got, want):
    """elem = max |g - w| / (|w| + median|w|) and l2 = ||g - w|| / ||w||."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    elem = (err / (np.abs(want) + max(np.median(np.abs(want)), 1e-30))).max()
    return elem, np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_k", [64, 128])
def test_tiled_reference_matches_jax_flash(block_k, dtype, causal):
    """S 256 tiles by both widths (JAX's rule, flash_attention.py:160)."""
    s_len, d = 256, 64
    arrays = _qkv((B, s_len, H, d), seed=block_k + causal)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jfa.flash_attention(*_jax(arrays, jdt), causal=causal,
                               block_q=block_k, block_k=block_k,
                               interpret=True)
    bh = [np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(
        B * H, s_len, d)) for a in arrays]
    _, want_lse = jfa._flash_forward(*_jax(bh, jdt), causal, d ** -0.5,
                                     block_k, block_k, True)
    o, lse = tfa.flash_forward_reference(*_torch(bh, tdt), causal,
                                         d ** -0.5, block_k=block_k)
    assert o.dtype == tdt and lse.dtype == torch.float32
    got = _np(o).reshape(B, H, s_len, d).transpose(0, 2, 1, 3)
    tol = TILED_TOL[tdt]
    elem, l2 = _readings(got, np.asarray(want.astype(jnp.float32)))
    assert elem <= tol["elem"] and l2 <= tol["l2"], (elem, l2)
    np.testing.assert_allclose(_np(lse), np.asarray(want_lse)[..., 0],
                               rtol=0, atol=tol["lse"])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s_len", [200, 256])
def test_tiled_reference_matches_whole_in_f32(causal, s_len):
    """Without bf16 roundings the tile width changes only the order of
    the f32 sums."""
    q, k, v = _torch(_qkv((4, s_len, 32), seed=s_len), torch.float32)
    whole = tfa.flash_forward_reference(q, k, v, causal, block_k=None)
    tiled = tfa.flash_forward_reference(q, k, v, causal, block_k=64)
    for got, want in zip(tiled, whole):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("d,dtype,block_k", [
    (128, torch.bfloat16, 128), (64, torch.bfloat16, 128),
    (32, torch.bfloat16, 64), (16, torch.bfloat16, 64),
    (128, torch.float32, 64), (16, torch.float32, 64),
])
def test_forward_block_k_follows_the_kernel_route(d, dtype, block_k):
    assert tfa.forward_block_k(d, dtype) == block_k


def _kernel_span(source, kernel):
    """[start, end) of a kernel's definition in a .cu source."""
    start = source.index(f"\n{kernel}(")
    return start, source.index("\n}\n", start)


@pytest.mark.parametrize("name", sorted(flash_fwd_mutants.MUTANTS))
def test_flash_fwd_mutant_texts_land_in_their_kernel(name):
    """Each edit's text occurs in the sound source, and its first
    occurrence (the one the tool replaces) lies in the kernel the mutant
    means."""
    with open(os.path.join(CSRC, "flash_attention_fwd.cu")) as f:
        source = f.read()
    kernel, edits = flash_fwd_mutants.MUTANTS[name]
    start, end = _kernel_span(source, kernel)
    for old, new in edits:
        assert old != new
        assert start < source.find(old) < end, (name, old)
    assert flash_fwd_mutants.mutate(source, edits) != source


@pytest.mark.parametrize("name", sorted(flash_bwd_mutants.MUTANTS))
def test_flash_bwd_mutant_texts_land_in_the_dkv_kernel(name):
    """Each edit's text occurs once in the sound source, inside the dk/dv
    kernel the mutant means."""
    with open(os.path.join(CSRC, "flash_attention_bwd.cu")) as f:
        source = f.read()
    kernel, edits = flash_bwd_mutants.MUTANTS[name]
    assert kernel.startswith("flash_bwd_dkv_")
    start, end = _kernel_span(source, kernel)
    for old, new in edits:
        assert old != new
        assert source.count(old) == 1, (name, old)
        assert start < source.find(old) < end, (name, old)
    assert flash_bwd_mutants.mutate(source, edits) != source


@pytest.mark.parametrize("name", sorted(flash_bwd_mutants.DQ_MUTANTS))
def test_flash_bwd_dq_mutant_texts_land_in_the_dq_kernel(name):
    """Each edit's text occurs once in the sound source, inside the dq
    kernel the mutant means."""
    with open(os.path.join(CSRC, "flash_attention_bwd.cu")) as f:
        source = f.read()
    kernel, edits = flash_bwd_mutants.DQ_MUTANTS[name]
    assert kernel.startswith("flash_bwd_dq_")
    start, end = _kernel_span(source, kernel)
    for old, new in edits:
        assert old != new
        assert source.count(old) == 1, (name, old)
        assert start < source.find(old) < end, (name, old)
    assert flash_bwd_mutants.mutate(source, edits) != source


@pytest.mark.parametrize("name", sorted(chunk_kernel_mutants.MUTANTS))
def test_chunk_mutant_texts_land_in_the_bf16_kernel(name):
    with open(os.path.join(CSRC, "flash_chunk_update.cu")) as f:
        source = f.read()
    start, end = _kernel_span(source, "flash_chunk_bf16_kernel")
    edits = chunk_kernel_mutants.MUTANTS[name]
    for old, new in edits:
        assert old != new
        assert start < source.find(old) < end, (name, old)
    assert chunk_kernel_mutants.mutate(source, edits) != source


@pytest.mark.parametrize("name", sorted(chunk_kernel_mutants.WGMMA_MUTANTS))
def test_chunk_wgmma_mutant_texts_land_in_the_wgmma_kernel(name):
    """Each edit's text occurs once in the sound source, inside the wgmma
    kernel (bf16 D 64 and 128)."""
    with open(os.path.join(CSRC, "flash_chunk_update.cu")) as f:
        source = f.read()
    start, end = _kernel_span(source, "flash_chunk_wgmma_kernel")
    for old, new in chunk_kernel_mutants.WGMMA_MUTANTS[name]:
        assert old != new
        assert source.count(old) == 1, (name, old)
        assert start < source.find(old) < end, (name, old)
    assert chunk_kernel_mutants.mutate(
        source, chunk_kernel_mutants.WGMMA_MUTANTS[name]) != source
