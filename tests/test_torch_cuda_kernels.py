"""The hand-written CUDA kernels of the port against their plain PyTorch
versions, on the card: one file that imports neither jax nor
``elasticdl_tpu``, so it runs where the card is, with

    pytest --noconftest -o markers=cuda -m cuda \
        tests/test_torch_cuda_kernels.py

Each test skips inside itself when CUDA is absent, so on the CPU the
file collects and counts as before. The tests came, with their inputs
and limits, from the parity files of their modules:

- flash forward #1 (``test_cuda_kernel_matches_plain``,
  ``test_cuda_kernel_matches_tiled_plain_at_the_flagship_shape``) and
  backward #3/#4 (``test_cuda_bwd_kernels_match_plain``) from
  test_torch_flash_attention.py;
- the chunk update #2 and the ring on it
  (``test_cuda_chunk_kernel_matches_plain``,
  ``test_cuda_chunk_kernel_matches_plain_at_the_ring_past_chunk``,
  ``test_cuda_ring_matches_flash_and_raises_off_the_kernels``) from
  test_torch_ring_attention.py;
- the embedding kernels #5-#8 (``test_cuda_kernels_match_plain``) from
  test_torch_pallas_embedding.py;
- the transformer's refusal of an untemplated head dim
  (``test_cuda_attention_raises_for_an_untemplated_head_dim``) from
  test_torch_transformer.py.

Tolerances, as there: the forward at 2e-2 relative to (1 + |o|) in
bf16, 2e-5 in f32, lse at rtol 1e-4 / atol 1e-3, and folded over the
kernel's own key tiles at ``TILED_TOL``; the backward at ``CUDA_BWD_TOL``
(|g - w| <= elem * (|w| + median|w|) at every element, ||g - w|| / ||w||
<= l2); the chunk update against the plain version folded in its own
order at 2e-2 (bf16) / 2e-5 (f32) relative to (1 + |w|), against the
whole-chunk plain version at 2e-5 (f32) and at ``CHUNK_WHOLE_TOL`` (bf16;
the test derives it), and at the ring's past chunk at elem 3e-2, L2
2e-4; the lookups and row updates at rtol 1e-5 / atol 1e-6,
untouched rows bit-equal.
"""

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
)
from elasticdl_tpu_torch.ops import flash_attention as tfa
from elasticdl_tpu_torch.ops import pallas_embedding as pe
from elasticdl_tpu_torch.ops import ring_attention as tra
from elasticdl_tpu_torch.parallel import mesh as tmesh

BF16_TOL = 2e-2
CUDA_BWD_TOL = {torch.bfloat16: dict(elem=3e-2, l2=2e-4),
                torch.float32: dict(elem=2e-5, l2=1e-6)}
# chip_smoke.py's CHUNK_WHOLE_TOL["bfloat16"]: the chunk update (bf16)
# against the whole-chunk plain version (test_cuda_chunk_kernel_matches_plain
# derives it).
CHUNK_WHOLE_TOL = dict(elem=6e-2, l2=5e-3)
TILED_TOL = {torch.bfloat16: dict(elem=3e-2, l2=5e-4, lse=1e-5),
             torch.float32: dict(elem=2e-5, l2=1e-6, lse=1e-5)}
V, L = 64, 5            # the embedding kernels' table rows, ids a row
LM_VOCAB, LM_MAX_LEN = 97, 64
# (sq, sk, q_offset, k_offset, causal): the chunk kernel check's kinds.
CHUNK_CASES = {
    "diagonal": (16, 16, 16, 16, True),
    "past": (16, 16, 32, 0, True),
    "future": (16, 16, 0, 16, True),         # every key after every query
    "first_rows_masked": (16, 24, 8, 12, True),
    "ragged": (20, 37, 40, 10, True),        # Sq != Sk, not tile multiples
    "full": (16, 24, 0, 0, False),
}


def _qkv(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) * scale
            for _ in range(3)]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _np(x):
    return np.asarray(torch.as_tensor(x).float()) if isinstance(
        x, torch.Tensor) else np.asarray(x, np.float32)


def _readings(got, want):
    """elem = max |g - w| / (|w| + median|w|) and l2 = ||g - w|| / ||w||."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    elem = (err / (np.abs(want) + max(np.median(np.abs(want)), 1e-30))).max()
    return elem, np.linalg.norm(got - want) / np.linalg.norm(want)


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


def _carry(bh, sq, d, seed):
    """A carry already folded from an earlier chunk: (m, l, acc) as a
    previous update leaves them (finite m, l > 0)."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((bh, sq, 1), dtype=np.float32)
    l = rng.uniform(0.5, 3.0, (bh, sq, 1)).astype(np.float32)
    acc = rng.standard_normal((bh, sq, d), dtype=np.float32)
    return m, l, acc


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _late_out_of_range(ids):
    """Ids outside the table late in a long row, where the kernel's ring
    has been refilled (the ring holds at most 24 strips)."""
    ids[::2, -26] = V
    ids[1::2, -6] = -1
    ids[::3, -1] = V
    return ids


def _row_inputs(rule, dim=128, seed=0, n_real=6, n_pad=2):
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


# ---- flash attention: forward #1, backward #3/#4 --------------------------


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
@pytest.mark.parametrize("bh,sq,sk,d,dtype,causal,q_offset,k_offset", [
    (32, 1024, 1024, 128, torch.bfloat16, True, 0, 0),
    (32, 1024, 1024, 128, torch.bfloat16, False, 0, 0),
    (32, 1024, 1024, 128, torch.float32, True, 0, 0),
    (8, 100, 100, 128, torch.bfloat16, True, 0, 0),     # ragged last tiles
    (8, 37, 37, 16, torch.bfloat16, False, 0, 0),
    (8, 130, 130, 32, torch.float32, True, 0, 0),
    (8, 200, 200, 64, torch.float32, False, 0, 0),
    (8, 200, 200, 64, torch.bfloat16, True, 0, 0),
    (8, 512, 1024, 128, torch.bfloat16, True, 512, 0),  # a ring chunk
    (64, 127, 127, 16, torch.bfloat16, True, 0, 0),     # the zoo twin's step
    (8, 384, 512, 128, torch.bfloat16, True, 0, 0),  # keys beyond every query
    (8, 384, 512, 32, torch.bfloat16, True, 0, 0),
    (8, 384, 512, 64, torch.float32, True, 0, 0),
    (8, 384, 256, 128, torch.bfloat16, True, 0, 128),  # rows before every key
    (8, 384, 256, 32, torch.bfloat16, True, 0, 128),
    (4, 2048, 2048, 128, torch.bfloat16, True, 2048, 0),  # ring: past chunk
    (4, 2048, 2048, 128, torch.bfloat16, True, 0, 0),     # diagonal chunk
])
def test_cuda_bwd_kernels_match_plain(bh, sq, sk, d, dtype, causal,
                                      q_offset, k_offset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    inputs = _chunk_inputs(bh, sq, sk, d, seed=2)
    q, k, v, do = (torch.from_numpy(x).to("cuda", dtype)
                   for x in inputs[:4])
    lse, delta = (torch.from_numpy(x).cuda() for x in inputs[4:])
    before = (tfa.dq_launches, tfa.dkv_launches)
    got = tfa.flash_chunk_grads(q, k, v, do, lse, delta, q_offset, k_offset,
                                causal)
    torch.cuda.synchronize()
    assert (tfa.dq_launches, tfa.dkv_launches) == (before[0] + 1,
                                                   before[1] + 1)
    want = tfa.flash_chunk_grads_reference(q, k, v, do, lse, delta,
                                           q_offset, k_offset, causal)
    tol = CUDA_BWD_TOL[dtype]
    for g, w in zip(got, want):
        err, size = (g - w).abs(), w.abs()
        assert bool((err <= tol["elem"] * (size + size.median())).all())
        assert (err.norm() / w.norm()).item() <= tol["l2"]
    no_key = max(k_offset - q_offset, 0)   # dq rows that reach no key
    assert bool((got[0][:, :no_key] == 0).all())


@pytest.mark.cuda
def test_cuda_kernel_matches_tiled_plain_at_the_flagship_shape():
    """B 8 x H 4 x S 1024 x D 128, causal, bf16: the wgmma kernel against
    the plain version folded over its 128-key tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    q, k, v = (x.to("cuda", torch.bfloat16)
               for x in _torch(_qkv((32, 1024, 128), seed=4), torch.float32))
    o, lse = tfa.flash_forward(q, k, v, True)
    torch.cuda.synchronize()
    want, want_lse = tfa.flash_forward_reference(
        q, k, v, True, block_k=tfa.forward_block_k(128, torch.bfloat16))
    tol = TILED_TOL[torch.bfloat16]
    elem, l2 = _readings(_np(o.cpu()), _np(want.cpu()))
    assert elem <= tol["elem"] and l2 <= tol["l2"], (elem, l2)
    assert ((lse - want_lse).abs() / (1 + want_lse.abs())).max().item() \
        <= tol["lse"]


# ---- the chunk update #2 and the ring on it ------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_cuda_chunk_kernel_matches_plain(case, dtype):
    """The chunk update against its plain version folded in the kernel's
    own order (64-key tiles; on the bf16 D 64 route, even tiles into the
    carry and odd ones into an empty state, merged at the end), at 2e-2
    (bf16) / 2e-5 (f32) relative to (1 + |w|): the tight check of the
    kernel's arithmetic. Then against the plain version over the whole
    chunk: in f32 at the same 2e-5; in bf16 at ``CHUNK_WHOLE_TOL``.

    That limit, derived: both plain versions round every p to bf16
    (relative error at most 2^-9), the whole-chunk one as exp(s - m)
    against the row's maximum over the chunk, the own-order one against
    its state's running maximum, and the two states' maxima differ from
    the chunk's (and from each other). So each p may be rounded two ways
    and differ by up to 2^-8 relative, and acc = sum_j p_j v_j (l sums p
    in f32, unrounded) differs by sum_j d_j p_j v_j over the Sk keys,
    |d_j| <= 2^-8. The d_j are independent roundings (each the difference
    of two uniform errors of half-width 2^-9: rms 2^-9 sqrt(2/3)), so
    they add as a random walk: ||d acc|| / ||acc|| is at most about
    2^-9 sqrt(2/3) = 1.6e-3 when every p is rounded two ways and the
    carry adds nothing, and per element, with the floor median|acc| and
    the largest of 8 x 128 x 64 normal deviates (~4.4 sd), about 1e-2.
    ``CHUNK_WHOLE_TOL`` (chip_smoke.py's limit for the same comparison:
    elem 6e-2, L2 5e-3, in ``_readings``' form) sits 3-6x above those,
    and the whole-chunk reading of the own-order plain version in the
    "full" case (Sk 192, no mask) is elem 1.41e-2, L2 1.52e-3 (2.17e-2
    relative to 1 + |w| on one element of acc, past 2e-2: the reason the
    bf16 whole-chunk comparison takes this form)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    sq, sk, q_off, k_off, causal = CHUNK_CASES[case]
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((8, sq * 8, 64),
                                             dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((8, sk * 8, 64),
                                                 dtype=np.float32))
            for _ in range(2))
    args = [x.to("cuda", dtype) for x in (q, k, v)] + [
        torch.from_numpy(x).cuda() for x in _carry(8, sq * 8, 64, 5)]
    before = tfa.chunk_launches
    got = tfa.flash_chunk_update(*args, q_off * 8, k_off * 8, causal)
    torch.cuda.synchronize()
    assert tfa.chunk_launches == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    own = tfa.flash_chunk_update_reference(
        *args, q_off * 8, k_off * 8, causal,
        block_k=tfa.chunk_block_k(64, dtype),
        consumers=tfa.chunk_consumers(64, dtype))
    want = tfa.flash_chunk_update_reference(*args, q_off * 8, k_off * 8,
                                            causal)
    for g, o, w in zip(got, own, want):
        assert bool(((g - o).abs() <= tol * (1 + o.abs())).all())
        if dtype == torch.float32:
            assert bool(((g - w).abs() <= tol * (1 + w.abs())).all())
        else:
            elem, l2 = _readings(_np(g.cpu()), _np(w.cpu()))
            assert (elem <= CHUNK_WHOLE_TOL["elem"]
                    and l2 <= CHUNK_WHOLE_TOL["l2"]), (elem, l2)


@pytest.mark.cuda
def test_cuda_chunk_kernel_matches_plain_at_the_ring_past_chunk():
    """BH 4 x 2048 x 2048, D 128, bf16, a past chunk (q_offset 4096) with
    a folded carry: the wgmma kernel against the plain version folded in
    its own order, at chip_smoke.py's CHUNK_TOL (elem 3e-2, L2 2e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    q, k, v = (torch.from_numpy(x).to("cuda", torch.bfloat16)
               for x in _qkv((4, 2048, 128), seed=6, scale=1.0))
    state = [torch.from_numpy(x).cuda() for x in _carry(4, 2048, 128, 7)]
    got = tfa.flash_chunk_update(q, k, v, *state, 4096, 0, True)
    torch.cuda.synchronize()
    want = tfa.flash_chunk_update_reference(
        q, k, v, *state, 4096, 0, True,
        block_k=tfa.chunk_block_k(128, torch.bfloat16),
        consumers=tfa.chunk_consumers(128, torch.bfloat16))
    for g, w in zip(got, want):
        err = (g - w).abs()
        floor = w.abs().median()
        assert (err / (w.abs() + floor)).max().item() <= 3e-2
        assert (err.norm() / w.norm()).item() <= 2e-4


@pytest.mark.cuda
def test_cuda_ring_matches_flash_and_raises_off_the_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    mesh = tmesh.make_mesh((4,), ("sp",), [torch.device("cuda:0")] * 4)
    q, k, v = (torch.from_numpy(x).to("cuda", torch.bfloat16)
               for x in _qkv((1, 1024, 4, 128), seed=2, scale=1.0))
    before = tfa.chunk_launches
    got = tra.ring_attention(q, k, v, mesh)
    assert tfa.chunk_launches == before + 16
    want = tfa.flash_attention(q, k, v)
    err = (got.float() - want.float()).norm() / want.float().norm()
    assert err.item() <= 1e-2
    with pytest.raises(NotImplementedError, match="head dims"):
        tra.ring_attention(q, k, v, mesh, use_pallas=False)
    q48 = q[..., :48].contiguous()
    with pytest.raises(NotImplementedError, match="head dims"):
        tra.ring_attention(q48, q48, q48, mesh)


# ---- the embedding kernels #5-#8 -----------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dim,batch,num_ids,layout", [
    pytest.param(16, 37, L, "plain", id="16"),
    pytest.param(130, 37, L, "plain", id="130"),
    pytest.param(256, 37, L, "plain", id="256"),
    pytest.param(256, 37, 96, "late_out_of_range", id="L96"),
    pytest.param(256, 1, 32, "plain", id="B1"),
    pytest.param(256, 64, 32, "plain", id="B64"),
    pytest.param(4, 37, 40, "plain", id="D4"),
    pytest.param(256, 37, 32, "offset4", id="offset4"),
])
def test_cuda_kernels_match_plain(dim, batch, num_ids, layout):
    """Both lookups (and, at the first three widths, the row kernels)
    against their plain versions on the card; each lookup again through
    its C entry point into a NaN-filled output, bit-equal to the
    wrapper's. ``offset4`` views the table 4 bytes into its storage
    (#5's 4-byte instance)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    rng = np.random.RandomState(7)   # as _lookup_inputs(dim, seed=7)
    table = rng.randn(V, dim).astype(np.float32)
    ids = rng.randint(0, V, (batch, num_ids)).astype(np.int32)
    weights = rng.rand(batch, num_ids).astype(np.float32)
    if batch > 3:
        weights[2] = 0.0        # an empty row: zeros, not NaN
        weights[3, 2:] = 0.0    # a padded row
    if layout == "late_out_of_range":
        ids = _late_out_of_range(ids)
    if layout == "offset4":
        flat = torch.zeros(V * dim + 1, device="cuda")
        flat[1:] = torch.from_numpy(table.ravel()).cuda()
        t = flat[1:].view(V, dim)
        assert t.data_ptr() % 16 == 4
    else:
        t = torch.from_numpy(table).cuda()
    i, w = (x.cuda() for x in _t(ids, weights))
    lib = pe._lookup_library()
    for fn, counter in ((pe.lookup_combine_pallas, "lookup_launches"),
                        (pe.lookup_combine_aligned, "aligned_launches")):
        for combiner in ("sum", "mean", "sqrtn"):
            before = getattr(pe, counter)
            got = fn(t, i, w, combiner)
            nan_out = torch.full_like(got, float("nan"))
            err = pe._lookup_launch(lib, counter == "aligned_launches", t, i,
                                    w, nan_out, combiner)
            torch.cuda.synchronize()
            assert err == 0
            assert getattr(pe, counter) == before + 1
            want = pe.lookup_combine_reference(t, i, w, combiner)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            assert torch.equal(nan_out.view(torch.int32),
                               got.view(torch.int32))
    if layout != "plain" or num_ids != L:
        return
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


# ---- the transformer on the card -----------------------------------------


@pytest.mark.cuda
def test_cuda_attention_raises_for_an_untemplated_head_dim():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    model = TransformerLM(TransformerConfig(
        vocab_size=LM_VOCAB, d_model=96, n_heads=2, n_layers=1, d_ff=64,
        max_len=LM_MAX_LEN)).cuda().eval()
    with pytest.raises(NotImplementedError, match="head dims"):
        with torch.inference_mode():
            model(torch.zeros((1, 8), dtype=torch.long, device="cuda"))
