"""The port's masked losses (elasticdl_tpu_torch/ops/losses.py) against
elasticdl_tpu/ops/losses.py: values and gradients on the same seeded
inputs, with partial masks and an all-zero mask (the max(Σw, 1)
denominator). f32 throughout, at rtol 1e-5 / atol 1e-6: log-space
reductions over at most 64 terms, in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import losses as jl
from elasticdl_tpu_torch.ops import losses as tl

TOL = dict(rtol=1e-5, atol=1e-6)
MASKS = {
    "full": np.ones(4, np.float32),
    "partial": np.array([1, 1, 0, 1], np.float32),
    "zero": np.zeros(4, np.float32),
}


def _inputs(name, seed):
    rng = np.random.default_rng(seed)
    if name == "next_token":
        logits = 3 * rng.standard_normal((4, 8, 64), dtype=np.float32)
        labels = rng.integers(0, 64, (4, 8)).astype(np.int32)
    elif name == "softmax":
        logits = 3 * rng.standard_normal((4, 10), dtype=np.float32)
        labels = rng.integers(0, 10, (4,)).astype(np.int32)
    else:
        logits = 4 * rng.standard_normal((4, 1), dtype=np.float32)
        labels = rng.integers(0, 2, (4,)).astype(np.int32)
    return labels, logits


PAIRS = {
    "next_token": (jl.masked_next_token_cross_entropy,
                   tl.masked_next_token_cross_entropy),
    "softmax": (jl.masked_softmax_cross_entropy,
                tl.masked_softmax_cross_entropy),
    "sigmoid": (jl.masked_sigmoid_cross_entropy,
                tl.masked_sigmoid_cross_entropy),
}


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_loss_and_grad_match_jax(name, mask):
    labels, logits = _inputs(name, seed=len(name))
    weights = MASKS[mask]
    jfn, tfn = PAIRS[name]
    want, want_grad = jax.value_and_grad(
        lambda x: jfn(jnp.asarray(labels), x, jnp.asarray(weights)))(
            jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = tfn(torch.from_numpy(labels), x, torch.from_numpy(weights))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), **TOL)
    if mask == "zero":
        assert got.item() == 0.0 and not x.grad.any()


def test_next_token_loss_takes_bf16_logits_in_f32():
    labels, logits = _inputs("next_token", seed=3)
    mask = torch.ones(4)
    x = torch.from_numpy(logits)
    got = tl.masked_next_token_cross_entropy(
        torch.from_numpy(labels), x.to(torch.bfloat16), mask)
    want = tl.masked_next_token_cross_entropy(
        torch.from_numpy(labels), x.to(torch.bfloat16).float(), mask)
    assert got.dtype == torch.float32 and got.item() == want.item()


def test_sigmoid_loss_gradient_at_zero_logits_matches_jax():
    """A logit of exactly 0 (zero biases on an empty embedding row): the
    subgradient follows jnp.maximum's split tie and jnp.abs's slope 1."""
    logits = np.array([0.0, 0.0, 1.5, -2.0], np.float32)
    labels = np.array([1, 0, 1, 0], np.int32)
    mask = np.ones(4, np.float32)
    want = jax.grad(lambda x: jl.masked_sigmoid_cross_entropy(
        jnp.asarray(labels), x, jnp.asarray(mask)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    tl.masked_sigmoid_cross_entropy(torch.from_numpy(labels), x,
                                    torch.from_numpy(mask)).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), **TOL)


# ---- the fused head's loss -------------------------------------------------
#
# tests/test_ops_losses.py's tolerances where they apply: the fused loss
# against the masked loss on the materialised logits at rtol 1e-5 /
# atol 1e-6 (:102), its gradients at rtol 1e-4 / atol 1e-6 (:129); a
# fused model against the plain one at 1e-5 for the loss, 2e-4 / 1e-5
# for the gradients (:186-190). Against JAX's fused loss on the same
# operands: f32 at TOL, the gradients at rtol 1e-4 / atol 1e-6; bf16
# hidden and kernel (the products exact in f32 on both sides, the f32
# sums in another order) at TOL for the loss, and the gradients of the
# bf16 operands, rounded to bf16 on both sides, within one bf16 step
# (rtol 2^-7) of each other.

FUSED_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _fused_inputs(seed=0, b=4, s=16, d=32, v=64):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((b, s, d), dtype=np.float32)
    kernel = (rng.standard_normal((d, v), dtype=np.float32)
              / np.float32(np.sqrt(d)))
    bias = 0.1 * rng.standard_normal((v,), dtype=np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    return hidden, kernel, bias, labels


def _jax_fused(hidden, kernel, bias, labels, mask, chunk, dtype):
    def f(h, k, b):
        return jl.fused_next_token_cross_entropy(
            jnp.asarray(labels), (h, k, b), jnp.asarray(mask),
            chunk_size=chunk)

    args = (jnp.asarray(hidden, dtype), jnp.asarray(kernel, dtype),
            jnp.asarray(bias))
    value, grads = jax.value_and_grad(f, argnums=(0, 1, 2))(*args)
    return float(value), [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_fused(hidden, kernel, bias, labels, mask, chunk, dtype):
    args = [torch.tensor(hidden).to(dtype).requires_grad_(),
            torch.tensor(kernel).to(dtype).requires_grad_(),
            torch.tensor(bias).requires_grad_()]
    loss = tl.fused_next_token_cross_entropy(
        torch.tensor(labels), tuple(args), torch.tensor(mask),
        chunk_size=chunk)
    loss.backward()
    assert [a.grad.dtype for a in args] == [dtype, dtype, torch.float32]
    return loss.item(), [a.grad.float().numpy() for a in args]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_fused_loss_matches_jax(mask, dtype):
    hidden, kernel, bias, labels = _fused_inputs()
    got, got_grads = _port_fused(hidden, kernel, bias, labels, MASKS[mask],
                                 4, getattr(torch, dtype))
    want, want_grads = _jax_fused(hidden, kernel, bias, labels,
                                  MASKS[mask], 4, getattr(jnp, dtype))
    np.testing.assert_allclose(got, want, **TOL)
    tol = FUSED_GRAD_TOL if dtype == "float32" else dict(rtol=2 ** -7,
                                                         atol=1e-6)
    for g, w, name in zip(got_grads, want_grads,
                          ("hidden", "kernel", "bias")):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}",
                                   **(FUSED_GRAD_TOL if name == "bias"
                                      else tol))
    if mask == "zero":
        assert got == 0.0


@pytest.mark.parametrize("chunk", [4, 16, 128])
def test_fused_loss_matches_the_masked_loss(chunk):
    """The port's fused loss against its masked loss on the materialised
    logits (h @ k + b), values and the gradients of hidden, kernel and
    bias; a chunk past the sequence takes the whole sequence."""
    hidden, kernel, bias, labels = _fused_inputs(seed=1)
    mask = torch.tensor(MASKS["partial"])
    outs = []
    for fused in (True, False):
        h, k, b = (torch.tensor(a).requires_grad_()
                   for a in (hidden, kernel, bias))
        if fused:
            loss = tl.fused_next_token_cross_entropy(
                torch.tensor(labels), (h, k, b), mask, chunk_size=chunk)
        else:
            loss = tl.masked_next_token_cross_entropy(
                torch.tensor(labels), h @ k + b, mask)
        loss.backward()
        outs.append((loss.item(), h.grad, k.grad, b.grad))
    np.testing.assert_allclose(outs[0][0], outs[1][0], **TOL)
    for g, w in zip(outs[0][1:], outs[1][1:]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **FUSED_GRAD_TOL)


def test_fused_loss_rejects_an_untileable_sequence():
    hidden, kernel, bias, labels = _fused_inputs(s=6)
    with pytest.raises(ValueError, match="tile"):
        tl.fused_next_token_cross_entropy(
            torch.tensor(labels), tuple(map(torch.tensor,
                                            (hidden, kernel, bias))),
            torch.ones(4), chunk_size=4)


def _lm_cfg(fused):
    return dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_len=16, fused_head=fused)


def test_fused_head_trains_like_the_plain_head():
    """A fused-head model's training output is the triple, its eval
    output the logits; the zoo loss takes the triple, and its value and
    gradients equal the plain head's (tests/test_ops_losses.py's
    TestFusedHeadModel) and JAX's fused model's."""
    from elasticdl_tpu.models.transformer import (
        TransformerConfig as JaxConfig,
        TransformerLM as JaxLM,
    )
    from model_zoo.transformer import transformer_lm as jax_zoo
    from elasticdl_tpu_torch import bridge
    from elasticdl_tpu_torch.model_zoo.transformer import (
        transformer_lm as zoo,
    )
    from elasticdl_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )

    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 64, (2, 16)).astype(np.int32)
    labels = rng.randint(0, 64, (2, 16)).astype(np.int32)
    mask = np.ones((2,), np.float32)
    jmodel = JaxLM(JaxConfig(compute_dtype=jnp.float32, **_lm_cfg(True)))
    params = jmodel.init(jax.random.PRNGKey(0), tokens)["params"]

    def jax_loss(p):
        out = jmodel.apply({"params": p}, tokens, training=True)
        return jax_zoo.loss(labels, out, mask)

    want = float(jax_loss(params))
    state = bridge.state_dict_from_flax(jax.tree.map(np.asarray, params))
    results = []
    for fused in (True, False):
        model = TransformerLM(TransformerConfig(
            compute_dtype=torch.float32, **_lm_cfg(fused)))
        model.load_state_dict(state)
        model.train()
        out = model(torch.tensor(tokens))
        assert isinstance(out, tuple) == fused
        if fused:
            hidden, kernel, bias = out
            assert tuple(hidden.shape) == (2, 16, 32)
            assert tuple(kernel.shape) == (32, 64)
            assert tuple(bias.shape) == (64,)
        loss = zoo.loss(torch.tensor(labels), out, torch.tensor(mask))
        loss.backward()
        results.append((loss.item(), {n: p.grad.clone()
                                      for n, p in model.named_parameters()}))
        model.eval()
        logits = model(torch.tensor(tokens))
        assert not isinstance(logits, tuple)
        assert tuple(logits.shape) == (2, 16, 64)
    np.testing.assert_allclose(results[0][0], results[1][0], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(results[0][0], want, rtol=1e-5, atol=1e-6)
    for name, grad in results[1][1].items():
        np.testing.assert_allclose(results[0][1][name].numpy(),
                                   grad.numpy(), rtol=2e-4, atol=1e-5,
                                   err_msg=name)
