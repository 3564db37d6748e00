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


def test_fused_loss_waits_for_the_fused_head():
    with pytest.raises(NotImplementedError, match="fused LM head"):
        tl.fused_next_token_cross_entropy(None, None, None)


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
