"""The port's TransformerLM forward against the JAX package's.

The JAX module is initialised with a fixed key, every parameter is then
perturbed with seeded numpy noise (so zero-initialised biases and unit
LayerNorm scales are carried across too), and the same tree goes
through ``bridge.state_dict_from_flax`` into the port. On the CPU the
JAX model takes ``dense_attention`` (its flash branch needs a TPU)
while the port takes its flash path's plain version whenever the gate
accepts the shape (head dims 16, 32, 64, 128; any length) and
``dense_attention`` otherwise (head dim 48).

Tolerances: f32 compute at rtol/atol 1e-4 (f32 sums over d_model and
d_ff terms in another order, through two blocks and the head). bf16
compute at a relative L2 error of 2e-2: both sides round to bf16 at
every product and residual add (2^-9 relative each), and the JAX dense
path also rounds the attention scores to bf16 before its f32 softmax.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    TransformerLM as JaxLM,
)
from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.ops import flash_attention as tfa
from elasticdl_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
)

V, L, F, MAX_LEN, S = 97, 2, 128, 64, 64


def _jax_model(d_model, n_heads, dtype, **extra):
    cfg = JaxConfig(vocab_size=V, d_model=d_model, n_heads=n_heads,
                    n_layers=L, d_ff=F, max_len=MAX_LEN,
                    compute_dtype=dtype, **extra)
    return JaxLM(cfg)


@functools.lru_cache(maxsize=None)
def _params(d_model, n_heads, moe_experts=0):
    """Perturbed numpy params for an architecture, built once (the tree
    is f32 whatever the compute dtype)."""
    extra = dict(moe_experts=moe_experts, moe_every=2) if moe_experts else {}
    model = _jax_model(d_model, n_heads, jnp.float32, **extra)
    tokens = np.zeros((2, S), np.int32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), tokens)["params"]
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            np.shape(x)).astype(np.float32),
        params,
    )


def _tokens(seed=1, b=2):
    return np.random.default_rng(seed).integers(
        0, V, (b, S)).astype(np.int32)


def _port(params, dtype):
    model = TransformerLM(bridge.config_from_params(params,
                                                    compute_dtype=dtype))
    model.load_state_dict(bridge.state_dict_from_flax(params))
    return model.eval()


def _port_logits(model, tokens):
    with torch.inference_mode():
        return model(torch.from_numpy(tokens)).numpy()


@pytest.mark.parametrize("d_model,n_heads,flash", [
    (128, 2, True),     # head dim 64: the flash gate accepts it
    (64, 2, True),      # head dim 32: accepted too
    (96, 2, False),     # head dim 48: dense_attention (CPU only)
])
def test_logits_match_jax_f32(monkeypatch, d_model, n_heads, flash):
    jmodel = _jax_model(d_model, n_heads, jnp.float32)
    params = _params(d_model, n_heads)
    tokens = _tokens()
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, tokens))
    calls = []
    plain = tfa.flash_forward_reference
    monkeypatch.setattr(tfa, "flash_forward_reference",
                        lambda *a: calls.append(1) or plain(*a))
    got = _port_logits(_port(params, torch.float32), tokens)
    assert got.dtype == np.float32 and got.shape == (2, S, V)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert len(calls) == (L if flash else 0)


def test_logits_match_jax_bf16():
    jmodel = _jax_model(128, 2, jnp.bfloat16)
    params = _params(128, 2)
    tokens = _tokens(seed=4)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, tokens))
    got = _port_logits(_port(params, torch.bfloat16), tokens)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-2, rel


def test_shorter_sequence_and_batch_of_one_match_jax(monkeypatch):
    jmodel = _jax_model(128, 2, jnp.float32)
    params = _params(128, 2)
    tokens = _tokens(seed=6, b=1)[:, :40]     # 40: a ragged tile
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, tokens))
    calls = []
    plain = tfa.flash_forward_reference
    monkeypatch.setattr(tfa, "flash_forward_reference",
                        lambda *a: calls.append(1) or plain(*a))
    got = _port_logits(_port(params, torch.float32), tokens)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert len(calls) == L      # the flash path, as on the card


def test_config_from_params():
    params = _params(128, 2)
    cfg = bridge.config_from_params(params)
    assert cfg == TransformerConfig(vocab_size=V, d_model=128, n_heads=2,
                                    n_layers=L, d_ff=F, max_len=MAX_LEN,
                                    compute_dtype=torch.bfloat16)
    # The variables dict around the params works too.
    assert bridge.config_from_params({"params": params}) == cfg
    state = bridge.state_dict_from_flax(params)
    assert set(state) == set(TransformerLM(cfg).state_dict())
    assert tuple(state["blocks.0.attn.query.weight"].shape) == (128, 128)
    assert tuple(state["lm_head.weight"].shape) == (V, 128)


def test_config_round_trips_through_dict():
    cfg = TransformerConfig(vocab_size=V, compute_dtype=torch.float32)
    assert TransformerConfig.from_dict(cfg.to_dict()) == cfg


def test_init_flax_params_has_the_flax_layout():
    params = _params(128, 2)
    want = jax.tree.map(np.shape, params)
    cfg = bridge.config_from_params(params)
    got = jax.tree.map(np.shape, bridge.init_flax_params(cfg, seed=0))
    assert got == want


def test_moe_params_are_recognised_and_refused():
    params = _params(128, 2, moe_experts=2)
    assert bridge.config_from_params(params).moe_experts == 2
    with pytest.raises(NotImplementedError, match="MoE"):
        bridge.state_dict_from_flax(params)


@pytest.mark.parametrize("kwargs,flag,match", [
    (dict(moe_experts=4), {}, "MoE"),
    (dict(fused_head=True), {}, "fused LM head"),
    ({}, dict(decode=True), "decode"),
])
def test_unported_options_raise(kwargs, flag, match):
    cfg = TransformerConfig(vocab_size=V, **kwargs)
    with pytest.raises(NotImplementedError, match=match):
        TransformerLM(cfg, **flag)


@pytest.mark.parametrize("tokens,match", [
    (np.full((1, 8), V, np.int64), "token ids"),
    (np.full((1, 8), -1, np.int64), "token ids"),
    (np.zeros((1, MAX_LEN + 1), np.int64), "max_len"),
    (np.zeros((8,), np.int64), "batch, seq"),
])
def test_bad_tokens_raise_value_error(tokens, match):
    model = TransformerLM(TransformerConfig(
        vocab_size=V, d_model=64, n_heads=2, n_layers=1, d_ff=64,
        max_len=MAX_LEN, compute_dtype=torch.float32))
    with pytest.raises(ValueError, match=match):
        model(torch.from_numpy(tokens))


def test_zoo_twin_builds_on_cpu_and_needs_cuda_otherwise():
    from elasticdl_tpu_torch.core.model_spec import load_model_zoo_module
    from elasticdl_tpu_torch.serving.export import __file__ as export_file

    import os

    zoo = os.path.join(os.path.dirname(os.path.dirname(export_file)),
                       "model_zoo")
    module, fn = load_model_zoo_module(
        zoo, "transformer.transformer_lm.custom_model")
    model = getattr(module, fn)(device="cpu")
    assert isinstance(model, TransformerLM)
    with torch.inference_mode():
        out = model(torch.zeros((1, 16), dtype=torch.long))
    assert out.shape == (1, 16, module.CONFIG.vocab_size)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(module, fn)()


@pytest.mark.cuda
def test_cuda_attention_raises_for_an_untemplated_head_dim():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    model = TransformerLM(TransformerConfig(
        vocab_size=V, d_model=96, n_heads=2, n_layers=1, d_ff=64,
        max_len=MAX_LEN)).cuda().eval()
    with pytest.raises(NotImplementedError, match="head dims"):
        with torch.inference_mode():
            model(torch.zeros((1, 8), dtype=torch.long, device="cuda"))


# ---- training: gradients, dropout, remat -------------------------------

def _jax_grads(jmodel, params, tokens, labels, mask):
    from elasticdl_tpu.ops.losses import masked_next_token_cross_entropy

    def loss(p):
        logits = jmodel.apply({"params": p}, tokens, training=True)
        return masked_next_token_cross_entropy(labels, logits, mask)

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), bridge.state_dict_from_flax(
        jax.tree.map(np.asarray, grads))


def _port_grads(model, tokens, labels, mask):
    from elasticdl_tpu_torch.ops.losses import (
        masked_next_token_cross_entropy,
    )

    model.train()
    model.zero_grad(set_to_none=True)
    loss = masked_next_token_cross_entropy(
        torch.from_numpy(labels), model(torch.from_numpy(tokens)),
        torch.from_numpy(mask))
    loss.backward()
    return loss.item(), {name: p.grad for name, p in
                         model.named_parameters()}


def _lm_batch(seed):
    tokens = _tokens(seed=seed)
    labels = _tokens(seed=seed + 1)
    mask = np.array([1.0, 0.0], np.float32)     # a padded row
    return tokens, labels, mask


def test_whole_model_grads_match_jax_f32():
    """f32 at rtol 1e-4 / atol 2e-6, near the logits' 1e-4: the JAX side
    differentiates dense_attention, the port its flash plain path, so
    the f32 sums run in another order through two blocks and back."""
    jmodel = _jax_model(128, 2, jnp.float32)
    params = _params(128, 2)
    tokens, labels, mask = _lm_batch(7)
    want_loss, want = _jax_grads(jmodel, params, tokens, labels, mask)
    got_loss, got = _port_grads(_port(params, torch.float32), tokens,
                                labels, mask)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=2e-6, err_msg=name)


def test_whole_model_grads_match_jax_bf16():
    """bf16: relative L2 error per parameter under 5e-2. Both sides round
    to bf16 at every product and residual add, the JAX dense path also
    rounds its scores; the backward adds as many rounding points again.
    The key bias's true gradient is zero (a bias added to every key of a
    row shifts its scores alike, which the softmax ignores), so both
    sides give rounding noise there: it is held to a bound relative to
    the key kernel's gradient instead."""
    jmodel = _jax_model(128, 2, jnp.bfloat16)
    params = _params(128, 2)
    tokens, labels, mask = _lm_batch(8)
    want_loss, want = _jax_grads(jmodel, params, tokens, labels, mask)
    got_loss, got = _port_grads(_port(params, torch.bfloat16), tokens,
                                labels, mask)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-2)
    for name in want:
        w, g = want[name].numpy(), got[name].float().numpy()
        if name.endswith("attn.key.bias"):
            ref = np.linalg.norm(want[name[:-4] + "weight"].numpy())
            assert max(np.linalg.norm(g), np.linalg.norm(w)) < 1e-2 * ref
            continue
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert rel < 5e-2, (name, rel)


def _dropout_model(rate, remat=False):
    cfg = TransformerConfig(vocab_size=V, d_model=64, n_heads=2,
                            n_layers=L, d_ff=F, max_len=MAX_LEN,
                            dropout_rate=rate, remat=remat,
                            compute_dtype=torch.float32)
    model = TransformerLM(cfg)
    model.load_state_dict(bridge.state_dict_from_flax(
        bridge.init_flax_params(cfg, seed=0)))
    return model


def test_dropout_keep_share_scale_and_seed():
    from elasticdl_tpu_torch.models.transformer import dropout

    x = torch.ones(200, 500)
    out = dropout(x, 0.3, torch.Generator().manual_seed(1))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    torch.testing.assert_close(out[kept], torch.full_like(out[kept],
                                                          1 / 0.7))
    again = dropout(x, 0.3, torch.Generator().manual_seed(1))
    assert torch.equal(out, again)
    other = dropout(x, 0.3, torch.Generator().manual_seed(2))
    assert not torch.equal(out, other)


def test_dropout_is_off_in_eval_and_at_rate_zero():
    tokens = torch.from_numpy(_tokens(seed=2))
    model = _dropout_model(0.5)
    with torch.no_grad():
        plain = _dropout_model(0.0)(tokens)
        assert torch.equal(model.eval()(tokens), plain)
        train0 = _dropout_model(0.0).train()(
            tokens, generator=torch.Generator().manual_seed(0))
        torch.testing.assert_close(train0, plain)
        a = model.train()(tokens, generator=torch.Generator().manual_seed(3))
        b = model.train()(tokens, generator=torch.Generator().manual_seed(3))
        assert torch.equal(a, b) and not torch.allclose(a, plain)
    with pytest.raises(ValueError, match="generator"):
        model.train()(tokens)


def test_remat_with_dropout_gives_the_same_grads():
    tokens, labels, mask = _lm_batch(9)
    grads = []
    for remat in (False, True):
        model = _dropout_model(0.2, remat=remat).train()
        from elasticdl_tpu_torch.ops.losses import (
            masked_next_token_cross_entropy,
        )

        logits = model(torch.from_numpy(tokens),
                       generator=torch.Generator().manual_seed(5))
        masked_next_token_cross_entropy(
            torch.from_numpy(labels), logits,
            torch.from_numpy(mask)).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name],
                                   rtol=1e-6, atol=1e-7)
