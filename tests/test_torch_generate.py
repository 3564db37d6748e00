"""KV-cache decoding and ``generate`` (elasticdl_tpu_torch/models/
transformer.py) against the JAX package's ``generate``
(elasticdl_tpu/models/transformer.py:488-566) and the port's own full
forward.

Weights start equal: the JAX model's initial params, perturbed with
seeded numpy noise, carried across with ``bridge``. f32 compute
throughout. Greedy tokens are held EQUAL to JAX's: both decode through
dense attention over the (B, max_len, H, D) cache, the same math in
f32, and a seeded random model leaves the top two logits of a step far
apart (the tests read the smallest gap on the full forward and require
it above 1e-4, ten times the f32 logits' error). Decode logits against the full
forward at rtol/atol 1e-4 (tests/test_torch_transformer.py's f32
logits: the same sums over the cache in another order).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    TransformerLM as JaxLM,
    generate as jax_generate,
)
from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.models.transformer import (
    KVCache,
    TransformerConfig,
    TransformerLM,
    generate,
)

V = 32


def _jax_cfg(**extra):
    return JaxConfig(vocab_size=V, d_model=32, n_heads=4, n_layers=2,
                     d_ff=64, max_len=32, compute_dtype=jnp.float32,
                     **extra)


def _port_cfg(jcfg):
    raw = dataclasses.asdict(jcfg)
    raw["compute_dtype"] = torch.float32
    return TransformerConfig(**raw)


def _params(jcfg, seed=0):
    prompt = np.zeros((2, 4), np.int32)
    params = JaxLM(jcfg).init({"params": jax.random.PRNGKey(seed)}, prompt,
                              training=False)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.3 * rng.standard_normal(
            np.shape(x)).astype(np.float32), params)


def _model(jcfg, params):
    model = TransformerLM(_port_cfg(jcfg))
    model.load_state_dict(bridge.state_dict_from_flax(params))
    return model


def _prompt(seed=0, b=2, p=4):
    return np.random.RandomState(seed).randint(0, V, (b, p)).astype(
        np.int32)


def _smallest_top2_gap(model, tokens, start):
    """The smallest gap between the two largest logits at the positions
    from ``start`` on (those that chose the generated tokens)."""
    with torch.no_grad():
        logits = model.eval()(torch.tensor(tokens))[:, start:]
    top2 = logits.topk(2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


@pytest.mark.parametrize("extra", [
    {},
    dict(moe_experts=4, moe_every=2, moe_dispatch="scatter"),
    dict(moe_experts=4, moe_every=1, moe_top_k=2, moe_dispatch="dense"),
], ids=["dense_mlp", "scatter_moe", "dense_moe_top2"])
def test_greedy_generate_matches_jax(extra):
    """Token for token, f32: a plain model, a scatter-MoE model (JAX's
    tests/test_transformer.py::test_generate_with_scatter_moe: the
    prefill scatters, single-token steps take the dense dispatch) and a
    top-2 dense MoE."""
    jcfg = _jax_cfg(**extra)
    params = _params(jcfg)
    prompt = _prompt()
    want = np.asarray(jax_generate(jcfg, params, prompt, max_new_tokens=12))
    model = _model(jcfg, params)
    got = generate(_port_cfg(jcfg), model, prompt, max_new_tokens=12)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 12)
    full = np.concatenate([prompt, want], axis=1)[:, :-1]
    assert _smallest_top2_gap(model, full, prompt.shape[1] - 1) > 1e-4
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_and_dense_configs_generate_the_same_tokens():
    """JAX's own check on the port: with a drop-free capacity factor the
    scatter model's prefill equals the dense one, and decode steps are
    dense, so the tokens are identical; ``cfg`` decides the dispatch
    over the same weights (a decoder is built for it)."""
    jcfg = _jax_cfg(moe_experts=4, moe_every=2, moe_dispatch="scatter")
    params = _params(jcfg, seed=1)
    model = _model(jcfg, params)
    prompt = _prompt(seed=1)
    safe = generate(dataclasses.replace(_port_cfg(jcfg),
                                        moe_capacity_factor=8.0),
                    model, prompt, 6)
    dense = generate(dataclasses.replace(_port_cfg(jcfg),
                                         moe_dispatch="dense"),
                     model, prompt, 6)
    np.testing.assert_array_equal(safe.numpy(), dense.numpy())


def test_decode_logits_match_the_full_forward():
    """A prefill and single-token steps through the cache give the full
    forward's logits at every position; the fill index moves by the
    tokens fed."""
    jcfg = _jax_cfg()
    model = _model(jcfg, _params(jcfg, seed=2)).eval()
    tokens = torch.tensor(_prompt(seed=2, p=10))
    with torch.no_grad():
        full = model(tokens)
        cache = KVCache(model.cfg, 2, "cpu")
        parts = [model(tokens[:, :6], cache=cache)]
        assert cache.index == 6
        for i in range(6, 10):
            parts.append(model(tokens[:, i:i + 1], cache=cache))
    assert cache.index == 10
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_overflow_errors():
    jcfg = _jax_cfg()
    model = _model(jcfg, _params(jcfg))
    cfg = _port_cfg(jcfg)
    with pytest.raises(ValueError, match="max_new_tokens"):
        generate(cfg, model, _prompt(), 0)
    with pytest.raises(ValueError, match="exceeds max_len"):
        generate(cfg, model, _prompt(p=20), 13)
    # The cache refuses a write past its end before it writes.
    cache = KVCache(cfg, 2, "cpu")
    with torch.no_grad():
        model.eval()(torch.tensor(_prompt(p=30)), cache=cache)
        before = [k.clone() for k in cache.k]
        with pytest.raises(ValueError, match="KV cache"):
            model(torch.tensor(_prompt(p=3)), cache=cache)
    assert all(torch.equal(a, b) for a, b in zip(before, cache.k))
    with pytest.raises(ValueError, match="token ids"):
        generate(cfg, model, np.full((1, 4), V), 2)


def test_sampling_shape_range_and_seed():
    """Temperature > 0 draws from softmax(logits / T) with the caller's
    generator: in range, the same seed gives the same tokens, another
    seed others; a train state decodes as its model."""
    from elasticdl_tpu_torch.core.train_state import TrainState

    jcfg = _jax_cfg()
    model = _model(jcfg, _params(jcfg, seed=3))
    cfg = _port_cfg(jcfg)
    prompt = _prompt(seed=3)

    def draw(seed, source=model):
        return generate(cfg, source, prompt, 16, temperature=1.5,
                        generator=torch.Generator().manual_seed(seed))

    a = draw(0)
    assert tuple(a.shape) == (2, 16)
    assert int(a.min()) >= 0 and int(a.max()) < V
    assert torch.equal(a, draw(0))
    assert not torch.equal(a, draw(1))
    state = TrainState(model=model, optimizer=None, generator=None)
    assert torch.equal(a, draw(0, state))
    greedy = generate(cfg, model, prompt, 16)
    assert not torch.equal(a, greedy)
    assert model.training == TransformerLM(cfg).training


def test_zoo_generate_text():
    """The zoo twin's ``generate_text`` (model_zoo/transformer/
    transformer_lm.py:44) on its CONFIG: greedy tokens equal JAX's zoo
    function's from the same weights."""
    import importlib.util

    from elasticdl_tpu_torch.model_zoo.transformer import (
        transformer_lm as zoo,
    )

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "model_zoo", "transformer",
        "transformer_lm.py")
    spec = importlib.util.spec_from_file_location("jax_zoo_lm", path)
    jax_zoo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_zoo)
    jcfg = dataclasses.replace(jax_zoo.CONFIG, compute_dtype=jnp.float32)
    params = _params(jcfg, seed=4)
    prompt = np.random.RandomState(4).randint(0, 256, (2, 5)).astype(
        np.int32)
    want = np.asarray(jax_zoo.generate_text(params, prompt, 8,
                                            config=jcfg))
    cfg = dataclasses.replace(zoo.CONFIG, compute_dtype=torch.float32)
    model = zoo.custom_model(config=cfg, device="cpu")
    model.load_state_dict(bridge.state_dict_from_flax(params))
    got = zoo.generate_text(model, prompt, 8, config=cfg)
    np.testing.assert_array_equal(got.numpy(), want)


def test_package_exports_resolve_without_jax():
    """``elasticdl_tpu_torch``'s lazy names (those of
    elasticdl_tpu/__init__.py:30-50 with a counterpart, ``generate``
    among them) resolve in a process that never imports jax."""
    import subprocess
    import sys

    code = (
        "import sys, elasticdl_tpu_torch as p\n"
        "names = ['TransformerLM', 'TransformerConfig', 'generate', "
        "'MeshRunner', 'make_mesh', 'TrainState', 'get_model_spec', "
        "'ModelSpec', 'LocalExecutor', 'flash_attention']\n"
        "assert sorted(names) == sorted(p._LAZY), sorted(p._LAZY)\n"
        "for n in names:\n"
        "    assert callable(getattr(p, n)), n\n"
        "assert p.generate.__module__ == "
        "'elasticdl_tpu_torch.models.transformer'\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'elasticdl_tpu.')) or m == 'elasticdl_tpu']\n"
        "assert not bad, bad\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = repo
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
