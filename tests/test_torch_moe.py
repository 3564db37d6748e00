"""The port's mixture of experts (elasticdl_tpu_torch/models/transformer.py
``MoE``) against the JAX package's (elasticdl_tpu/models/transformer.py
:213-352): the layer alone, a whole model with MoE blocks through
``bridge``, remat, the bridge's MoE map, and a JAX MoE bundle served by
the port.

The JAX layer is initialised with a fixed key and its params carried
across (the router's kernel transposed, the experts in flax's layout).
Both sides route the same f32 inputs through a strict-f32 router, so
the routing decisions (expert ids and keep masks) are held EQUAL: a
near-tie that routes differently would change a token's expert, and
random f32 gates make one improbable (no test relies on a tie).

Tolerances:
- f32 layer: forward rtol 1e-5 / atol 1e-6; the gradients of the router,
  ``wi``, ``wo`` and the input rtol 1e-4 / atol 1e-6 (sums over d, F and
  the tokens of an expert in another order);
- bf16 layer: a relative L2 error of 2e-2 per output and gradient, as
  the whole-model bf16 parity in ROADMAP: both sides round at every
  product, and the scatter's gather and the dense combine round the
  gate-weighted rows to bf16;
- whole f32 model: logits rtol/atol 1e-4 (tests/test_torch_transformer
  .py), the loss rtol 1e-5, gradients rtol 1e-4 / atol 2e-6;
- remat: the same gradients as without it to rtol 1e-6 / atol 1e-7 (the
  same operations; the recompute routes every token as the forward).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.models.transformer import (
    MoE as JaxMoE,
    TransformerConfig as JaxConfig,
    TransformerLM as JaxLM,
)
from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.models.transformer import (
    MoE,
    TransformerConfig,
    TransformerLM,
    capacity,
    capacity_slots,
)
from elasticdl_tpu_torch.ops.losses import masked_next_token_cross_entropy

E, D, F = 4, 32, 64
F32 = dict(rtol=1e-5, atol=1e-6)
F32_GRAD = dict(rtol=1e-4, atol=1e-6)
BF16_L2 = 2e-2


def _jax_cfg(dispatch, k, cf, dtype=jnp.float32, **extra):
    return JaxConfig(vocab_size=32, d_model=D, n_heads=4, n_layers=2,
                     d_ff=F, max_len=32, moe_experts=E, moe_top_k=k,
                     moe_dispatch=dispatch, moe_capacity_factor=cf,
                     compute_dtype=dtype, **extra)


def _port_cfg(jcfg):
    raw = dataclasses.asdict(jcfg)
    raw["compute_dtype"] = getattr(torch, jnp.dtype(jcfg.compute_dtype).name)
    return TransformerConfig(**raw)


def _moe_state(params):
    return {"router.weight": torch.tensor(np.asarray(
                params["router"]["kernel"]).T.copy()),
            "router.bias": torch.tensor(np.asarray(params["router"]["bias"])),
            "wi": torch.tensor(np.asarray(params["wi"])),
            "wo": torch.tensor(np.asarray(params["wo"]))}


def _x(seed=0, b=2, s=8):
    return np.random.default_rng(seed).standard_normal(
        (b, s, D)).astype(np.float32)


def _jax_keep(params, x, k, cap):
    """JAX's routing and keep mask (transformer.py:230-241, :315-328) on
    the f32 input."""
    gates = jax.nn.softmax(jnp.asarray(x) @ params["router"]["kernel"]
                           + params["router"]["bias"], axis=-1)
    _, top_idx = jax.lax.top_k(gates, k)
    t = x.shape[0] * x.shape[1]
    onehot = jax.nn.one_hot(top_idx.reshape(t, k), E, dtype=jnp.int32)
    flat = onehot.reshape(t * k, E)
    pos = ((jnp.cumsum(flat, axis=0) - 1) * flat).sum(-1).reshape(t, k)
    return (np.asarray(top_idx).reshape(t, k), np.asarray(pos < cap))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


CASES = [("dense", k, 1.25, dt) for k in (1, 2) for dt in ("f32", "bf16")]
CASES += [("scatter", k, cf, dt) for k in (1, 2) for cf in (100.0, 0.25)
          for dt in ("f32", "bf16")]


@pytest.mark.parametrize("dispatch,k,cf,dt", CASES)
def test_moe_layer_matches_jax(dispatch, k, cf, dt):
    """Forward, keep mask and the gradients of router, wi, wo and the
    input, dense and scatter, top-1 and top-2, drop-free (cf 100) and
    dropping (cf 0.25), f32 and bf16 compute."""
    jdtype = jnp.float32 if dt == "f32" else jnp.bfloat16
    jcfg = _jax_cfg(dispatch, k, cf, jdtype)
    x = _x()
    variables = JaxMoE(jcfg).init({"params": jax.random.PRNGKey(0)},
                                  jnp.asarray(x))
    params = variables["params"]
    cot = np.random.default_rng(1).standard_normal(x.shape).astype(
        np.float32)

    def jax_f(p, xx):
        out = JaxMoE(jcfg).apply({"params": p}, xx)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, want), (gp, gx) = jax.value_and_grad(
        jax_f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    layer = MoE(_port_cfg(jcfg))
    layer.load_state_dict(_moe_state(params))
    xt = torch.tensor(x).requires_grad_()
    got = layer(xt)
    (got.float() * torch.tensor(cot)).sum().backward()
    pairs = [("out", got.detach().float().numpy(),
              np.asarray(want.astype(jnp.float32))),
             ("x", xt.grad.numpy(), np.asarray(gx)),
             ("router.weight", layer.router.weight.grad.numpy(),
              np.asarray(gp["router"]["kernel"]).T),
             ("router.bias", layer.router.bias.grad.numpy(),
              np.asarray(gp["router"]["bias"])),
             ("wi", layer.wi.grad.numpy(), np.asarray(gp["wi"])),
             ("wo", layer.wo.grad.numpy(), np.asarray(gp["wo"]))]
    for name, g, w in pairs:
        if dt == "f32":
            tol = F32 if name == "out" else F32_GRAD
            np.testing.assert_allclose(g, w, err_msg=name, **tol)
        else:
            assert _rel_l2(g, w) < BF16_L2, (name, _rel_l2(g, w))
    if dispatch == "scatter":
        cap = capacity(x.shape[0] * x.shape[1], k, E, cf)
        want_idx, want_keep = _jax_keep(params, x, k, cap)
        top_idx, _ = layer.route(torch.tensor(x))
        _, keep = capacity_slots(top_idx, E, cap)
        t = x.shape[0] * x.shape[1]
        assert np.array_equal(top_idx.reshape(t, k).numpy(), want_idx)
        assert np.array_equal(keep.reshape(t, k).numpy(), want_keep)
        dropped = int((~want_keep).sum())
        assert int(layer.dropped) == dropped and layer.choices == t * k
        assert (dropped > 0) == (cf < 1)


def test_scatter_equals_dense_when_drop_free():
    """tests/test_transformer.py:255's case on the port: with C >= T the
    scatter dispatch drops nothing and equals the dense one."""
    x = torch.tensor(_x(seed=3))
    for k in (1, 2):
        jcfg = _jax_cfg("dense", k, 1.25)
        params = JaxMoE(jcfg).init({"params": jax.random.PRNGKey(0)},
                                   jnp.asarray(_x(seed=3)))["params"]
        outs = []
        for dispatch, cf in (("dense", 1.25), ("scatter", 100.0)):
            layer = MoE(_port_cfg(dataclasses.replace(
                jcfg, moe_dispatch=dispatch, moe_capacity_factor=cf)))
            layer.load_state_dict(_moe_state(params))
            outs.append(layer(x).detach())
        torch.testing.assert_close(outs[1], outs[0], **F32)


def test_capacity_slots_rank_token_major():
    """Ranks count every choice of a token before the next token's (JAX
    flattens (T, k, E) to (T·k, E) before its cumsum): token 0 chose
    (1, 0), token 1 (0, 1); at C 1 token 1's choices are both dropped;
    offsets shift every rank by the choices before the rows."""
    top_idx = torch.tensor([[[1, 0], [0, 1]]])
    pos, keep = capacity_slots(top_idx, 2, 1)
    assert pos.tolist() == [[[0, 0], [1, 1]]]
    assert keep.tolist() == [[[True, True], [False, False]]]
    pos, keep = capacity_slots(top_idx, 2, 2, offsets=torch.tensor([[1, 0]]))
    assert pos.tolist() == [[[0, 1], [2, 1]]]
    assert keep.tolist() == [[[True, True], [False, True]]]
    # Two rows, no offsets given: row 1 ranks after row 0's choices.
    pos, _ = capacity_slots(torch.tensor([[[0]], [[0]]]), 2, 2)
    assert pos.tolist() == [[[0]], [[1]]]
    assert capacity(16, 1, 4, 1.25) == 5 and capacity(16, 2, 4, 100.0) == 16
    assert capacity(2, 1, 8, 0.01) == 1


def test_moe_dispatch_validated():
    cfg = _port_cfg(_jax_cfg("gshard", 1, 1.25))
    with pytest.raises(ValueError, match="moe_dispatch"):
        MoE(cfg)
    with pytest.raises(ValueError, match="moe_dispatch"):
        TransformerLM(dataclasses.replace(cfg, moe_every=1))


# ---- a whole model --------------------------------------------------------


def _lm_params(jcfg, seed=0):
    """Perturbed numpy params of the JAX model (zero biases and unit
    LayerNorm scales carried across too)."""
    tokens = np.zeros((2, 16), np.int32)
    params = jax.jit(JaxLM(jcfg).init)(jax.random.PRNGKey(seed),
                                       tokens)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            np.shape(x)).astype(np.float32), params)


def _port_model(jcfg, params, **changes):
    model = TransformerLM(dataclasses.replace(_port_cfg(jcfg), **changes))
    model.load_state_dict(bridge.state_dict_from_flax(params))
    return model


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 32, (4, 16)).astype(np.int32),
            rng.integers(0, 32, (4, 16)).astype(np.int32),
            np.array([1, 1, 0, 1], np.float32))


@pytest.mark.parametrize("dispatch,cf", [("dense", 1.25), ("scatter", 1.0)])
def test_model_with_moe_blocks_matches_jax(dispatch, cf):
    """Logits, loss and every gradient of a 2-layer model whose second
    block is MoE (moe_every 2), f32, against JAX from the same params."""
    jcfg = _jax_cfg(dispatch, 1, cf, moe_every=2)
    params = _lm_params(jcfg)
    tokens, labels, mask = _batch(2)
    jmodel = JaxLM(jcfg)

    def jax_loss(p):
        from elasticdl_tpu.ops import masked_next_token_cross_entropy as jl

        logits = jmodel.apply({"params": p}, jnp.asarray(tokens),
                              training=True)
        return jl(jnp.asarray(labels), logits, jnp.asarray(mask)), logits

    (want_loss, want_logits), want = jax.value_and_grad(
        jax_loss, has_aux=True)(params)
    want = bridge.state_dict_from_flax(jax.tree.map(np.asarray, want))
    model = _port_model(jcfg, params).train()
    assert hasattr(model.blocks[1], "moe") and hasattr(model.blocks[0],
                                                       "mlp")
    logits = model(torch.tensor(tokens))
    loss = masked_next_token_cross_entropy(torch.tensor(labels), logits,
                                           torch.tensor(mask))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(grads[name].numpy(), w.numpy(),
                                   rtol=1e-4, atol=2e-6, err_msg=name)


def test_remat_with_moe_gives_the_same_grads():
    """Each block recomputed in the backward routes every token as the
    forward did (scatter at a capacity that drops, with dropout)."""
    jcfg = _jax_cfg("scatter", 2, 0.5, moe_every=1)
    params = _lm_params(jcfg, seed=1)
    tokens, labels, mask = _batch(3)
    grads, dropped = [], []
    for remat in (False, True):
        model = _port_model(jcfg, params, remat=remat,
                            dropout_rate=0.1).train()
        logits = model(torch.tensor(tokens),
                       generator=torch.Generator().manual_seed(4))
        masked_next_token_cross_entropy(
            torch.tensor(labels), logits, torch.tensor(mask)).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
        dropped.append([int(b.moe.dropped) for b in model.blocks])
    assert dropped[0] == dropped[1] and min(dropped[0]) > 0
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name],
                                   rtol=1e-6, atol=1e-7, msg=name)


# ---- bridge -----------------------------------------------------------------


def test_bridge_infers_moe_every_and_needs_the_routing_options():
    jcfg = _jax_cfg("scatter", 2, 0.5, moe_every=2)
    jcfg = dataclasses.replace(jcfg, n_layers=4)
    params = _lm_params(jcfg)
    with pytest.raises(ValueError) as err:
        bridge.config_from_params(params)
    for name in ("moe_top_k", "moe_dispatch", "moe_capacity_factor"):
        assert name in str(err.value)
    cfg = bridge.config_from_params(
        params, compute_dtype=torch.float32, moe_top_k=2,
        moe_dispatch="scatter", moe_capacity_factor=0.5)
    assert cfg == _port_cfg(jcfg)
    state = bridge.state_dict_from_flax(params)
    assert set(state) == set(TransformerLM(cfg).state_dict())
    assert tuple(state["blocks.1.moe.wi"].shape) == (E, D, F)
    assert tuple(state["blocks.3.moe.router.weight"].shape) == (E, D)
    assert "blocks.0.mlp.wi.weight" in state
    # init_flax_params draws the MoE blocks in flax's layout.
    want = jax.tree.map(np.shape, params)
    assert jax.tree.map(np.shape, bridge.init_flax_params(cfg)) == want


# ---- serving ---------------------------------------------------------------

ZOO_MODULE = """
import torch

from elasticdl_tpu_torch.model_zoo.transformer import transformer_lm as twin
from elasticdl_tpu_torch.model_zoo.transformer.transformer_lm import (
    dataset_fn, eval_metrics_fn, loss, optimizer)
from elasticdl_tpu_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(vocab_size=32, d_model=32, n_heads=4, n_layers=2,
                           d_ff=64, max_len=32, moe_experts=4, moe_top_k=2,
                           moe_every=2, moe_dispatch="scatter",
                           moe_capacity_factor=0.5,
                           compute_dtype=torch.float32)


def custom_model(device=None, mesh=None):
    return twin.custom_model(config=CONFIG, device=device, mesh=mesh)
"""


def test_jax_moe_bundle_served_by_the_port(tmp_path):
    """A JAX bundle of an MoE transformer: its routing options come from
    the ``--model_zoo`` twin its ``model_def`` names, and its answers
    equal the port's forward with the same weights; without a twin the
    loader names the options the params do not record."""
    import optax

    from elasticdl_tpu.core.train_state import init_train_state
    from elasticdl_tpu.serving import export as jax_export
    from elasticdl_tpu_torch.core.model_spec import get_model_spec
    from elasticdl_tpu_torch.serving import export as port_export

    jcfg = _jax_cfg("scatter", 2, 0.5, moe_every=2)
    jmodel = JaxLM(jcfg)
    batch = {"features": np.zeros((2, 16), np.int32),
             "labels": np.zeros((2, 16), np.int32),
             "mask": np.ones((2,), np.float32)}
    state = init_train_state(jmodel, optax.sgd(0.1), batch, seed=0)
    bundle = str(tmp_path / "v1")
    jax_export.export_serving_bundle(bundle, jmodel, state,
                                     batch_example=batch,
                                     model_def="moe_zoo.lm.custom_model")
    zoo = tmp_path / "zoo"
    (zoo / "moe_zoo").mkdir(parents=True)
    (zoo / "moe_zoo" / "lm.py").write_text(ZOO_MODULE)
    spec = get_model_spec(str(zoo), "moe_zoo.lm.custom_model", device="cpu")
    with open(os.path.join(bundle, "metadata.json")) as f:
        assert json.load(f)["model_def"] == "moe_zoo.lm.custom_model"
    predict = port_export.load_predictor(bundle, device="cpu",
                                         model_fn=spec.make_model)
    tokens = np.random.default_rng(5).integers(0, 32, (3, 16)).astype(
        np.int32)
    params = jax.tree.map(np.asarray, state.params)
    model = _port_model(jcfg, params).eval()
    with torch.no_grad():
        want = model(torch.tensor(tokens)).numpy()
    np.testing.assert_array_equal(np.asarray(predict(tokens)), want)
    with pytest.raises(ValueError, match="moe_top_k"):
        port_export.load_predictor(bundle, device="cpu")
    # The port's own export records the routing options in model_config:
    # its bundle loads with no twin and answers as the model.
    port_bundle = str(tmp_path / "port" / "v1")
    port_export.export_serving_bundle(port_bundle, model,
                                      batch_example=tokens[:1], version=1)
    with open(os.path.join(port_bundle, "metadata.json")) as f:
        recorded = json.load(f)["model_config"]
    assert (recorded["moe_top_k"], recorded["moe_dispatch"],
            recorded["moe_capacity_factor"], recorded["moe_every"]) == (
        2, "scatter", 0.5, 2)
    np.testing.assert_array_equal(
        np.asarray(port_export.load_predictor(port_bundle, device="cpu")(
            tokens)), want)
