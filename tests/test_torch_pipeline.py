"""The port's GPipe pipeline and PipelineLM against the JAX package's.

JAX runs on the conftest's 8 virtual CPU devices; the port on
``make_mesh(shape, axes, [cpu] * n)``, one process, where the stages
run in tick order on the one device.

- ``pipeline_apply``: the same stacked stage weights and inputs (numpy,
  seeded) through both: outputs 1e-5, gradients of sum(y²) 1e-4
  relative, and dp composed with pp (``x_spec=P(None, "dp", None)``).
- ``PipelineLM``: JAX's init carried into the port by
  ``bridge.pipeline_state_dict_from_flax``: f32 logits within 2e-4 (as
  tests/test_pipeline_lm.py holds JAX to itself), then 3 Adam steps
  against optax: each step's loss 1e-5 relative and every parameter
  within a hundredth of one step (lr / 100); the attention key biases
  (true gradient 0, both sides step them by noise) within the steps'
  reach.
- ``init``: seeded, each stage's layers drawn apart, the blocks placed
  over pp and the ends whole.
- The refusals JAX makes (a depth that is not pp × layers_per_stage,
  dropout) and the bridge's refusal of a wrong stage count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from elasticdl_tpu.models.pipeline_lm import PipelineLM as JaxPipelineLM
from elasticdl_tpu.models.transformer import TransformerConfig as JaxConfig
from elasticdl_tpu.ops import masked_next_token_cross_entropy as jax_loss
from elasticdl_tpu.parallel import pipeline as jpipe
from elasticdl_tpu.parallel.mesh import make_mesh as jax_mesh
from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.models.pipeline_lm import (
    PipelineLM,
    sequential_state_dict,
)
from elasticdl_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
)
from elasticdl_tpu_torch.ops.losses import masked_next_token_cross_entropy
from elasticdl_tpu_torch.parallel import pipeline as tpipe
from elasticdl_tpu_torch.parallel.mesh import make_mesh
from elasticdl_tpu_torch.parallel.rules import PartitionSpec as TP

CPU = torch.device("cpu")
D = 16
CFG = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=4, d_ff=64,
           max_len=32)
LR = 1e-2
STEPS = 3


def _stacked(n):
    rng = np.random.RandomState(0)
    return {"w1": (rng.randn(n, D, 32) * 0.1).astype(np.float32),
            "b1": (rng.randn(n, 32) * 0.1).astype(np.float32),
            "w2": (rng.randn(n, 32, D) * 0.1).astype(np.float32)}


def _jax_stage(params, x):
    return x + jnp.tanh(x @ params["w1"] + params["b1"]) @ params["w2"]


def _torch_stage(params, x):
    return x + torch.tanh(x @ params["w1"] + params["b1"]) @ params["w2"]


def _torch_params(stacked):
    return {k: torch.tensor(v, requires_grad=True)
            for k, v in stacked.items()}


@pytest.mark.parametrize("n", [2, 4])
def test_pipeline_apply_forward_and_grads_match_jax(n):
    stacked = _stacked(n)
    x = np.random.RandomState(1).randn(8, 4, D).astype(np.float32)
    jmesh = jax_mesh((n,), ("pp",), devices=jax.devices()[:n])

    def loss(params):
        return jnp.sum(jpipe.pipeline_apply(_jax_stage, params, x, jmesh)
                       ** 2)

    want = jax.jit(lambda p: jpipe.pipeline_apply(
        _jax_stage, p, x, jmesh))(stacked)
    want_grads = jax.jit(jax.grad(loss))(stacked)
    params = _torch_params(stacked)
    got = tpipe.pipeline_apply(_torch_stage, params, torch.tensor(x),
                               make_mesh((n,), ("pp",), [CPU] * n))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    (got ** 2).sum().backward()
    for name, grad in want_grads.items():
        np.testing.assert_allclose(params[name].grad.numpy(),
                                   np.asarray(grad), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_pipeline_apply_composes_with_dp():
    stacked = _stacked(2)
    batch = np.random.RandomState(2).randn(32, D).astype(np.float32)
    jmesh = jax_mesh((2, 4), ("pp", "dp"), devices=jax.devices()[:8])
    want = jax.jit(lambda p, x: jpipe.pipeline_apply(
        _jax_stage, p, x, jmesh, axis="pp", x_spec=JP(None, "dp", None)))(
        stacked, jpipe.microbatch(batch, 8))
    mesh = make_mesh((2, 4), ("pp", "dp"), [CPU] * 8)
    x = tpipe.microbatch(torch.tensor(batch), 8)
    assert tuple(x.shape) == (8, 4, D)
    got = tpipe.pipeline_apply(_torch_stage, _torch_params(stacked), x,
                               mesh, axis="pp", x_spec=TP(None, "dp", None))
    np.testing.assert_allclose(
        tpipe.unmicrobatch(got).detach().numpy(),
        np.asarray(jpipe.unmicrobatch(want)), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="dim 0"):
        tpipe.pipeline_apply(_torch_stage, _torch_params(stacked), x, mesh,
                             x_spec=TP("dp", None, None))


def test_stack_stage_params_stacks_each_stage():
    def init(gen):
        return {"w": torch.randn(3, generator=gen)}

    got = tpipe.stack_stage_params(init, torch.Generator().manual_seed(4), 2)
    gen = torch.Generator().manual_seed(4)
    first, second = torch.randn(3, generator=gen), torch.randn(
        3, generator=gen)
    torch.testing.assert_close(got["w"], torch.stack([first, second]))


def _batch(seed=0, b=16, s=16):
    r = np.random.RandomState(seed)
    start = r.randint(0, 32, (b, 1))
    seq = (start + np.arange(s + 1)[None, :]) % 32
    return {"features": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32),
            "mask": np.ones((b,), np.float32)}


def _jax_lm(shape=(2, 2)):
    mesh = jax_mesh(shape, ("pp", "dp"),
                    devices=jax.devices()[:int(np.prod(shape))])
    lm = JaxPipelineLM(JaxConfig(compute_dtype=jnp.float32, **CFG), mesh,
                       num_microbatches=4, layers_per_stage=2)
    params = lm.init(jax.random.PRNGKey(0), _batch()["features"])
    params = jax.device_put(params, lm.param_shardings(params))
    return lm, params


def _port_lm(params, shape=(2, 2)):
    mesh = make_mesh(shape, ("pp", "dp"), [CPU] * int(np.prod(shape)))
    lm = PipelineLM(TransformerConfig(compute_dtype=torch.float32, **CFG),
                    mesh, num_microbatches=4, layers_per_stage=2)
    lm.load_state_dict(bridge.pipeline_state_dict_from_flax(
        jax.tree.map(np.asarray, params), pp=2, layers_per_stage=2))
    return lm


def test_pipeline_lm_logits_match_jax():
    jlm, params = _jax_lm()
    tokens = _batch()["features"]
    want = np.asarray(jlm.apply(params, tokens))
    lm = _port_lm(params)
    got = lm.apply(torch.as_tensor(tokens)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # The same blocks in order as the flagship's TransformerLM.
    flat = TransformerLM(lm.cfg)
    flat.load_state_dict(sequential_state_dict(lm.state_dict(), 2, 2))
    np.testing.assert_allclose(
        flat.eval()(torch.as_tensor(tokens)).detach().numpy(), got,
        rtol=1e-5, atol=1e-5)


def test_pipeline_lm_training_matches_optax():
    jlm, params = _jax_lm((2, 4))
    lm = _port_lm(params, (2, 4))
    tx = optax.adam(LR)
    opt_state = tx.init(params)
    jstep = jlm.make_train_step(jax_loss, tx)
    step = lm.make_train_step(masked_next_token_cross_entropy,
                              lambda p: torch.optim.Adam(p, lr=LR))
    # Stage parameters live split over pp in JAX; the port's placement
    # names the same axis.
    assert lm.param_shardings()["blocks.attn.query.weight"].spec[0] == "pp"
    for i in range(STEPS):
        batch = _batch(seed=i)
        params, opt_state, want = jstep(params, opt_state, batch)
        got = step(batch)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    carried = bridge.pipeline_state_dict_from_flax(
        jax.tree.map(np.asarray, params), pp=2, layers_per_stage=2)
    for name, value in lm.state_dict().items():
        if name.endswith("attn.key.bias"):   # true gradient 0: noise
            assert (value - carried[name]).abs().max() <= 2 * STEPS * LR
            continue
        torch.testing.assert_close(value, carried[name], rtol=0,
                                   atol=LR / 100, msg=name)


def test_pipeline_lm_init_is_seeded_and_placed_by_stage():
    mesh = make_mesh((2, 2), ("pp", "dp"), [CPU] * 4)
    cfg = TransformerConfig(compute_dtype=torch.float32, **CFG)
    one, two = (PipelineLM(cfg, mesh, layers_per_stage=2).init(3)
                for _ in range(2))
    other = PipelineLM(cfg, mesh, layers_per_stage=2).init(4)
    for name, value in one.state_dict().items():
        torch.testing.assert_close(two.state_dict()[name], value, rtol=0,
                                   atol=0)
    assert not torch.equal(other.state_dict()["blocks.mlp.wi.weight"],
                           one.state_dict()["blocks.mlp.wi.weight"])
    # Each stage's layers are drawn apart, as JAX's vmap over split keys.
    wi = one.state_dict()["blocks.mlp.wi.weight"]
    assert not torch.equal(wi[0, 0], wi[0, 1])
    assert not torch.equal(wi[0, 0], wi[1, 0])
    specs = {n: s.spec for n, s in one.param_shardings().items()}
    assert specs["blocks.attn.out.weight"] == TP("pp", None, None, None)
    assert specs["ends.lm_head.weight"] == TP()
    # One process holds every stage: placing it splits nothing.
    one.place()
    assert tuple(one.state_dict()["blocks.mlp.wi.weight"].shape) == (
        2, 2, 64, 32)
    with pytest.raises(RuntimeError, match="init after place"):
        one.init(5)


def test_pipeline_lm_refuses_what_jax_refuses():
    mesh = make_mesh((2, 2), ("pp", "dp"), [CPU] * 4)
    jmesh = jax_mesh((2, 2), ("pp", "dp"), devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="n_layers"):
        PipelineLM(TransformerConfig(**CFG), mesh, layers_per_stage=3)
    with pytest.raises(ValueError, match="n_layers"):
        JaxPipelineLM(JaxConfig(**CFG), jmesh, layers_per_stage=3)
    with pytest.raises(NotImplementedError, match="dropout"):
        PipelineLM(TransformerConfig(dropout_rate=0.1, **CFG), mesh,
                   layers_per_stage=2)
    with pytest.raises(NotImplementedError, match="dropout"):
        JaxPipelineLM(JaxConfig(dropout_rate=0.1, **CFG), jmesh,
                      layers_per_stage=2)


def test_bridge_refuses_a_wrong_stage_count():
    _, params = _jax_lm()
    host = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError, match="stage count"):
        bridge.pipeline_state_dict_from_flax(host, pp=4)
    with pytest.raises(ValueError, match="stage count"):
        bridge.pipeline_state_dict_from_flax(host, pp=2, layers_per_stage=1)
    got = bridge.pipeline_state_dict_from_flax(host, pp=2)
    assert tuple(got["blocks.mlp.wi.weight"].shape) == (2, 2, 64, 32)
