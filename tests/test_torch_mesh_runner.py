"""The port's MeshRunner and the transformer on an ``sp`` mesh, against
the JAX package's.

The JAX side runs on the virtual CPU devices (tests/conftest.py), the
port on a mesh of the CPU repeated (``[cpu] * n``). Weights start equal:
the JAX ``init_train_state`` tree carried across with ``bridge``.

Tolerances (f32):
- per-step losses of the sp twin: 2e-4, the JAX test's own
  (tests/test_transformer.py::test_mesh_training_matches_single_device);
- logits: rtol/atol 1e-4 (f32 sums in another order through 2 layers);
- the port's mesh run against its single-device run: losses 1e-5 (the
  ring's online softmax against the whole-row softmax of the flash plain
  path or dense attention: f32 rounding only) and parameters within a
  hundredth of one Adam step (lr / 100) after 3 steps: Adam's m/√v
  divides out a gradient's scale, so the f32 error of a gradient near 0
  becomes an absolute error of lr times its relative size. The key
  biases' true gradient is 0 (a bias shared by every key of a row leaves
  its softmax alone), so Adam steps them by noise on both sides: they
  are held to the steps' reach, 3 lr each way;
- accumulation: parameters at rtol 1e-4 / atol 1e-5, the JAX staleness
  test's (tests/test_mesh_runner.py:128-195).
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.core import step as jstep
from elasticdl_tpu.core.train_state import init_train_state as jax_init
from elasticdl_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    TransformerLM as JaxLM,
    transformer_sharding_rules,
)
from elasticdl_tpu.parallel import mesh as jmesh
from elasticdl_tpu.parallel import rules as rules_lib
from elasticdl_tpu.parallel.mesh_runner import MeshRunner as JaxRunner
from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.core import step as tstep
from elasticdl_tpu_torch.core.model_spec import get_model_spec
from elasticdl_tpu_torch.core.train_state import init_train_state
from elasticdl_tpu_torch.models.transformer import TransformerLM
from elasticdl_tpu_torch.ops import flash_attention as tfa
from elasticdl_tpu_torch.ops import ring_attention as tra
from elasticdl_tpu_torch.ops.losses import masked_next_token_cross_entropy
from elasticdl_tpu_torch.parallel import mesh as tmesh
from elasticdl_tpu_torch.parallel.mesh_runner import (
    MeshRunner,
    make_runner_for_spec,
)
from elasticdl_tpu_torch.testing.data import model_zoo_dir

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-2


def _jax_zoo():
    path = os.path.join(REPO, "model_zoo", "transformer",
                        "transformer_lm.py")
    spec = importlib.util.spec_from_file_location("jax_transformer_lm",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfg(d_model):
    """tests/test_transformer.py's CFG; d_model 32 gives head dim 8 (the
    einsum ring), 64 head dim 16 (the kernel ring)."""
    return JaxConfig(vocab_size=32, d_model=d_model, n_heads=4, n_layers=2,
                     d_ff=64, max_len=32, compute_dtype=jnp.float32)


def _batch(b=8, s=16, vocab=32, seed=0):
    """tests/test_transformer.py's +1-chain batch."""
    rng = np.random.RandomState(seed)
    start = rng.randint(0, vocab, (b, 1))
    seq = (start + np.arange(s + 1)[None, :]) % vocab
    return {"features": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32),
            "mask": np.ones((b,), np.float32)}


def _port_model(jcfg, jstate, mesh=None):
    params = jax.tree.map(np.asarray, jstate.params)
    model = TransformerLM(bridge.config_from_params(
        params, compute_dtype=torch.float32), mesh=mesh)
    model.load_state_dict(bridge.state_dict_from_flax(params))
    return model


def _adam(params):
    return torch.optim.Adam(params, lr=LR)


@pytest.fixture(scope="module", params=[32, 64], ids=["einsum", "kernel"])
def jax_sp_run(request):
    """JAX MeshRunner on a (2, 2, 2) dp/sp/tp mesh, 3 Adam steps
    (tests/test_transformer.py::test_mesh_training_matches_single_device):
    the initial state, the per-step losses and the final params."""
    jcfg = _cfg(request.param)
    mesh = jmesh.make_mesh((2, 2, 2), ("dp", "sp", "tp"),
                           devices=jax.devices()[:8])
    model = JaxLM(jcfg, mesh=mesh)
    init = jax_init(JaxLM(jcfg), optax.adam(LR), _batch(), seed=0)
    runner = JaxRunner(
        mesh=mesh, param_rule=rules_lib.regex_param_rule(
            transformer_sharding_rules(), mesh=mesh),
        batch_rule=_jax_zoo().batch_sharding_rule)
    state = runner.init_state(model, optax.adam(LR), _batch(), seed=0)
    # Numpy copies: the step donates the state, and a device_put onto
    # the same device would hand it init's own buffers.
    state = state.replace(params=jax.device_put(
        jax.tree.map(np.array, init.params),
        jax.tree.map(lambda x: x.sharding, state.params)))
    step = runner.train_step(_jax_zoo().loss)
    losses = []
    for i in range(3):
        state, metrics = step(state, _batch(seed=i))
        losses.append(float(metrics["loss"]))
    return jcfg, init, losses


def _port_run(runner, model, steps=3):
    state = runner.init_state(model, _adam, _batch(), seed=0)
    step = runner.train_step(masked_next_token_cross_entropy)
    losses = []
    for i in range(steps):
        state, metrics = step(state, _batch(seed=i))
        losses.append(metrics["loss"].item())
    return state, losses


def test_sp_twin_matches_jax_mesh_runner(jax_sp_run):
    jcfg, init, want = jax_sp_run
    mesh = tmesh.make_mesh((2, 2, 2), ("dp", "sp", "tp"), [CPU] * 8)
    runner = MeshRunner(mesh)
    state, losses = _port_run(runner, _port_model(jcfg, init, mesh))
    np.testing.assert_allclose(losses, want, rtol=2e-4, atol=2e-4)
    assert state.step == 3
    assert tfa.chunk_launches == 0


def test_mesh_run_matches_single_device_run(jax_sp_run):
    """The port's sp run (ring) against its own single-device run
    (flash plain path, core.step.build_train_step)."""
    jcfg, init, _ = jax_sp_run
    mesh = tmesh.make_mesh((4,), ("sp",), [CPU] * 4)
    ring, ring_losses = _port_run(MeshRunner(mesh),
                                  _port_model(jcfg, init, mesh))
    single = init_train_state(_port_model(jcfg, init), _adam, seed=0)
    step = tstep.build_train_step(masked_next_token_cross_entropy)
    losses = [step(single, _batch(seed=i))[1]["loss"].item()
              for i in range(3)]
    np.testing.assert_allclose(ring_losses, losses, rtol=1e-5)
    for (name, a), b in zip(ring.model.state_dict().items(),
                            single.model.state_dict().values()):
        if name.endswith("attn.key.bias"):   # true gradient 0: Adam noise
            assert (a - b).abs().max() <= 2 * 3 * LR
            continue
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=LR / 100, err_msg=name)


@pytest.mark.parametrize("d_model", [32, 64])
def test_sp_logits_match_flax(d_model):
    jcfg = _cfg(d_model)
    mesh = jmesh.make_mesh((4,), ("sp",), devices=jax.devices()[:4])
    batch = _batch(seed=5)
    model = JaxLM(jcfg, mesh=mesh)
    variables = jax.jit(lambda x: model.init(
        {"params": jax.random.PRNGKey(1)}, x, training=False))(
        batch["features"])
    want = jax.jit(lambda v, x: model.apply(v, x, training=False))(
        variables, batch["features"])
    params = jax.tree.map(np.asarray, variables["params"])
    tm = tmesh.make_mesh((4,), ("sp",), [CPU] * 4)
    port = TransformerLM(bridge.config_from_params(
        params, compute_dtype=torch.float32), mesh=tm)
    port.load_state_dict(bridge.state_dict_from_flax(params))
    with torch.no_grad():
        got = port(torch.from_numpy(batch["features"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_eval_step_matches_jax(jax_sp_run):
    jcfg, init, _ = jax_sp_run
    batch = _batch(seed=7)
    want = np.asarray(jstep.build_eval_step()(init, batch))
    mesh = tmesh.make_mesh((4,), ("sp",), [CPU] * 4)
    runner = MeshRunner(mesh)
    state = runner.init_state(_port_model(jcfg, init, mesh), _adam)
    eval_step = runner.eval_step()
    assert runner.eval_step() is eval_step        # memoised
    got = eval_step(state, batch)
    assert got.shape == (8, 16, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_remat_recomputes_the_ring_forward(jax_sp_run, monkeypatch):
    """Under remat every layer's ring forward runs twice a step (once
    more in the backward); the gradients equal those without remat."""
    jcfg, init, _ = jax_sp_run
    mesh = tmesh.make_mesh((4,), ("sp",), [CPU] * 4)
    flavour = "kernel" if jcfg.head_dim == 16 else "einsum"
    fwd, bwd = tra._FLAVOURS[flavour]
    calls = []
    monkeypatch.setitem(tra._FLAVOURS, flavour, (
        lambda *a: calls.append(1) or fwd(*a), bwd))
    grads = []
    for remat in (False, True):
        model = _port_model(jcfg, init, mesh)
        model.cfg = dataclasses.replace(model.cfg, remat=remat)
        state = init_train_state(model, _adam, seed=0)
        calls.clear()
        grads.append(tstep.build_grad_step(masked_next_token_cross_entropy)(
            state, _batch(seed=2))[0])
        assert len(calls) == jcfg.n_layers * (2 if remat else 1)
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0, atol=0)


# ---- accumulation (tests/test_mesh_runner.py:128-195) ---------------------


def _linear_batches():
    rng = np.random.RandomState(0)
    return [{"features": rng.randn(8, 6).astype(np.float32),
             "labels": rng.randn(8, 4).astype(np.float32),
             "mask": np.ones((8,), np.float32)} for _ in range(4)]


def _sq_loss(labels, preds, mask):
    err = ((preds - labels) ** 2).sum(dim=-1)
    return (err * mask).sum() / mask.sum().clamp_min(1.0)


def _jax_linear_run(batches, accum_steps, staleness, lr):
    import flax.linen as nn

    class Linear(nn.Module):
        @nn.compact
        def __call__(self, x, training=False):
            return nn.Dense(4)(x)

    def sq_loss(labels, preds, mask):
        err = ((preds - labels) ** 2).sum(axis=-1)
        return (err * mask).sum() / jnp.maximum(mask.sum(), 1.0)

    runner = JaxRunner(accum_steps=accum_steps,
                       staleness_modulation=staleness, donate_state=False)
    state = runner.init_state(Linear(), optax.sgd(lr), batches[0], seed=0)
    params0 = jax.tree.map(np.asarray, state.params)
    step = runner.train_step(sq_loss)
    versions = []
    for batch in batches:
        state, _ = step(state, batch)
        versions.append(int(state.step))
    return params0, jax.tree.map(np.asarray, state.params), versions


def _port_linear(params):
    model = torch.nn.Linear(6, 4)
    with torch.no_grad():
        model.weight.copy_(torch.tensor(params["Dense_0"]["kernel"].T))
        model.bias.copy_(torch.tensor(params["Dense_0"]["bias"]))
    return model


@pytest.mark.parametrize("staleness", [False, True])
def test_accumulation_matches_jax(staleness):
    """accum_steps=2: the optimizer applies every second call (versions
    0, 1, 1, 2), with the window's mean gradient, or with microbatch j
    weighted 1/(k - j) under staleness modulation; the parameters match
    JAX's MeshRunner on the same batches from the same weights."""
    batches, lr = _linear_batches(), 0.1
    params0, want, want_versions = _jax_linear_run(batches, 2, staleness,
                                                   lr)
    runner = MeshRunner(tmesh.make_mesh(devices=[CPU]), accum_steps=2,
                        staleness_modulation=staleness)
    state = runner.init_state(_port_linear(params0),
                              lambda p: torch.optim.SGD(p, lr=lr))
    step = runner.train_step(_sq_loss)
    versions = []
    for batch in batches:
        state, metrics = step(state, batch)
        assert metrics["loss"].dim() == 0
        versions.append(state.step)
    assert versions == want_versions == [0, 1, 1, 2]
    np.testing.assert_allclose(state.model.weight.detach().numpy(),
                               want["Dense_0"]["kernel"].T, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(state.model.bias.detach().numpy(),
                               want["Dense_0"]["bias"], rtol=1e-4,
                               atol=1e-5)


def test_staleness_weights_by_hand():
    """k = 2: microbatch 0 has staleness 2 (weight 1/2), microbatch 1
    staleness 1; the update is lr * (g0 / 2 + g1) / 1.5."""
    batches, lr = _linear_batches()[:2], 0.1
    model = _port_linear({"Dense_0": {
        "kernel": np.random.RandomState(1).randn(6, 4).astype(np.float32),
        "bias": np.zeros(4, np.float32)}})
    ref = init_train_state(_port_linear({"Dense_0": {
        "kernel": model.weight.detach().numpy().T.copy(),
        "bias": model.bias.detach().numpy().copy()}}),
        lambda p: torch.optim.SGD(p, lr=lr))
    grad_step = tstep.build_grad_step(_sq_loss)
    g0 = grad_step(ref, batches[0])[0]
    g1 = grad_step(ref, batches[1])[0]
    start = {k: v.clone() for k, v in model.state_dict().items()}
    runner = MeshRunner(tmesh.make_mesh(devices=[CPU]), accum_steps=2,
                        staleness_modulation=True)
    state = runner.init_state(model, lambda p: torch.optim.SGD(p, lr=lr))
    step = runner.train_step(_sq_loss)
    for batch in batches:
        state, _ = step(state, batch)
    assert state.step == 1
    for name, p in state.model.state_dict().items():
        want = start[name] - lr * (0.5 * g0[name] + g1[name]) / 1.5
        torch.testing.assert_close(p, want, rtol=1e-5, atol=1e-6)


def test_multi_step_and_memo(jax_sp_run):
    jcfg, init, _ = jax_sp_run
    mesh = tmesh.make_mesh((4,), ("sp",), [CPU] * 4)
    runner = MeshRunner(mesh)
    loss = masked_next_token_cross_entropy
    assert runner.train_step(loss) is runner.train_step(loss)
    assert runner.train_multi_step(loss) is runner.train_multi_step(loss)
    single = runner.init_state(_port_model(jcfg, init, mesh), _adam)
    losses = [runner.train_step(loss)(single, _batch(seed=i))[1]["loss"]
              for i in range(2)]
    fused = runner.init_state(_port_model(jcfg, init, mesh), _adam)
    fused, metrics = runner.train_multi_step(loss)(
        fused, tstep.stack_batches([_batch(seed=i) for i in range(2)]))
    assert fused.step == 2
    torch.testing.assert_close(metrics["loss"], torch.stack(losses),
                               rtol=0, atol=0)


def test_parallel_slice_methods_raise():
    """``resize`` and ``place_state`` exist now (tests/test_torch_reshard.py
    holds them): ``place_state`` still raises before ``init_state``, and
    what item 6b holds raises."""
    runner = make_runner_for_spec(None, tmesh.make_mesh(devices=[CPU]),
                                  accum_steps=3)
    assert runner.accum_steps == 3 and runner.mesh.device == CPU
    with pytest.raises(RuntimeError, match="init_state"):
        runner.place_state(None)
    assert runner.resize(tmesh.make_mesh((2,), ("dp",), [CPU] * 2)) is None
    assert runner.mesh.shape == {"dp": 2}
    with pytest.raises(NotImplementedError, match="item 6b"):
        tmesh.make_mesh((2,), ("dp",), [CPU, torch.device("cuda:0")])


# ---- ModelSpec.make_model -------------------------------------------------


def test_model_spec_make_model_passes_the_mesh():
    spec = get_model_spec(model_zoo_dir(),
                          "transformer.transformer_lm.custom_model",
                          device="cpu")
    assert spec.model.blocks[0].attn.mesh is None
    mesh = tmesh.make_mesh((4,), ("sp",), [CPU] * 4)
    model = spec.make_model(mesh)
    assert model is not spec.model
    assert all(b.attn.mesh is mesh for b in model.blocks)
    assert next(model.parameters()).device == CPU
    assert spec.make_model().blocks[0].attn.mesh is None
    tokens = torch.zeros((1, 16), dtype=torch.long)
    with torch.no_grad():
        assert model(tokens).shape == (1, 16, model.cfg.vocab_size)


def test_model_spec_make_model_ignores_the_mesh_without_the_keyword(
        tmp_path):
    zoo = tmp_path / "zoo"
    (zoo / "plain").mkdir(parents=True)
    (zoo / "plain" / "lin.py").write_text(
        "import torch\n"
        "def custom_model():\n"
        "    return torch.nn.Linear(2, 2)\n"
        "loss = optimizer = dataset_fn = lambda *a, **k: None\n")
    spec = get_model_spec(str(zoo), "plain.lin.custom_model", device="cpu")
    model = spec.make_model(tmesh.make_mesh((2,), ("sp",), [CPU] * 2))
    assert isinstance(model, torch.nn.Linear) and model is not spec.model
