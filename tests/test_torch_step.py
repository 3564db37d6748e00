"""The port's train state and step builders (elasticdl_tpu_torch/core/)
against elasticdl_tpu/core/: the same initial params (the JAX
``init_train_state`` tree, carried across with ``bridge``), the same
batches, Adam 1e-3 on both sides.

Tolerances (f32): per-step loss at rtol 1e-4 (the forward's f32 sums in
another order, the JAX side through dense attention, the port through
the flash plain path). Parameters after 5 steps: the update
(param - initial) at atol 2e-5 against an Adam step of 1e-3 per step
(m/√v divides out the gradient's scale, so a relative gradient error
becomes an absolute error of lr times that error per step).
Adam's m/√v turns gradient noise into a full-size step where the true
gradient is near 0: the key biases' true gradient is exactly 0 (a bias
shared by every key of a row does not move its softmax), so both sides
step them by noise; they are held only to |Δ| <= 5 steps of lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.callbacks import (
    LearningRateScheduler as JaxScheduler,
    apply_callbacks_to_optimizer as jax_apply_callbacks,
)
from elasticdl_tpu.core import step as jstep
from elasticdl_tpu.core.train_state import init_train_state as jax_init
from elasticdl_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    TransformerLM as JaxLM,
)
from elasticdl_tpu.ops.losses import (
    masked_next_token_cross_entropy as jax_loss,
)
from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.callbacks import (
    LearningRateScheduler,
    apply_callbacks_to_optimizer,
)
from elasticdl_tpu_torch.core import step as tstep
from elasticdl_tpu_torch.core.train_state import init_train_state
from elasticdl_tpu_torch.models.transformer import TransformerLM
from elasticdl_tpu_torch.ops.losses import masked_next_token_cross_entropy

V, S, B, STEPS, LR = 97, 32, 4, 5, 1e-3


def _batches(n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        tokens = rng.integers(0, V, (B, S + 1)).astype(np.int32)
        mask = np.ones(B, np.float32)
        if i == n - 1:
            mask[2:] = 0.0          # the last batch is padded
        out.append({"features": tokens[:, :-1], "labels": tokens[:, 1:],
                    "mask": mask})
    return out


@pytest.fixture(scope="module")
def jax_state():
    model = JaxLM(JaxConfig(vocab_size=V, d_model=64, n_heads=2,
                            n_layers=2, d_ff=128, max_len=S,
                            compute_dtype=jnp.float32))
    return model, jax_init(model, optax.adam(LR), _batches()[0], seed=0)


def _port_state(jax_state, make_optimizer=None):
    _, state = jax_state
    params = jax.tree.map(np.asarray, state.params)
    model = TransformerLM(bridge.config_from_params(
        params, compute_dtype=torch.float32))
    model.load_state_dict(bridge.state_dict_from_flax(params))
    make_optimizer = make_optimizer or (
        lambda p: torch.optim.Adam(p, lr=LR))
    return init_train_state(model, make_optimizer, seed=0)


def _jax_run(jax_state, batches, tx=None):
    model, state = jax_state
    if tx is not None:
        state = jax_init(model, tx, batches[0], seed=0)
    else:
        state = jax.tree.map(jnp.copy, state)   # the step donates it
    train_step = jstep.build_train_step(jax_loss)
    losses = []
    for batch in batches:
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses, state


def test_train_steps_match_jax_adam(jax_state):
    batches = _batches()
    want_losses, jstate = _jax_run(jax_state, batches)
    state = _port_state(jax_state)
    initial = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = tstep.build_train_step(masked_next_token_cross_entropy)
    losses = []
    for batch in batches:
        state, metrics = step(state, batch)
        assert metrics["loss"].dim() == 0      # a tensor, not read back
        losses.append(metrics["loss"].item())
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    assert state.step == state.version == STEPS
    want = bridge.state_dict_from_flax(jax.tree.map(np.asarray,
                                                    jstate.params))
    got = state.model.state_dict()
    for name, w in want.items():
        moved_w = w.numpy() - initial[name].numpy()
        moved_g = got[name].numpy() - initial[name].numpy()
        if name.endswith("attn.key.bias"):
            assert np.abs(moved_g).max() <= STEPS * LR * 1.001
            continue
        np.testing.assert_allclose(moved_g, moved_w, rtol=0, atol=2e-5,
                                   err_msg=name)


def test_call_loss_passes_the_mask_only_to_three_argument_losses():
    seen = []
    assert tstep._call_loss(lambda y, p: seen.append(2) or 2.0)(
        1, 2, 3) == 2.0
    assert tstep._call_loss(lambda y, p, m: seen.append(m) or 3.0)(
        1, 2, "mask") == 3.0
    assert seen == [2, "mask"]


def test_multi_step_equals_single_steps(jax_state):
    batches = _batches(3, seed=1)
    single = _port_state(jax_state)
    step = tstep.build_train_step(masked_next_token_cross_entropy)
    losses = [step(single, b)[1]["loss"] for b in batches]
    fused = _port_state(jax_state)
    fused, metrics = tstep.build_multi_step(masked_next_token_cross_entropy)(
        fused, tstep.stack_batches(batches))
    assert metrics["loss"].shape == (3,) and fused.step == 3
    torch.testing.assert_close(metrics["loss"], torch.stack(losses),
                               rtol=0, atol=0)
    for (name, a), b in zip(single.model.state_dict().items(),
                            fused.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_eval_step_logits_match_jax(jax_state):
    _, state = jax_state
    batch = _batches(1, seed=2)[0]
    want = np.asarray(jstep.build_eval_step()(state, batch))
    got = tstep.build_eval_step()(_port_state(jax_state), batch)
    assert got.shape == (B, S, V)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_grad_step_then_apply_equals_a_train_step(jax_state):
    batch = _batches(1, seed=3)[0]
    a = _port_state(jax_state)
    grads, metrics = tstep.build_grad_step(masked_next_token_cross_entropy)(
        a, batch)
    assert a.step == 0 and set(grads) == {
        n for n, _ in a.model.named_parameters()}
    a = tstep.build_apply_gradients()(a, grads, 1.0)
    b = _port_state(jax_state)
    b, metrics_b = tstep.build_train_step(masked_next_token_cross_entropy)(
        b, batch)
    assert a.step == b.step == 1
    assert metrics["loss"].item() == metrics_b["loss"].item()
    for x, y in zip(a.model.state_dict().values(),
                    b.model.state_dict().values()):
        assert torch.equal(x, y)


def test_learning_rate_scheduler_matches_the_jax_chain(jax_state):
    """Step t takes schedule(t) on both sides; SGD keeps the comparison
    to the schedule itself: the f32 updates at rtol 1e-3 / atol 2e-6
    (f32 gradients in another summation order)."""
    schedule = lambda version: 1.0 / (1.0 + version)  # noqa: E731
    batches = _batches(3, seed=4)
    tx = jax_apply_callbacks(optax.sgd(0.5), [JaxScheduler(schedule)])
    _, jstate = _jax_run(jax_state, batches, tx=tx)
    _, fresh = jax_state
    make = apply_callbacks_to_optimizer(
        lambda p: torch.optim.SGD(p, lr=0.5),
        [LearningRateScheduler(schedule)])
    state = _port_state(jax_state, make)
    step = tstep.build_train_step(masked_next_token_cross_entropy)
    for batch in batches:
        state, _ = step(state, batch)
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(0.5 / 4)
    start = bridge.state_dict_from_flax(jax.tree.map(np.asarray,
                                                     fresh.params))
    want = bridge.state_dict_from_flax(jax.tree.map(np.asarray,
                                                    jstate.params))
    got = state.model.state_dict()
    for name in want:
        np.testing.assert_allclose(
            (got[name] - start[name]).numpy(),
            (want[name] - start[name]).numpy(), rtol=1e-3, atol=2e-6,
            err_msg=name)


def test_batch_norm_models_wait_for_their_slice():
    model = torch.nn.Sequential(torch.nn.Linear(2, 2),
                                torch.nn.BatchNorm1d(2))
    with pytest.raises(NotImplementedError, match="BatchNorm"):
        init_train_state(model, lambda p: torch.optim.SGD(p, lr=0.1))
