"""The port's BatchNorm and TpuBatchNorm (``models/batch_norm.py``)
against flax ``nn.BatchNorm`` and the JAX package's ``TpuBatchNorm``, on
the CPU.

The same (B, H, W, C) inputs from a numpy seed, the same variables (scale,
bias and running statistics drawn away from their initial values and
carried across by name): three training forwards, each output and the
running statistics after each, then an eval forward; and the gradients
of a weighted sum of the output with respect to the input, scale and
bias, in training (through the batch statistics) and in eval.

Then the statistics through the port's steps (``core/step.py``,
``parallel/mesh_runner.py``), as the JAX steps keep ``batch_stats``: a
batch with a padded row leaves them bit-equal (train, multi-step and
accumulation steps; a batch already on its device without a read-back),
the gradient-only step leaves them, and the accumulation path moves them
every microbatch.

Tolerances, relative L2: f32 1e-5 (the statistics are sums over 200
values a channel in another order). bf16 (the layers' output dtype in
the zoo): the statistics 1e-5 (taken in f32 of the same bf16 values);
outputs 1e-2 (rounded to bf16 once; ``TpuBatchNorm``'s x·a + b may round
twice in PyTorch where XLA fuses the pair: a few 2^-9 roundings; read
<= 1e-7); gradients 2e-2, as the DeepFM twins' bf16 gradients: through
``TpuBatchNorm``'s bf16 a and b, XLA sums a channel's 200 bf16 products
in bf16 where PyTorch accumulates in f32 (read 8.9e-3).
"""

import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.models.batch_norm import TpuBatchNorm as JaxTpuBatchNorm
from elasticdl_tpu_torch.core.step import (
    build_grad_step,
    build_multi_step,
    build_train_step,
    stack_batches,
)
from elasticdl_tpu_torch.core.train_state import init_train_state
from elasticdl_tpu_torch.data.batcher import pad_batch, tree_map
from elasticdl_tpu_torch.models.batch_norm import BatchNorm, TpuBatchNorm
from elasticdl_tpu_torch.models.transformer import Dense
from elasticdl_tpu_torch.models.vision import Conv
from elasticdl_tpu_torch.ops.losses import masked_softmax_cross_entropy
from elasticdl_tpu_torch.parallel.mesh import make_mesh
from elasticdl_tpu_torch.parallel.mesh_runner import MeshRunner

SHAPE = (8, 5, 5, 6)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
STATS_TOL = 1e-5


def rel(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _modules(kind, jdt, tdt, momentum):
    c = SHAPE[-1]
    if kind == "BatchNorm":
        return (fnn.BatchNorm(momentum=momentum, epsilon=1e-5, dtype=jdt),
                BatchNorm(c, momentum=momentum, epsilon=1e-5, dtype=tdt))
    return (JaxTpuBatchNorm(momentum=momentum, epsilon=1e-5, dtype=jdt),
            TpuBatchNorm(c, momentum=momentum, epsilon=1e-5, dtype=tdt))


def _inputs(seed, n=4):
    rng = np.random.default_rng(seed)
    # An offset and a spread per channel, as conv outputs have.
    return [(rng.standard_normal(SHAPE) * rng.uniform(0.5, 2.0, SHAPE[-1])
             + rng.uniform(-1.0, 1.0, SHAPE[-1])).astype(np.float32)
            for _ in range(n)]


def _variables(seed):
    """Scale, bias and running statistics away from their initial
    values, numpy f32."""
    rng = np.random.default_rng(seed)
    c = SHAPE[-1]
    return {
        "params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                   "bias": rng.uniform(-0.5, 0.5, c).astype(np.float32)},
        "batch_stats": {"mean": rng.uniform(-0.5, 0.5, c).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, c).astype(np.float32)},
    }


def _load(module, variables):
    module.load_state_dict({
        "scale": torch.from_numpy(variables["params"]["scale"]),
        "bias": torch.from_numpy(variables["params"]["bias"]),
        "mean": torch.from_numpy(variables["batch_stats"]["mean"]),
        "var": torch.from_numpy(variables["batch_stats"]["var"]),
    })


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["BatchNorm", "TpuBatchNorm"])
def test_training_forwards_and_running_statistics_match_flax(kind, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    momentum = 0.9
    jmod, tmod = _modules(kind, jdt, tdt, momentum)
    variables = _variables(1)
    _load(tmod, variables)
    xs = _inputs(2)
    tmod.train()
    train_module = jmod.clone(use_running_average=False)
    for x in xs[:3]:
        want, updates = train_module.apply(variables, jnp.asarray(x, jdt),
                                           mutable=["batch_stats"])
        variables = {"params": variables["params"],
                     "batch_stats": jax.tree.map(np.asarray,
                                                 updates["batch_stats"])}
        got = tmod(torch.from_numpy(x).to(tdt))
        assert got.dtype == tdt
        assert rel(got, np.asarray(want, np.float32)) <= tol
        for name in ("mean", "var"):
            assert rel(getattr(tmod, name), variables["batch_stats"][name]) \
                <= STATS_TOL, name
    # Eval: the running statistics, and nothing moves.
    tmod.eval()
    before = [tmod.mean.clone(), tmod.var.clone()]
    want = jmod.clone(use_running_average=True).apply(
        variables, jnp.asarray(xs[3], jdt))
    got = tmod(torch.from_numpy(xs[3]).to(tdt))
    assert rel(got, np.asarray(want, np.float32)) <= tol
    assert torch.equal(tmod.mean, before[0])
    assert torch.equal(tmod.var, before[1])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("kind", ["BatchNorm", "TpuBatchNorm"])
def test_gradients_match_flax(kind, training, dtype):
    """d(sum(y * w)) with respect to x, scale and bias; in training the
    gradient of x runs through the batch mean and variance."""
    jdt, tdt, _ = DTYPES[dtype]
    tol = GRAD_TOL[dtype]
    jmod, tmod = _modules(kind, jdt, tdt, 0.99)
    variables = _variables(3)
    _load(tmod, variables)
    x = _inputs(4, 1)[0]
    w = np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)

    module = jmod.clone(use_running_average=not training)

    def loss(params, xj):
        y, _ = module.apply({"params": params,
                             "batch_stats": variables["batch_stats"]}, xj,
                            mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * w)

    jparams = jax.tree.map(jnp.asarray, variables["params"])
    want_p, want_x = jax.grad(loss, argnums=(0, 1))(
        jparams, jnp.asarray(x, jdt))
    tmod.train(training)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    (tmod(xt).float() * torch.from_numpy(w)).sum().backward()
    assert rel(xt.grad, np.asarray(want_x, np.float32)) <= tol
    assert rel(tmod.scale.grad, want_p["scale"]) <= tol
    assert rel(tmod.bias.grad, want_p["bias"]) <= tol


def test_momentum_and_variance_follow_flax_not_torch():
    """flax's update ``ra = m·ra + (1 − m)·batch`` with the biased
    variance; torch's BatchNorm2d (unbiased, momentum the other way)
    gives another running variance on the same batch."""
    x = _inputs(6, 1)[0]
    module = BatchNorm(SHAPE[-1], momentum=0.9).train()
    module(torch.from_numpy(x))
    flat = x.reshape(-1, SHAPE[-1]).astype(np.float64)
    want_var = 0.9 * 1.0 + 0.1 * flat.var(axis=0)
    np.testing.assert_allclose(module.var.numpy(), want_var, rtol=1e-5)
    np.testing.assert_allclose(module.mean.numpy(), 0.1 * flat.mean(axis=0),
                               rtol=1e-5, atol=1e-7)
    torch_bn = torch.nn.BatchNorm2d(SHAPE[-1], momentum=0.1).train()
    torch_bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not np.allclose(torch_bn.running_var.numpy(), want_var,
                           rtol=1e-3)
    assert [name for name, _ in module.named_parameters()] == ["scale",
                                                               "bias"]
    assert [name for name, _ in module.named_buffers()] == ["mean", "var"]


# ---- the statistics through the steps --------------------------------------


class _Net(torch.nn.Module):
    """A conv, both BatchNorms and a dense head: (B, 6, 6, 3) -> 3."""

    def __init__(self):
        super().__init__()
        self.conv = Conv(3, 4, 3)
        self.norm = BatchNorm(4, momentum=0.9)
        self.folded = TpuBatchNorm(4, dtype=torch.float32)
        self.head = Dense(6 * 6 * 4, 3, torch.float32)

    def forward(self, x):
        x = self.folded(torch.relu(self.norm(self.conv(x))))
        return self.head(x.reshape(x.shape[0], -1))


def _state():
    torch.manual_seed(0)
    return init_train_state(_Net(), lambda p: torch.optim.SGD(
        p, lr=0.1, momentum=0.9))


def _step_batch(seed, real=4, placed=False):
    """A (4, 6, 6, 3) batch whose rows past ``real`` are padding (copies
    of row 0, as the batcher pads); ``placed``: torch tensors, as a batch
    already on its device."""
    rng = np.random.default_rng(seed)
    features = rng.standard_normal((real, 6, 6, 3)).astype(np.float32)
    labels = rng.integers(0, 3, real).astype(np.int32)
    batch = pad_batch(features, labels, real, 4)
    if placed:
        batch = tree_map(torch.from_numpy, batch)
    return batch


def _stats_of(state):
    return {k: v.clone() for k, v in state.batch_stats.items()}


def _params_of(state):
    return {k: v.detach().clone()
            for k, v in state.model.named_parameters()}


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


@contextlib.contextmanager
def _no_read_back():
    """Every way a tensor's value reaches the host raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("a step read a value back")

    names = ("item", "tolist", "__bool__", "__float__", "__int__", "numpy")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    try:
        for n in names:
            setattr(torch.Tensor, n, refuse)
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)


@pytest.mark.parametrize("placed", [False, True], ids=["host", "placed"])
def test_padded_batch_keeps_the_statistics_in_the_train_step(placed):
    """A full batch moves the statistics; a batch with a padded row
    leaves them bit-equal to the previous step's, and still trains. A
    host mask is read on the host; a placed one is not read back (the
    buffers take torch.where on the device)."""
    state = _state()
    step = build_train_step(masked_softmax_cross_entropy)
    start = _stats_of(state)
    with _no_read_back() if placed else contextlib.nullcontext():
        state, _ = step(state, _step_batch(1, placed=placed))
    after_full = _stats_of(state)
    assert sorted(after_full) == ["folded.mean", "folded.var", "norm.mean",
                                  "norm.var"]
    assert not any(torch.equal(start[k], after_full[k]) for k in start)
    params = _params_of(state)
    with _no_read_back() if placed else contextlib.nullcontext():
        state, _ = step(state, _step_batch(2, real=3, placed=placed))
    assert _same(_stats_of(state), after_full)
    assert not _same(_params_of(state), params)


def test_padded_batch_keeps_the_statistics_in_the_multi_step():
    """[full, padded] through the multi-step: the statistics are those
    of the full batch's step alone, bit for bit."""
    want = _state()
    build_train_step(masked_softmax_cross_entropy)(want, _step_batch(1))
    state = _state()
    multi = build_multi_step(masked_softmax_cross_entropy)
    state, metrics = multi(state, stack_batches([_step_batch(1),
                                                 _step_batch(2, real=1)]))
    assert metrics["loss"].shape == (2,)
    assert _same(_stats_of(state), _stats_of(want))
    assert state.step == 2


def test_grad_step_keeps_the_statistics():
    """The gradient-only step (the JAX grad step's contract) leaves the
    statistics as they were, full batch or not."""
    state = _state()
    start = _stats_of(state)
    grads, _ = build_grad_step(masked_softmax_cross_entropy)(
        state, _step_batch(1))
    assert grads and _same(_stats_of(state), start)


def test_accumulation_moves_the_statistics_every_microbatch():
    """``accum_steps=2`` on a one-device MeshRunner: the statistics move
    with each full microbatch, the weights only at the window's apply;
    a padded microbatch keeps the statistics."""
    runner = MeshRunner(make_mesh((1,), ("dp",), [torch.device("cpu")]),
                        accum_steps=2)
    state = runner.init_state(_Net(), lambda p: torch.optim.SGD(p, lr=0.1))
    step = runner.train_step(masked_softmax_cross_entropy)
    stats, params = _stats_of(state), _params_of(state)
    state, _ = step(state, _step_batch(1))
    first = _stats_of(state)
    assert not _same(first, stats)
    assert _same(_params_of(state), params) and state.step == 0
    state, _ = step(state, _step_batch(2))
    second = _stats_of(state)
    assert not _same(second, first)
    assert not _same(_params_of(state), params) and state.step == 1
    state, _ = step(state, _step_batch(3, real=2))
    assert _same(_stats_of(state), second)
