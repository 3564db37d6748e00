"""Data parallel over the port's mesh (elasticdl_tpu_torch/parallel/
mesh_runner.py and zero.py) against the JAX MeshRunner, on the CPU.

JAX runs on 4 of the conftest's 8 virtual CPU devices, the port on
``[cpu] * 4``; weights cross from flax through ``bridge``. mnist and
cifar10 run at f32 from centred inputs (standard normal), B 16, at lr
0.01 (the zoos' momentum SGD), cifar10's dropout the identity on both
sides.

Tolerances:

- port dp4 against port dp1 (and against the plain single-device
  step): bit-equal. The dense step is the same global program on the one
  device, and ZeRO applies an elementwise optimizer to slices of the
  same tensors, so nothing may move by an ulp.
- port dp4 against JAX dp4, 4 steps: losses within 1e-4 relative, each
  parameter's change and each momentum slot within 1e-2 relative L2
  (floored at 1e-3 of the whole tree: a conv bias that feeds a BatchNorm
  has a true gradient of 0). Both run f32 BatchNorm nets, whose
  gradients carry each package's rounding of the batch statistics
  (XLA's f32 sum over (B, H, W) reads ~4e-7 from float64 where
  PyTorch's reads ~1.5e-7), amplified through the chain of BatchNorms
  and carried by momentum: the worst tensor reads 2.7e-3 (cifar10's
  first BatchNorm bias's momentum), the median ~1e-5. A wiring fault (a
  wrong slice, a missed entry, a doubled update) moves a quarter or
  more of a tensor by O(1), 0.5 relative or more. The float64 parity of
  these twins is held at 1e-5 in tests/test_torch_vision_zoo.py.
- placement: exact, leaf by leaf, on the facts that do not depend on
  layout (whether a slot is split, its shard's element count, and the
  spec itself where the flax and torch shapes agree: torch keeps a
  Linear's weight (out, in) and a conv's (O, I, H, W), flax (in, out)
  and (H, W, I, O), so "the first dim the axis divides" can name
  another dim of the same data).
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.core.model_spec import load_module
from elasticdl_tpu.parallel import mesh as jmesh
from elasticdl_tpu.parallel.mesh_runner import MeshRunner as JaxRunner
from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.checkpoint import CheckpointHook, restore_from_dir
from elasticdl_tpu_torch.checkpoint import state_io
from elasticdl_tpu_torch.core import step as tstep
from elasticdl_tpu_torch.core.model_spec import get_model_spec
from elasticdl_tpu_torch.core.train_state import init_train_state
from elasticdl_tpu_torch.model_zoo.cifar10 import cifar10_functional
from elasticdl_tpu_torch.model_zoo.mnist import mnist_functional
from elasticdl_tpu_torch.parallel import mesh as tmesh
from elasticdl_tpu_torch.parallel.mesh_runner import (
    MeshRunner,
    make_runner_for_spec,
)
from elasticdl_tpu_torch.parallel.rules import PartitionSpec as TP
from elasticdl_tpu_torch.parallel.zero import ZeroOptimizer
from elasticdl_tpu_torch.testing.data import model_zoo_dir

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.01
B = 16
LOSS_TOL, DELTA_TOL = 1e-4, 1e-2
TWINS = {
    "mnist": ("mnist/mnist_functional.py", mnist_functional,
              lambda m: m.MnistModel(compute_dtype=jnp.float32),
              lambda: mnist_functional.MnistModel(
                  compute_dtype=torch.float32), (B, 28, 28)),
    "cifar10": ("cifar10/cifar10_functional.py", cifar10_functional,
                lambda m: m.Cifar10Model(compute_dtype=jnp.float32),
                lambda: cifar10_functional.Cifar10Model(
                    compute_dtype=torch.float32), (B, 32, 32, 3)),
}


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _batches(shape, n=4, seed=5):
    rng = np.random.default_rng(seed)
    return [{"features": rng.standard_normal(shape).astype(np.float32),
             "labels": rng.integers(0, 10, shape[0]).astype(np.int32),
             "mask": np.ones(shape[0], np.float32)} for _ in range(n)]


def _tmesh(n, axes=("dp",)):
    return tmesh.make_mesh((n,), axes, [CPU] * n)


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, *args, **kwargs: x)
    monkeypatch.setattr(cifar10_functional, "dropout",
                        lambda x, rate, generator, global_batch=None: x)


def _jax_module(name):
    return load_module(os.path.join(REPO, "model_zoo", TWINS[name][0]))


def _jax_run(name, steps=4):
    """JAX MeshRunner on a dp4 mesh from its own init: (initial
    variables, losses, final params, final momentum traces), numpy."""
    jmod = _jax_module(name)
    _, _, make_jax, _, shape = TWINS[name]
    batches = _batches(shape, steps)
    mesh = jmesh.make_mesh((4,), ("dp",), devices=jax.devices()[:4])
    runner = JaxRunner(mesh=mesh, donate_state=False)
    state = runner.init_state(make_jax(jmod), optax.sgd(LR, momentum=0.9),
                              batches[0], seed=1)
    initial = {"params": jax.tree.map(np.array, state.params),
               "batch_stats": jax.tree.map(np.array, state.batch_stats)}
    step = runner.train_step(jmod.loss)
    losses = []
    for batch in batches:
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    trace = state.opt_state[0].trace
    return (initial, losses, jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, trace))


def _port_run(name, initial, n, steps=4, runner=None):
    _, twin, _, make_port, shape = TWINS[name]
    model = make_port()
    model.load_state_dict(bridge.flax_state_dict(initial))
    runner = runner or MeshRunner(_tmesh(n))
    state = runner.init_state(model, twin.optimizer(lr=LR))
    step = runner.train_step(twin.loss)
    losses = []
    for batch in _batches(shape, steps):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
    return state, torch.stack(losses), runner


@pytest.fixture(scope="module")
def jax_runs():
    return {}


def _jax_cached(jax_runs, name):
    if name not in jax_runs:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fnn.Dropout, "__call__",
                       lambda self, x, *args, **kwargs: x)
            jax_runs[name] = _jax_run(name)
    return jax_runs[name]


@pytest.mark.parametrize("name", sorted(TWINS))
def test_dp4_matches_jax_dp4(name, jax_runs, no_dropout):
    initial, want_losses, want_params, want_trace = _jax_cached(jax_runs,
                                                                name)
    state, losses, _ = _port_run(name, initial, 4)
    assert isinstance(state.optimizer, ZeroOptimizer)
    assert state.optimizer.num_entries == 4
    np.testing.assert_allclose(losses.numpy(), want_losses, rtol=LOSS_TOL)
    start = bridge.flax_state_dict({"params": initial["params"]})
    want = bridge.flax_state_dict({"params": want_params})
    got = dict(state.model.named_parameters())
    _close({k: got[k].detach().numpy() - start[k].numpy() for k in start},
           {k: want[k].numpy() - start[k].numpy() for k in start})
    slots = bridge.flax_state_dict({"params": want_trace})
    leaves = state_io.named_leaves_from_state(state)
    _close({k: leaves[f"opt_state.{k}.momentum_buffer"] for k in slots},
           {k: v.numpy() for k, v in slots.items()})


def _close(got, want):
    """Each tensor within DELTA_TOL relative L2, floored at 1e-3 of the
    whole: a conv bias that feeds a BatchNorm has a true gradient of 0,
    so both sides read rounding noise there (tests/test_torch_vision_zoo.py
    holds it the same way)."""
    whole = np.linalg.norm(np.concatenate(
        [np.ravel(w).astype(np.float64) for w in want.values()]))
    for key, w in want.items():
        w = np.asarray(w, np.float64)
        err = np.linalg.norm(np.asarray(got[key], np.float64) - w)
        assert err <= DELTA_TOL * max(np.linalg.norm(w), 1e-3 * whole), key


@pytest.mark.parametrize("name", sorted(TWINS))
def test_dp4_is_bit_equal_to_dp1_and_to_the_plain_step(name, jax_runs,
                                                       no_dropout):
    initial = _jax_cached(jax_runs, name)[0]
    dp4, losses4, _ = _port_run(name, initial, 4)
    dp1, losses1, _ = _port_run(name, initial, 1)
    assert dp1.optimizer.num_entries == 1
    assert all(s.is_replicated for s in dp1.optimizer.shardings.values())
    torch.testing.assert_close(losses4, losses1, rtol=0, atol=0)
    _, twin, _, make_port, shape = TWINS[name]
    model = make_port()
    model.load_state_dict(bridge.flax_state_dict(initial))
    plain = init_train_state(model, twin.optimizer(lr=LR))
    step = tstep.build_train_step(twin.loss)
    for batch in _batches(shape):
        plain, _ = step(plain, batch)
    a, b, c = (state_io.named_leaves_from_state(s)
               for s in (dp4, dp1, plain))
    assert a.keys() == b.keys() == c.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        np.testing.assert_array_equal(a[key], c[key], err_msg=key)


# ---- placement against the JAX runner's ------------------------------------


def _jax_opt_specs(runner, state, field):
    """{torch parameter name: (spec, shard shape)} of the JAX state's
    ``field`` slot tree (optax's mu or trace). ``bridge.flax_state_dict``
    names a flax path as the twin does: dots, ``kernel`` -> ``weight``."""
    tree = getattr(runner.state_shardings(state).opt_state[0], field)
    values = dict(jax.tree_util.tree_flatten_with_path(
        getattr(state.opt_state[0], field))[0])
    out = {}
    for path, sharding in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(p, "key", p)) for p in path]
        keys[-1] = "weight" if keys[-1] == "kernel" else keys[-1]
        out[".".join(keys)] = (sharding.spec,
                               sharding.shard_shape(values[path].shape))
    return out


@pytest.mark.parametrize("name,opt", [("mnist", "adam"),
                                      ("cifar10", "momentum")])
def test_state_shardings_match_jax(name, opt, no_dropout):
    jmod = _jax_module(name)
    _, twin, make_jax, make_port, shape = TWINS[name]
    batch = _batches(shape, 1)[0]
    jtx = optax.adam(1e-3) if opt == "adam" else optax.sgd(LR, momentum=0.9)
    ttx = ((lambda p: torch.optim.Adam(p, lr=1e-3)) if opt == "adam"
           else twin.optimizer(lr=LR))
    jm = jmesh.make_mesh((4,), ("dp",), devices=jax.devices()[:4])
    jrunner = JaxRunner(mesh=jm, donate_state=False)
    jstate = jrunner.init_state(make_jax(jmod), jtx, batch, seed=0)
    want = _jax_opt_specs(jrunner, jstate,
                          "mu" if opt == "adam" else "trace")
    runner = MeshRunner(_tmesh(4))
    state = runner.init_state(make_port(), ttx)
    got = runner.state_shardings(state)
    params = dict(state.model.named_parameters())
    assert sorted(want) == sorted(params)
    assert {f"opt_state.{n}" for n in params} == {
        k for k in got if k.startswith("opt_state.")}
    split = 0
    for tname, (jspec, jshard) in want.items():
        sharding, p = got[f"opt_state.{tname}"], params[tname]
        assert got[f"params.{tname}"].is_replicated
        # Split or not, and the shard's size, agree whatever the layout.
        assert sharding.num_shards == p.numel() // int(np.prod(jshard))
        if tuple(p.shape) == tuple(want_shape(jspec, jshard)):
            # The same layout in both packages: the same spec.
            assert _strip(sharding.spec) == _strip(jspec), tname
        split += not sharding.is_replicated
    assert split > 0
    # After a step each entry holds its own slot tensors, 1/4 of each
    # split leaf (tests/test_mesh_runner.py's
    # test_opt_state_is_zero_sharded).
    state, _ = runner.train_step(twin.loss)(state, batch)
    seen = 0
    for pname, slot, value in state.optimizer.named_slots():
        if not isinstance(value, tmesh.ShardedTensor):
            continue
        seen += 1
        assert len(value.shards) == 4
        for shard in value.shards:
            assert shard.numel() * 4 == params[pname].numel()
        assert len({s.untyped_storage().data_ptr()
                    for s in value.shards}) == 4, (pname, slot)
    assert seen >= split


def want_shape(jspec, jshard):
    """The whole shape of a JAX leaf from its spec and shard shape on a
    4-way axis."""
    return tuple(s * (4 if i < len(jspec) and jspec[i] else 1)
                 for i, s in enumerate(jshard))


def _strip(spec):
    entries = list(spec)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _jax_transformer_state(mesh):
    from elasticdl_tpu.core.model_spec import get_model_spec as jax_spec
    from elasticdl_tpu.parallel.mesh_runner import (
        make_runner_for_spec as jax_runner_for_spec,
    )

    spec = jax_spec(os.path.join(REPO, "model_zoo"),
                    "transformer.transformer_lm.custom_model")
    runner = jax_runner_for_spec(spec, mesh, donate_state=False)
    batch = {"features": np.zeros((8, 16), np.int32),
             "labels": np.zeros((8, 16), np.int32),
             "mask": np.ones((8,), np.float32)}
    state = runner.init_state(spec.make_model(mesh), optax.adam(1e-3), batch)
    return runner, state


def test_transformer_rules_on_a_dp_mesh_match_jax():
    """The flagship's rules on a dp-only mesh: every parameter
    replicated (fit_spec drops tp), every slot ZeRO-split over dp; the
    leaves split and the bytes an entry holds agree with JAX's (the
    leaves themselves are laid out differently: flax's query kernel is
    (d, H, Dh), the twin's weight (H·Dh, d))."""
    jm = jmesh.make_mesh((4,), ("dp",), devices=jax.devices()[:4])
    jrunner, jstate = _jax_transformer_state(jm)
    jsh = jrunner.state_shardings(jstate)
    assert all(all(a is None for a in s.spec)
               for s in jax.tree.leaves(jsh.params))
    mu = jax.tree.leaves(jstate.opt_state[0].mu)
    mu_sh = jax.tree.leaves(jsh.opt_state[0].mu)
    want_split = sum(1 for s in mu_sh if any(s.spec))
    want_elems = sum(int(np.prod(s.shard_shape(leaf.shape)))
                     for s, leaf in zip(mu_sh, mu))
    spec = get_model_spec(model_zoo_dir(),
                          "transformer.transformer_lm.custom_model",
                          device="cpu")
    runner = make_runner_for_spec(spec, _tmesh(4))
    state = runner.init_state(spec.make_model(runner.mesh),
                              lambda p: torch.optim.Adam(p, lr=1e-3))
    got = runner.state_shardings(state)
    params = dict(state.model.named_parameters())
    assert all(got[f"params.{n}"].is_replicated for n in params)
    opt = {n: got[f"opt_state.{n}"] for n in params}
    assert sum(not s.is_replicated for s in opt.values()) == want_split
    assert sum(p.numel() // opt[n].num_shards
               for n, p in params.items()) == want_elems
    assert len(opt) == len(mu)


@pytest.mark.parametrize("shape,axes", [((2, 2, 2), ("dp", "sp", "tp")),
                                        ((2, 2), ("dp", "tp"))])
def test_a_placing_tp_axis_waits_for_6b(shape, axes):
    """Item 6b's step 3 has landed: the transformer's rules place its
    kernels over ``tp`` (the Megatron layout), their slots alike, each
    module records its placement, and a step runs."""
    spec = get_model_spec(model_zoo_dir(),
                          "transformer.transformer_lm.custom_model",
                          device="cpu")
    mesh = tmesh.make_mesh(shape, axes, [CPU] * int(np.prod(shape)))
    runner = make_runner_for_spec(spec, mesh)
    state = runner.init_state(spec.make_model(mesh),
                              lambda p: torch.optim.Adam(p, lr=1e-3))
    got = runner.state_shardings(state)
    for name in ("blocks.0.mlp.wi.weight", "blocks.0.attn.query.weight",
                 "lm_head.weight", "token_embed.weight"):
        assert got[f"params.{name}"].spec == TP("tp", None)
        assert got[f"opt_state.{name}"].spec == TP("tp", None)
    assert got["params.blocks.0.attn.out.weight"].spec == TP(None, "tp")
    assert got["params.blocks.0.attn.out.bias"].is_replicated
    assert state.model.blocks[0].mlp.wi._placed["weight"] == got[
        "params.blocks.0.mlp.wi.weight"]
    batch = {"features": np.zeros((4, 16), np.int32),
             "labels": np.ones((4, 16), np.int32),
             "mask": np.ones((4,), np.float32)}
    _, metrics = runner.train_step(spec.loss)(state, batch)
    assert np.isfinite(metrics["loss"].item())


def test_a_row_split_dense_parameter_waits_for_6b():
    """Item 6b's step 4 has landed: a table over the 2 MB threshold as a
    parameter of the dense model (an Embedding's or a DenseFeatures'
    ``embedding``) is placed split over the data axis, its slots
    alike."""

    class Table(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embedding = torch.nn.Parameter(torch.zeros(1024, 1024))

    runner = MeshRunner(_tmesh(4))
    state = runner.init_state(Table(), lambda p: torch.optim.SGD(p, lr=0.1))
    got = runner.state_shardings(state)
    assert got["params.embedding"].spec == TP("dp", None)
    assert got["opt_state.embedding"].spec == TP("dp", None)
    assert state.model._placed["embedding"] == got["params.embedding"]
    # On a dp1 mesh nothing is split.
    runner = MeshRunner(_tmesh(1))
    state = runner.init_state(Table(), lambda p: torch.optim.SGD(p, lr=0.1))
    assert runner.state_shardings(state)["params.embedding"].is_replicated


def test_a_non_elementwise_optimizer_is_refused():
    model = torch.nn.Linear(8, 4)
    with pytest.raises(NotImplementedError, match="elementwise"):
        MeshRunner(_tmesh(4)).init_state(
            model, lambda p: torch.optim.LBFGS(p, lr=0.1))


# ---- accumulation, staleness, the multi step ------------------------------


def _linear_batches():
    rng = np.random.RandomState(0)
    return [{"features": rng.randn(8, 8).astype(np.float32),
             "labels": rng.randn(8, 4).astype(np.float32),
             "mask": np.ones((8,), np.float32)} for _ in range(4)]


def _sq_loss(labels, preds, mask):
    err = ((preds - labels) ** 2).sum(dim=-1)
    return (err * mask).sum() / mask.sum().clamp_min(1.0)


def _jax_linear_dp4(batches, staleness, lr):
    class Linear(fnn.Module):
        @fnn.compact
        def __call__(self, x, training=False):
            return fnn.Dense(4)(x)

    def sq_loss(labels, preds, mask):
        err = ((preds - labels) ** 2).sum(axis=-1)
        return (err * mask).sum() / jnp.maximum(mask.sum(), 1.0)

    mesh = jmesh.make_mesh((4,), ("dp",), devices=jax.devices()[:4])
    runner = JaxRunner(mesh=mesh, accum_steps=2,
                       staleness_modulation=staleness, donate_state=False)
    state = runner.init_state(Linear(), optax.sgd(lr, momentum=0.9),
                              batches[0], seed=0)
    params0 = jax.tree.map(np.array, state.params)
    step = runner.train_step(sq_loss)
    versions = []
    for batch in batches:
        state, _ = step(state, batch)
        versions.append(int(state.step))
    return params0, jax.tree.map(np.asarray, state.params), versions


def _port_linear(params):
    model = torch.nn.Linear(8, 4)
    with torch.no_grad():
        model.weight.copy_(torch.tensor(params["Dense_0"]["kernel"].T))
        model.bias.copy_(torch.tensor(params["Dense_0"]["bias"]))
    return model


@pytest.mark.parametrize("staleness", [False, True])
def test_accumulation_at_dp4_matches_jax_dp4_and_port_dp1(staleness):
    """accum_steps=2 at dp4: versions 0, 1, 1, 2; the parameters equal
    JAX's dp4 run (rtol 1e-4 / atol 1e-5, the JAX staleness test's) and
    the port's dp1 run bit for bit (momentum SGD: the slots split)."""
    batches, lr = _linear_batches(), 0.1
    params0, want, want_versions = _jax_linear_dp4(batches, staleness, lr)
    runs = {}
    for n in (4, 1):
        runner = MeshRunner(_tmesh(n), accum_steps=2,
                            staleness_modulation=staleness)
        state = runner.init_state(_port_linear(params0),
                                  lambda p: torch.optim.SGD(p, lr=lr,
                                                            momentum=0.9))
        step = runner.train_step(_sq_loss)
        versions = []
        for batch in batches:
            state, _ = step(state, batch)
            versions.append(state.step)
        assert versions == want_versions == [0, 1, 1, 2]
        runs[n] = state
    assert runs[4].optimizer.num_entries == 4
    np.testing.assert_allclose(runs[4].model.weight.detach().numpy(),
                               want["Dense_0"]["kernel"].T, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(runs[4].model.bias.detach().numpy(),
                               want["Dense_0"]["bias"], rtol=1e-4, atol=1e-5)
    for a, b in zip(runs[4].model.parameters(), runs[1].model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_multi_step_at_dp4_equals_its_steps(jax_runs, no_dropout):
    initial = _jax_cached(jax_runs, "mnist")[0]
    stepped, losses, runner = _port_run("mnist", initial, 4, steps=3)
    _, twin, _, make_port, shape = TWINS["mnist"]
    model = make_port()
    model.load_state_dict(bridge.flax_state_dict(initial))
    fused = runner.init_state(model, twin.optimizer(lr=LR))
    multi = runner.train_multi_step(twin.loss)
    assert multi is runner.train_multi_step(twin.loss)
    fused, metrics = multi(fused, tstep.stack_batches(_batches(shape, 3)))
    assert fused.step == 3
    torch.testing.assert_close(metrics["loss"], losses, rtol=0, atol=0)
    for a, b in zip(fused.model.parameters(), stepped.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---- checkpoints and place_state ------------------------------------------


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_dp4_checkpoint_is_byte_equal_to_dp1_and_restores_at_dp2(
        tmp_path, jax_runs, no_dropout):
    """A dp4 state saves the files of the same state at dp1; a restore
    into a dp2 runner's state (the worker's path: restore, then
    place_state) holds the saved leaves bit for bit and trains on equal
    to the unresized dp4 run."""
    initial = _jax_cached(jax_runs, "cifar10")[0]
    _, twin, _, make_port, shape = TWINS["cifar10"]
    batches = _batches(shape, 4)
    saved = {}
    for n in (4, 1):
        state, _, _ = _port_run("cifar10", initial, n, steps=2)
        hook = CheckpointHook(checkpoint_dir=str(tmp_path / f"dp{n}"),
                              checkpoint_steps=1, async_save=False)
        assert hook.maybe_save(state)
        saved[n] = state
    files4, files1 = _files(tmp_path / "dp4"), _files(tmp_path / "dp1")
    assert files4 and files4 == files1
    want = state_io.named_leaves_from_state(saved[4])

    runner = MeshRunner(_tmesh(2))
    model = make_port()
    restored = runner.init_state(model, twin.optimizer(lr=LR), seed=9)
    restored = restore_from_dir(restored, str(tmp_path / "dp4"))
    restored = runner.place_state(restored)
    assert restored.optimizer.num_entries == 2
    got = state_io.named_leaves_from_state(restored)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # A restore into a plain single-device state lands whole; the
    # runner's place_state splits it.
    plain = init_train_state(make_port(), twin.optimizer(lr=LR))
    plain = restore_from_dir(plain, str(tmp_path / "dp4"))
    placed = MeshRunner(_tmesh(4))
    placed.init_state(make_port(), twin.optimizer(lr=LR))
    plain = placed.place_state(plain)
    assert isinstance(plain.optimizer, ZeroOptimizer)
    for key, value in state_io.named_leaves_from_state(plain).items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)
    # Both go on as the unresized run does.
    step = runner.train_step(twin.loss)
    for batch in batches[2:]:
        restored, m2 = step(restored, batch)
        saved[4], m4 = MeshRunner(_tmesh(4)).train_step(twin.loss)(
            saved[4], batch)
        assert m2["loss"].item() == m4["loss"].item()
    for a, b in zip(restored.model.parameters(),
                    saved[4].model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_lr_schedule_reaches_every_entry(jax_runs, no_dropout):
    """cifar10's LearningRateScheduler folded into the optimizer: dp4
    equals dp1 bit for bit, the one inner optimizer over the 4 entries'
    slices and the whole parameters steps the schedule, and
    seek_lr_schedule stands it at a restored version."""
    from elasticdl_tpu_torch.callbacks import (
        LearningRateScheduler,
        apply_callbacks_to_optimizer,
        seek_lr_schedule,
    )

    initial = _jax_cached(jax_runs, "cifar10")[0]
    _, twin, _, make_port, shape = TWINS["cifar10"]

    def schedule(version):
        return 1.0 if version < 2 else 0.1

    states = {}
    for n in (4, 1):
        model = make_port()
        model.load_state_dict(bridge.flax_state_dict(initial))
        runner = MeshRunner(_tmesh(n))
        tx = apply_callbacks_to_optimizer(
            twin.optimizer(lr=LR), [LearningRateScheduler(schedule)])
        state = runner.init_state(model, tx)
        step = runner.train_step(twin.loss)
        for batch in _batches(shape, 4):
            state, _ = step(state, batch)
        states[n] = state
    for a, b in zip(states[4].model.parameters(),
                    states[1].model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    inner = states[4].optimizer.inner
    views = {id(v) for g in inner.param_groups for v in g["params"]}
    # Every entry's slice of every split parameter, besides the whole ones.
    assert len(views) > sum(1 for _ in states[4].model.parameters())

    def rates():
        return {g["lr"] for g in inner.param_groups}

    assert rates() == {LR * 0.1}
    seek_lr_schedule(states[4].optimizer, 1)
    assert rates() == {LR}
    assert inner._lr_scheduler.last_epoch == 1


@pytest.mark.parametrize("batch_size", [8, 6])
def test_batch_shardings_match_jax(batch_size):
    """The transformer's batch rule (tokens over dp x sp, the mask over
    dp) and the default leading-dim rule, fitted to a dp4 mesh: the
    same spec leaf by leaf; a batch the axis does not divide stays
    whole under the rule (JAX's default path does not fit its spec, so
    it is compared at B 8 only). The port's step runs the global batch
    on the one device whatever the spec says (``place_batch``)."""
    from elasticdl_tpu.core.model_spec import get_model_spec as jax_spec
    from elasticdl_tpu.parallel.mesh_runner import (
        make_runner_for_spec as jax_runner_for_spec,
    )

    batch = {"features": np.zeros((batch_size, 16), np.int32),
             "labels": np.zeros((batch_size, 16), np.int32),
             "mask": np.ones((batch_size,), np.float32)}
    jm = jmesh.make_mesh((4,), ("dp",), devices=jax.devices()[:4])
    tm = _tmesh(4)
    jspec = jax_spec(os.path.join(REPO, "model_zoo"),
                     "transformer.transformer_lm.custom_model")
    tspec = get_model_spec(model_zoo_dir(),
                           "transformer.transformer_lm.custom_model",
                           device="cpu")
    pairs = [(jax_runner_for_spec(jspec, jm),
              make_runner_for_spec(tspec, tm))]
    if batch_size % 4 == 0:
        pairs.append((JaxRunner(mesh=jm), MeshRunner(tm)))
    for jr, tr in pairs:
        want = jr._shard_batch_tree(batch)
        got = tr.batch_shardings(batch)
        for key in batch:
            assert _strip(got[key].spec) == _strip(want[key].spec), key
        placed = tr.place_batch(batch)
        assert placed["features"].shape == (batch_size, 16)
