"""The six vision zoo twins (``elasticdl_tpu_torch/model_zoo/{mnist,
cifar10,resnet50}/``) against the JAX package's zoo modules, their
statistics through the steps, and their runs through the Local executor,
on the CPU.

Weights and statistics cross from flax through
``bridge.flax_state_dict``; inputs come from numpy seeds.
resnet50 and v2 run shallow (one block a stage) at 32×32, B 4; the JAX
v2 through a ``monkeypatch`` of its module's ``STAGES``. cifar10's
dropout is patched to the identity on both sides (the twin's dropout has
its own test below). Inputs are centred (standard normal, as normalised
images are): raw [0, 1) pixels put the stem's channels far from zero
mean, where the fast variance E[x²] − E[x]² in f32 loses digits to
cancellation in both packages.

- Forward, eval (running statistics drawn away from their initial
  values): logits at f32 within 1e-5 relative L2 (wiring; another
  summation order); in bf16, the zoo's compute dtype, within 2e-2, as
  the transformer's and the DeepFM twins' bf16 forwards (every product
  rounds to bf16; another order moves a rounding).
- Forward, training, f32: the running statistics after it within 1e-5;
  the logits within 1e-4: each BatchNorm normalises with its batch's own
  statistics, whose f32 rounding (XLA's sum over the (B, H, W) axes
  reads 4e-7 from float64 where PyTorch's reads 1.5e-7) is amplified by
  mean²/var and compounds through the chain (v2: 12 BatchNorms, its last
  stage normalising 4 values a channel; reads 1.8e-5, the others <= 7e-6).
- Three Local steps (each package's train step, the zoo's optimizer
  at its own learning rate) are held in float64 on both sides
  (``jax.enable_x64``; the layers the resnet modules pin to f32, their
  heads and v2's norms, set to f64 on both): every step's loss,
  gradients and running statistics, and the weights' change after, each
  tensor within 1e-5 relative (a conv bias that feeds a BatchNorm, whose
  true gradient is 0, against the whole). The resnets run f64
  throughout and read <= 1.1e-10; mnist's and cifar10's logits are
  rounded to f32 on both sides, as both zoos cast them, and the two f32
  softmax gradients differ by an ulp, which three momentum steps carry:
  they read <= 1.8e-6 a tensor (3.7e-7 whole). At f32 the two
  packages' trajectories cannot be held that close: the JAX package's
  own f32 gradients are up to 2% from its float64 ones after one step
  (cifar10_subclass at lr 1e-3; the port's f32 reads 1e-6 there), and
  v2 at its learning rate diverges from one f32 rounding within three
  steps.
"""

import os
import textwrap
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.core import step as jax_step
from elasticdl_tpu.core.model_spec import load_module
from elasticdl_tpu.core.train_state import TrainState as JaxState
from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.core import step as port_step
from elasticdl_tpu_torch.core.train_state import init_train_state
from elasticdl_tpu_torch.model_zoo.cifar10 import (
    cifar10_functional,
    cifar10_subclass,
)
from elasticdl_tpu_torch.model_zoo.mnist import (
    mnist_functional,
    mnist_subclass,
)
from elasticdl_tpu_torch.model_zoo.resnet50 import resnet50, resnet50_v2
from elasticdl_tpu_torch.models.batch_norm import BatchNorm
from elasticdl_tpu_torch.models.transformer import Dense
from elasticdl_tpu_torch.models.vision import Conv, max_pool, same_pads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ZOO = os.path.join(REPO, "model_zoo")
BATCH = 4
SHALLOW = (1, 1, 1, 1)
V2_STAGES = ((64, 1), (128, 1), (256, 1), (512, 1))
MNIST, CIFAR = (BATCH, 28, 28), (BATCH, 32, 32, 3)
# name -> (JAX zoo file, twin module, JAX model(module, dtype), twin
# model(dtype), feature shape)
TWINS = {
    "mnist_functional": (
        "mnist/mnist_functional.py", mnist_functional,
        lambda m, dt: m.MnistModel(compute_dtype=dt),
        lambda dt: mnist_functional.MnistModel(compute_dtype=dt), MNIST),
    "mnist_subclass": (
        "mnist/mnist_subclass.py", mnist_subclass,
        lambda m, dt: m.MnistSubclassModel(compute_dtype=dt),
        lambda dt: mnist_subclass.MnistSubclassModel(compute_dtype=dt),
        MNIST),
    "cifar10_functional": (
        "cifar10/cifar10_functional.py", cifar10_functional,
        lambda m, dt: m.Cifar10Model(compute_dtype=dt),
        lambda dt: cifar10_functional.Cifar10Model(compute_dtype=dt), CIFAR),
    "cifar10_subclass": (
        "cifar10/cifar10_subclass.py", cifar10_subclass,
        lambda m, dt: m.Cifar10SubclassModel(compute_dtype=dt),
        lambda dt: cifar10_subclass.Cifar10SubclassModel(compute_dtype=dt),
        CIFAR),
    "resnet50": (
        "resnet50/resnet50.py", resnet50,
        lambda m, dt: m.ResNet50(num_classes=10, stage_sizes=SHALLOW,
                                 space_to_depth=True, compute_dtype=dt,
                                 norm_dtype=dt),
        lambda dt: resnet50.ResNet50(num_classes=10, stage_sizes=SHALLOW,
                                     space_to_depth=True, compute_dtype=dt,
                                     norm_dtype=dt), CIFAR),
    "resnet50_v2": (
        "resnet50/resnet50_v2.py", resnet50_v2,
        lambda m, dt: m.ResNet50V2(compute_dtype=dt),
        lambda dt: resnet50_v2.ResNet50V2(compute_dtype=dt,
                                          stages=V2_STAGES), CIFAR),
}
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
TRAIN_LOGITS_TOL, STATS_TOL, F64_TOL = 1e-4, 1e-5, 1e-5


def rel(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().double().numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.fixture
def jax_zoo(monkeypatch):
    """``name -> the JAX zoo module``, loaded anew; v2 shallow, and
    flax's Dropout the identity."""
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, *args, **kwargs: x)

    def load(name):
        module = load_module(os.path.join(JAX_ZOO, TWINS[name][0]))
        if name == "resnet50_v2":
            monkeypatch.setattr(module, "STAGES", V2_STAGES)
        return module

    return load


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(cifar10_functional, "dropout",
                        lambda x, rate, generator, global_batch=None: x)


def _features(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _batches(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [{"features": rng.standard_normal(shape).astype(np.float32),
             "labels": rng.integers(0, 10, shape[0]).astype(np.int32),
             "mask": np.ones(shape[0], np.float32)} for _ in range(n)]


_INITIAL = {}


def _init(name, jax_zoo):
    """The JAX model's initial variables (numpy; flax keeps them in f32
    whatever the compute dtype), made once a twin and copied."""
    if name not in _INITIAL:
        _, _, make_jax, _, shape = TWINS[name]
        jmodel = make_jax(jax_zoo(name), jnp.float32)
        variables = jmodel.init({"params": jax.random.PRNGKey(1),
                                 "dropout": jax.random.PRNGKey(2)},
                                jnp.asarray(_features(shape, 0)))
        _INITIAL[name] = jax.tree.map(np.asarray, variables)
    return jax.tree.map(np.array, _INITIAL[name])


def _jitter(variables, seed):
    """Every BatchNorm's scale, bias and running statistics drawn away
    from their initial values (so eval reads real statistics and norm3's
    zero scale passes gradients)."""
    rng = np.random.default_rng(seed)

    def draw(node, low, high):
        return rng.uniform(low, high, np.shape(node)).astype(np.float32)

    def walk(params, stats):
        for key, node in params.items():
            if "scale" in node and isinstance(node["scale"], np.ndarray):
                node["scale"] = draw(node["scale"], 0.5, 1.5)
                node["bias"] = draw(node["bias"], -0.5, 0.5)
                stats[key]["mean"] = draw(stats[key]["mean"], -0.5, 0.5)
                stats[key]["var"] = draw(stats[key]["var"], 0.5, 2.0)
            elif isinstance(node, dict) and "kernel" not in node:
                walk(node, stats[key])

    walk(variables["params"], variables["batch_stats"])
    return variables


def _stats(variables):
    return bridge.flax_state_dict(
        {"params": {}, "batch_stats": variables["batch_stats"]})


# ---- the forward ---------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(TWINS))
def test_vision_twin_forward_matches_jax(name, dtype, jax_zoo, no_dropout):
    jdt, tdt, tol = DTYPES[dtype]
    _, _, make_jax, make_port, shape = TWINS[name]
    jmodel = make_jax(jax_zoo(name), jdt)
    x = _features(shape, 0)
    variables = _jitter(_init(name, jax_zoo), 1)
    model = make_port(tdt)
    model.load_state_dict(bridge.flax_state_dict(variables))
    want = jmodel.apply(variables, jnp.asarray(x), training=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (BATCH, 10)
    assert rel(got, want) <= tol
    if dtype == "bfloat16":
        return
    want, updates = jmodel.apply(variables, jnp.asarray(x), training=True,
                                 mutable=["batch_stats"])
    kwargs = ({"generator": torch.Generator().manual_seed(0)}
              if name == "cifar10_functional" else {})
    with torch.no_grad():
        got = model.train()(torch.from_numpy(x), **kwargs)
    assert rel(got, want) <= TRAIN_LOGITS_TOL
    want_stats = _stats(jax.tree.map(np.asarray, updates))
    state = model.state_dict()
    assert sorted(want_stats) == sorted(
        k for k in state if k.endswith((".mean", ".var")))
    for key, value in want_stats.items():
        assert rel(state[key], value) <= STATS_TOL, key


def test_same_padding_is_flax_asymmetric_padding():
    """flax's "SAME" at stride 2 pads (total // 2, the rest): v2's 7×7/s2
    stem at 224 pads (2, 3), a 3×3/s2 at an even input (0, 1), the stems'
    3×3/s2 max pool at 112 (0, 1) with -inf; the twin's Conv and
    max_pool match flax's there, and a symmetric padding would not."""
    assert same_pads(224, 7, 2) == (2, 3)
    assert same_pads(56, 3, 2) == (0, 1)
    assert same_pads(112, 3, 2) == (0, 1)
    assert same_pads(28, 3, 1) == (1, 1)
    assert same_pads(56, 1, 2) == (0, 0)
    rng = np.random.default_rng(0)
    for (b, hw, cin, cout, k, s) in ((1, 224, 3, 64, 7, 2),
                                     (2, 56, 8, 16, 3, 2)):
        x = rng.standard_normal((b, hw, hw, cin)).astype(np.float32)
        flax_conv = fnn.Conv(cout, (k, k), strides=(s, s), use_bias=False)
        variables = flax_conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
        want = np.asarray(flax_conv.apply(variables, jnp.asarray(x)))
        conv = Conv(cin, cout, k, s, use_bias=False)
        conv.load_state_dict(bridge.flax_state_dict(
            jax.tree.map(np.asarray, variables)))
        with torch.no_grad():
            got = conv(torch.from_numpy(x))
            symmetric = torch.nn.functional.conv2d(
                torch.from_numpy(x).permute(0, 3, 1, 2), conv.weight,
                stride=s, padding=k // 2).permute(0, 2, 3, 1)
        assert got.shape == want.shape
        assert rel(got, want) <= 1e-5
        assert rel(symmetric, want) > 1e-2
    x = rng.standard_normal((2, 112, 112, 4)).astype(np.float32)
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                   padding="SAME"))
    got = max_pool(torch.from_numpy(x), 3, 2, "SAME")
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    symmetric = torch.nn.functional.max_pool2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, padding=1)
    assert not np.array_equal(symmetric.permute(0, 2, 3, 1).numpy(), want)


# ---- three Local steps in float64 -----------------------------------------


class _Float64Numpy(types.SimpleNamespace):
    """A JAX zoo module's ``jnp`` whose ``float32`` is float64: the
    layers the zoo pins to f32 then run in f64."""


def _f64_numpy():
    names = {n: getattr(jnp, n) for n in dir(jnp) if not n.startswith("__")}
    names["float32"] = jnp.float64
    return _Float64Numpy(**names)


def _float64_twin(model):
    """The twin (built at compute dtype f64) with its f32-pinned layers
    (BatchNorms, Dense heads) in f64 too."""
    model = model.double()
    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.dtype = torch.float64
        if isinstance(module, Dense):
            module.compute_dtype = torch.float64
    return model


def _grads_close(got, want):
    """{name: tensor} against {name: tensor or array}: the whole within
    F64_TOL relative, and each tensor."""
    want = {k: np.asarray(v, np.float64) for k, v in want.items()}
    keys = sorted(want)
    assert sorted(got) == keys
    whole = np.linalg.norm(np.concatenate([want[k].ravel() for k in keys]))
    assert rel(np.concatenate([got[k].double().numpy().ravel()
                               for k in keys]),
               np.concatenate([want[k].ravel() for k in keys])) <= F64_TOL
    for k in keys:
        # A conv bias feeding a BatchNorm has a true gradient of 0: each
        # side reads rounding noise there, held against the whole.
        floor = max(np.linalg.norm(want[k]), 1e-3 * whole)
        err = np.linalg.norm(got[k].double().numpy() - want[k])
        assert err <= F64_TOL * floor, k


@pytest.mark.parametrize("name", sorted(TWINS))
def test_vision_twin_local_steps_match_jax_in_float64(name, jax_zoo,
                                                      no_dropout,
                                                      monkeypatch):
    _, twin, make_jax, make_port, shape = TWINS[name]
    jmod = jax_zoo(name)
    if name.startswith("resnet50"):
        monkeypatch.setattr(jmod, "jnp", _f64_numpy())
    batches = [dict(b, features=b["features"].astype(np.float64))
               for b in _batches(shape, 2)]
    with jax.enable_x64(True):
        jmodel = make_jax(jmod, jnp.float64)
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                 _jitter(_init(name, jax_zoo), 3))
        jstate = JaxState.create(apply_fn=jmodel.apply,
                                 params=variables["params"],
                                 tx=jmod.optimizer(),
                                 batch_stats=variables["batch_stats"])
        jtrain = jax_step.build_train_step(jmod.loss)
        jgrad = jax_step.build_grad_step(jmod.loss)
        model = _float64_twin(make_port(torch.float64))
        model.load_state_dict(bridge.flax_state_dict(variables))
        state = init_train_state(model, twin.optimizer())
        train = port_step.build_train_step(twin.loss)
        grad = port_step.build_grad_step(twin.loss)
        for batch in batches:
            want_grads, _ = jgrad(jstate, batch, jax.random.PRNGKey(0))
            got_grads, _ = grad(state, batch)
            _grads_close(got_grads, bridge.flax_state_dict(
                jax.tree.map(np.asarray, want_grads)))
            jstate, jmetrics = jtrain(jstate, batch)
            state, metrics = train(state, batch)
            assert rel(float(metrics["loss"]), float(jmetrics["loss"])) \
                <= F64_TOL
            want_stats = _stats({"batch_stats": jax.tree.map(
                np.asarray, jstate.batch_stats)})
            assert sorted(state.batch_stats) == sorted(want_stats)
            for key, value in want_stats.items():
                assert rel(state.batch_stats[key], value) <= F64_TOL, key
        want = bridge.flax_state_dict(
            jax.tree.map(np.asarray, jstate.params))
        got = model.state_dict()
        start = bridge.flax_state_dict(variables)
        _grads_close({k: got[k] - start[k] for k in want},
                     {k: want[k] - start[k] for k in want})


# ---- the twins through the Local executor ---------------------------------

# A zoo module that builds a resnet twin shallow for the CPU runs.
SHALLOW_ZOO = '''
from elasticdl_tpu_torch.models.vision import place
from elasticdl_tpu_torch.model_zoo.resnet50 import NAME as twin
from elasticdl_tpu_torch.model_zoo.resnet50.NAME import (
    dataset_fn, eval_metrics_fn, loss, optimizer)


def custom_model(device=None):
    return place(twin.BUILD, device)
'''
SHALLOW_BUILDS = {
    "resnet50": "ResNet50(num_classes=10, stage_sizes=(1, 1, 1, 1), "
                "space_to_depth=True)",
    "resnet50_v2": "ResNet50V2(stages=((64, 1), (128, 1), (256, 1), "
                   "(512, 1)))",
}


def _zoo_and_def(name, tmp_path):
    """(model_zoo dir, model_def) of the twin: the port's zoo, or a
    shallow resnet module written under ``tmp_path``."""
    from elasticdl_tpu_torch.testing.data import model_zoo_dir

    if name not in SHALLOW_BUILDS:
        family = name.split("_")[0]
        return model_zoo_dir(), f"{family}.{name}.custom_model"
    zoo = tmp_path / "zoo" / "shallow"
    zoo.mkdir(parents=True)
    (zoo / f"{name}.py").write_text(textwrap.dedent(
        SHALLOW_ZOO.replace("NAME", name).replace(
            "BUILD", SHALLOW_BUILDS[name])))
    return str(tmp_path / "zoo"), f"shallow.{name}.custom_model"


@pytest.mark.parametrize("name", sorted(TWINS))
def test_vision_twin_trains_through_the_local_executor(name, tmp_path):
    """16 records at B 8 for one epoch (2 steps), eval at the end with
    the running statistics, and the ``--output`` bundle: its weights
    carry the statistics, its ``model_def`` names the module, and the
    bundle served (eval mode) answers as the trained model's eval
    forward."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.core.model_spec import load_model_zoo_module
    from elasticdl_tpu_torch.serving.export import META_FILE, PARAMS_FILE
    from elasticdl_tpu_torch.serving.model_store import load_served_model
    from elasticdl_tpu_torch.testing import data as tdata

    make = (tdata.create_mnist_record_file if name.startswith("mnist")
            else tdata.create_cifar_record_file)
    train = make(str(tmp_path / "train.rec"), 16, seed=1)
    valid = make(str(tmp_path / "eval.rec"), 8, seed=2)
    zoo, model_def = _zoo_and_def(name, tmp_path)
    out = str(tmp_path / "bundle")
    args = tdata.make_local_args(zoo, model_def, train,
                                 validation_data=valid, minibatch_size=8,
                                 extra=["--device", "cpu", "--output", out])
    executor = LocalExecutor(args)
    result = executor.run()
    assert result["steps"] == 2 and np.isfinite(result["final_loss"])
    assert 0.0 <= result["eval_metrics"]["accuracy"] <= 1.0
    stats = executor.state.batch_stats
    means = [v for k, v in stats.items() if k.endswith(".mean")]
    assert means and all(bool((m != 0).any()) for m in means)
    saved = torch.load(os.path.join(out, PARAMS_FILE), weights_only=True)
    for key, value in stats.items():
        assert torch.equal(saved[key], value), key
    with open(os.path.join(out, META_FILE)) as f:
        import json

        assert json.load(f)["model_def"] == model_def
    module, fn_name = load_model_zoo_module(zoo, model_def)
    served = load_served_model(
        out, device="cpu",
        model_fn=lambda: getattr(module, fn_name)(device="cpu"))
    features = executor.last_batch["features"]
    with torch.no_grad():
        want = executor.state.model.eval()(torch.from_numpy(features))
    np.testing.assert_array_equal(served.predict(features), want.numpy())


JAX_MNIST_ZOO = '''
import jax.numpy as jnp

from elasticdl_tpu.core.model_spec import load_module

_ref = load_module(REF)
loss, optimizer = _ref.loss, _ref.optimizer
dataset_fn, eval_metrics_fn = _ref.dataset_fn, _ref.eval_metrics_fn


def custom_model():
    return _ref.MnistModel(compute_dtype=jnp.float32)
'''

PORT_MNIST_ZOO = '''
import torch

from elasticdl_tpu_torch.model_zoo.mnist import mnist_functional as twin
from elasticdl_tpu_torch.model_zoo.mnist.mnist_functional import (
    dataset_fn, eval_metrics_fn, loss, optimizer)


def custom_model(device=None):
    return twin.MnistModel(compute_dtype=torch.float32).to(device)
'''


def test_mnist_executor_losses_match_jax_executor(tmp_path):
    """f32 twins of the mnist_functional zoo modules, 64 records at B 16
    (4 SGD-momentum steps) through each package's LocalExecutor from the
    JAX executor's initial variables (weights and statistics carried
    into the port before its first step): per-step losses within 1e-4
    relative (per-step gradients agree to ~1e-6, the momentum carries
    them), the running statistics after the run within 1e-4, the eval
    accuracy equal."""
    from elasticdl_tpu.api.local_executor import LocalExecutor as JaxExec
    from elasticdl_tpu.testing import data as jdata
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.callbacks import Callback
    from elasticdl_tpu_torch.testing import data as tdata

    train = tdata.create_mnist_record_file(str(tmp_path / "train.rec"), 64,
                                           seed=1)
    valid = tdata.create_mnist_record_file(str(tmp_path / "eval.rec"), 32,
                                           seed=2)
    zoo = tmp_path / "zoo"
    for pkg, src in (("jax_f32", JAX_MNIST_ZOO), ("port_f32", PORT_MNIST_ZOO)):
        (zoo / pkg).mkdir(parents=True)
        (zoo / pkg / "mnist.py").write_text(textwrap.dedent(src.replace(
            "REF", repr(os.path.join(JAX_ZOO, "mnist",
                                     "mnist_functional.py")))))
    jargs = jdata.make_local_args(str(zoo), "jax_f32.mnist.custom_model",
                                  train, str(tmp_path / "jax"),
                                  validation_data=valid, minibatch_size=16)
    jex = JaxExec(jargs)
    jax_losses, start = [], {}
    orig_init = jex._maybe_init_state

    def init(batch):
        if jex.state is None:
            orig_init(batch)
            real_step = jex._train_step
            start["variables"] = jax.tree.map(np.asarray, {
                "params": jex.state.params,
                "batch_stats": jex.state.batch_stats})

            def record(state, b):
                state, metrics = real_step(state, b)
                jax_losses.append(float(metrics["loss"]))
                return state, metrics

            jex._train_step = record

    jex._maybe_init_state = init
    want = jex.run()
    want_stats = _stats({"batch_stats": jax.tree.map(
        np.asarray, jex.state.batch_stats)})

    losses = []

    class Carry(Callback):
        def on_train_batch_begin(self, owner=None):
            if owner.state.step == 0:
                owner.state.model.load_state_dict(
                    bridge.flax_state_dict(start["variables"]))

        def on_train_batch_end(self, owner=None, metrics=None):
            losses.append(float(metrics["loss"]))

    args = tdata.make_local_args(str(zoo), "port_f32.mnist.custom_model",
                                 train, validation_data=valid,
                                 minibatch_size=16,
                                 extra=["--device", "cpu"])
    executor = LocalExecutor(args, callbacks=[Carry()])
    got = executor.run()
    assert got["steps"] == want["steps"] == 4
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    for key, value in want_stats.items():
        assert rel(executor.state.batch_stats[key], value) <= 1e-4, key
    assert got["eval_metrics"]["accuracy"] == pytest.approx(
        want["eval_metrics"]["accuracy"])


# ---- cifar10's dropout and learning-rate schedule --------------------------


def test_cifar10_dropout_is_seeded_from_the_state_generator():
    """Training draws the masks from the caller's CPU generator (same
    seed, same output; another seed, another), eval applies none, and a
    training forward without a generator refuses."""
    torch.manual_seed(0)
    model = cifar10_functional.Cifar10Model(compute_dtype=torch.float32)
    x = torch.from_numpy(_features(CIFAR, 4))
    with torch.no_grad():
        model.train()
        a = model(x, generator=torch.Generator().manual_seed(3))
        b = model(x, generator=torch.Generator().manual_seed(3))
        c = model(x, generator=torch.Generator().manual_seed(4))
        assert torch.equal(a, b) and not torch.equal(a, c)
        with pytest.raises(ValueError, match="generator"):
            model(x)
        model.eval()
        assert torch.equal(model(x), model(x))


def test_cifar10_learning_rate_schedule_matches_jax():
    """The version-based multiplier (1.0, 0.1 from version 200, 0.01
    from 400) equals the JAX module's, and drives the optimizer's rate
    through the port's LearningRateScheduler."""
    from elasticdl_tpu_torch.callbacks import apply_callbacks_to_optimizer

    jmod = load_module(os.path.join(JAX_ZOO, "cifar10",
                                    "cifar10_functional.py"))
    jax_schedule = jmod.callbacks()[0].schedule
    versions = (0, 199, 200, 399, 400, 1000)
    assert [cifar10_functional.lr_multiplier(v) for v in versions] == \
        pytest.approx([float(jax_schedule(v)) for v in versions])
    weight = torch.nn.Parameter(torch.zeros(2))
    optimizer = apply_callbacks_to_optimizer(
        cifar10_functional.optimizer(), cifar10_functional.callbacks())(
        [weight])
    rates = []
    for _ in range(401):
        rates.append(optimizer.param_groups[0]["lr"])
        weight.grad = torch.ones(2)
        optimizer.step()
    assert rates[199] == pytest.approx(0.1)
    assert rates[200] == pytest.approx(0.01)
    assert rates[400] == pytest.approx(0.001)
