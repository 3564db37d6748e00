"""Tensor parallel and tables split as parameters, in one process: the
port's MeshRunner on a (2, 2, 2) dp/sp/tp mesh with the transformer's
rules against the JAX package's (tests/test_transformer.py:79-176), the
worker's MeshStrategy path through MiniCluster, a live resize from dp2
to dp2 x sp2 x tp2 with its checkpoint (tests/test_elastic_mesh_resize.py
:95), and a DenseFeatures table over 2 MB split over dp4
(tests/test_feature_column.py:238).

JAX runs on the conftest's virtual CPU devices, the port on ``[cpu] *
n`` meshes; weights start equal, carried across with ``bridge``.

Tolerances (f32):
- per-step losses: 2e-4, the JAX test's own
  (tests/test_transformer.py::test_mesh_training_matches_single_device);
- parameters after 3 Adam steps: within a hundredth of one step (lr /
  100), as tests/test_torch_mesh_runner.py holds the sp twin: Adam's
  m/sqrt(v) turns a gradient's f32 error near 0 into lr times its
  relative size. The key biases' true gradient is 0 (a bias shared by
  every key of a row leaves its softmax alone), so Adam steps them by
  noise on both sides: held to the steps' reach, 3 lr each way;
- the tp run against the port's unplaced run on the same mesh: losses
  1e-5 relative (the same math; the row-parallel sums add two partial
  products);
- the two MiniClusters' final loss and eval perplexity: 2e-4 relative
  after 8 Adam steps through tasks;
- the split table's model: losses rtol 1e-5, parameters 1e-6 (SGD: no
  division amplifies the rounding); against the port's whole table bit
  for bit.
"""

import importlib.util
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.checkpoint.saver import CheckpointSaver as JaxSaver
from elasticdl_tpu.core.train_state import init_train_state as jax_init
from elasticdl_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    TransformerLM as JaxLM,
    transformer_sharding_rules as jax_rules,
)
from elasticdl_tpu.parallel import mesh as jmesh
from elasticdl_tpu.parallel import rules as jrules
from elasticdl_tpu.parallel.mesh_runner import MeshRunner as JaxRunner
from elasticdl_tpu.preprocessing import feature_column as jfc
from elasticdl_tpu.testing.cluster import MiniCluster as JaxMiniCluster
from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.checkpoint import CheckpointHook, state_io
from elasticdl_tpu_torch.core import step as tstep
from elasticdl_tpu_torch.core.model_spec import get_model_spec
from elasticdl_tpu_torch.core.train_state import init_train_state
from elasticdl_tpu_torch.models.transformer import (
    TransformerLM,
    transformer_sharding_rules,
)
from elasticdl_tpu_torch.ops.losses import masked_next_token_cross_entropy
from elasticdl_tpu_torch.parallel import mesh as tmesh
from elasticdl_tpu_torch.parallel import rules as trules
from elasticdl_tpu_torch.parallel.mesh_runner import (
    MeshRunner,
    make_runner_for_spec,
)
from elasticdl_tpu_torch.parallel.rules import PartitionSpec as TP
from elasticdl_tpu_torch.parallel.tensor_parallel import (
    WHOLE,
    PlacedEmbedding,
    placement,
)
from elasticdl_tpu_torch.preprocessing import feature_column as pfc
from elasticdl_tpu_torch.testing import data as tdata
from elasticdl_tpu_torch.testing.cluster import MiniCluster

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-2
SHAPE, AXES = (2, 2, 2), ("dp", "sp", "tp")


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
    einsum ring), 64 head dim 16 (the kernel ring's plain versions)."""
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


def _adam(params):
    return torch.optim.Adam(params, lr=LR)


def _port_model(params, mesh=None):
    model = TransformerLM(bridge.config_from_params(
        params, compute_dtype=torch.float32), mesh=mesh)
    model.load_state_dict(bridge.state_dict_from_flax(params))
    return model


def _tp_runner(mesh):
    return MeshRunner(
        mesh, param_rule=trules.regex_param_rule(
            transformer_sharding_rules(), mesh=mesh),
        batch_rule=lambda path, leaf: (
            TP("dp", "sp") if getattr(leaf, "ndim", 0) == 2 else TP("dp")))


@pytest.fixture(scope="module", params=[32, 64], ids=["einsum", "kernel"])
def jax_tp_run(request):
    """JAX MeshRunner on the (2, 2, 2) mesh with the transformer rules, 3
    Adam steps: the initial params, the losses, the final params and
    the state's shardings."""
    jcfg = _cfg(request.param)
    mesh = jmesh.make_mesh(SHAPE, AXES, devices=jax.devices()[:8])
    init = jax_init(JaxLM(jcfg), optax.adam(LR), _batch(), seed=0)
    runner = JaxRunner(
        mesh=mesh, param_rule=jrules.regex_param_rule(jax_rules(),
                                                      mesh=mesh),
        batch_rule=_jax_zoo().batch_sharding_rule)
    state = runner.init_state(JaxLM(jcfg, mesh=mesh), optax.adam(LR),
                              _batch(), seed=0)
    state = state.replace(params=jax.device_put(
        jax.tree.map(np.array, init.params),
        jax.tree.map(lambda x: x.sharding, state.params)))
    specs = jax.tree.map(lambda x: x.sharding.spec, state.params)
    mu_specs = jax.tree.map(lambda x: x.sharding.spec, state.opt_state[0].mu)
    step = runner.train_step(_jax_zoo().loss)
    losses = []
    for i in range(3):
        state, metrics = step(state, _batch(seed=i))
        losses.append(float(metrics["loss"]))
    return (jax.tree.map(np.asarray, init.params), losses,
            jax.tree.map(np.asarray, state.params), specs, mu_specs)


def _port_run(runner, model, steps=3):
    state = runner.init_state(model, _adam, seed=0)
    step = runner.train_step(masked_next_token_cross_entropy)
    losses = [step(state, _batch(seed=i))[1]["loss"].item()
              for i in range(steps)]
    return state, losses


def _assert_params_close(got, want):
    for name, b in want.items():
        a = got[name]
        if name.endswith("attn.key.bias"):   # true gradient 0: Adam noise
            assert (a - b).abs().max() <= 2 * 3 * LR, name
            continue
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=LR / 100, err_msg=name)


def test_tp_twin_matches_jax_mesh_runner(jax_tp_run):
    init, want, final, _, _ = jax_tp_run
    mesh = tmesh.make_mesh(SHAPE, AXES, [CPU] * 8)
    runner = _tp_runner(mesh)
    state, losses = _port_run(runner, _port_model(init, mesh))
    np.testing.assert_allclose(losses, want, rtol=2e-4, atol=2e-4)
    assert placement(state.model.blocks[0].attn.query,
                     "weight").spec == TP("tp", None)
    _assert_params_close(state.model.state_dict(),
                         bridge.state_dict_from_flax(final))


def test_tp_run_matches_the_unplaced_run(jax_tp_run):
    """The tp layers entry by entry against the same mesh with no rule
    (every parameter whole): the same math."""
    init = jax_tp_run[0]
    mesh = tmesh.make_mesh(SHAPE, AXES, [CPU] * 8)
    tp_state, tp_losses = _port_run(_tp_runner(mesh),
                                    _port_model(init, mesh))
    whole_state, whole_losses = _port_run(MeshRunner(mesh),
                                          _port_model(init, mesh))
    assert placement(whole_state.model.blocks[0].attn.query,
                     "weight") is WHOLE
    np.testing.assert_allclose(tp_losses, whole_losses, rtol=1e-5)


def test_tp_layers_add_each_bias_once(jax_tp_run):
    """Every bias drawn nonzero (the seed's are zero, so a row-parallel
    bias added on each entry, or not at all, moves nothing at first):
    the tp layers' logits and gradients equal the unplaced model's."""
    init = jax_tp_run[0]
    mesh = tmesh.make_mesh(SHAPE, AXES, [CPU] * 8)
    gen = torch.Generator().manual_seed(0)
    weights = {k: torch.randn(v.shape, generator=gen) * 0.1
               if k.endswith("bias") else v
               for k, v in bridge.state_dict_from_flax(init).items()}
    tokens = torch.as_tensor(_batch()["features"])
    outs, grads = [], []
    for placed in (True, False):
        model = _port_model(init, mesh)
        model.load_state_dict(weights)
        if placed:
            _tp_runner(mesh).init_state(model, _adam)
            assert placement(model.blocks[0].mlp.wo, "weight") is not WHOLE
        out = model(tokens)
        out.square().mean().backward()
        outs.append(out.detach())
        grads.append({n: p.grad for n, p in model.named_parameters()})
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    for name, grad in grads[1].items():
        torch.testing.assert_close(grads[0][name], grad, rtol=1e-4,
                                   atol=1e-7, msg=name)


def _port_layout(name, spec):
    """A JAX parameter's spec in the port's layout (bridge's transposes:
    q/k/v kernels (d, H, Dh) -> (H*Dh, d), out (H, Dh, d) -> (d, H*Dh),
    Dense kernels (in, out) -> (out, in))."""
    spec = tuple(spec) + (None,) * 3
    if name.endswith(("query.weight", "key.weight", "value.weight")):
        return TP(spec[1], spec[0]).normalized()
    if name.endswith(("query.bias", "key.bias", "value.bias")):
        return TP(spec[0]).normalized()
    if name.endswith("attn.out.weight"):
        return TP(spec[2], spec[0]).normalized()
    if name.endswith("weight") and "ln" not in name and (
            "token_embed" not in name):
        return TP(spec[1], spec[0]).normalized()
    return TP(*spec).normalized()


def _flax_specs_by_port_name(tree):
    """``{port parameter name: spec}`` of a flax param tree of specs
    (bridge's names)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    names = {}
    for path, spec in flat:
        keys = [getattr(k, "key", str(k)) for k in path]
        names["/".join(keys)] = spec
    out = {}
    for key, spec in names.items():
        parts = key.split("/")
        if parts[0] == "token_embed":
            out["token_embed.weight"] = spec
        elif parts[0] == "pos_embed":
            out["pos_embed"] = spec
        elif parts[0].startswith("block_"):
            i = parts[0].split("_")[1]
            leaf = {"kernel": "weight", "scale": "weight"}.get(parts[-1],
                                                                parts[-1])
            out[".".join(["blocks", i] + parts[1:-1] + [leaf])] = spec
        else:
            leaf = {"kernel": "weight", "scale": "weight"}.get(parts[-1],
                                                                parts[-1])
            out[".".join(parts[:-1] + [leaf])] = spec
    return out


def test_param_and_slot_specs_match_jax(jax_tp_run):
    """Every parameter's spec in the port's layout, and each placed
    parameter's slots on its spec (tests/test_transformer.py:106-120:
    ``mu`` of ``wi`` on the spec of ``wi``)."""
    init, _, _, specs, mu_specs = jax_tp_run
    mesh = tmesh.make_mesh(SHAPE, AXES, [CPU] * 8)
    runner = _tp_runner(mesh)
    state = runner.init_state(_port_model(init, mesh), _adam)
    got = runner.state_shardings(state)
    want = {n: _port_layout(n, s)
            for n, s in _flax_specs_by_port_name(specs).items()}
    want_mu = {n: _port_layout(n, s)
               for n, s in _flax_specs_by_port_name(mu_specs).items()}
    names = dict(state.model.named_parameters())
    assert sorted(want) == sorted(names)
    assert want["blocks.0.mlp.wi.weight"] == TP("tp").normalized()
    for name in names:
        assert got[f"params.{name}"].spec.normalized() == want[name], name
        if not got[f"params.{name}"].is_replicated:
            assert (got[f"opt_state.{name}"].spec.normalized()
                    == want_mu[name] == want[name]), name


# ---- the worker's path and a live resize ---------------------------------

SEQ, VOCAB, BATCH = 32, 256, 16
JAX_ZOO = '''
import jax.numpy as jnp

from elasticdl_tpu.core.model_spec import load_module
from elasticdl_tpu.models.transformer import TransformerConfig, TransformerLM

_ref = load_module(REF_PATH)
loss, optimizer = _ref.loss, _ref.optimizer
dataset_fn, eval_metrics_fn = _ref.dataset_fn, _ref.eval_metrics_fn
param_sharding_rules = _ref.param_sharding_rules
batch_sharding_rule = _ref.batch_sharding_rule
CONFIG = TransformerConfig(vocab_size=256, d_model=64, n_heads=2,
                           n_layers=2, d_ff=128, max_len=32,
                           compute_dtype=jnp.float32)


def custom_model(mesh=None):
    return TransformerLM(CONFIG, mesh=mesh)
'''.replace("REF_PATH", repr(os.path.join(
    REPO, "model_zoo", "transformer", "transformer_lm.py")))
PORT_ZOO = '''
import torch

from elasticdl_tpu_torch.model_zoo.transformer import transformer_lm as twin
from elasticdl_tpu_torch.model_zoo.transformer.transformer_lm import (
    batch_sharding_rule, dataset_fn, eval_metrics_fn, loss, optimizer,
    param_sharding_rules)
from elasticdl_tpu_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(vocab_size=256, d_model=64, n_heads=2,
                           n_layers=2, d_ff=128, max_len=32,
                           compute_dtype=torch.float32)


def custom_model(device=None, mesh=None):
    return twin.custom_model(config=CONFIG, device=device, mesh=mesh)
'''


@pytest.fixture(scope="module")
def lm_zoo(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_zoo")
    zoo = root / "zoo"
    for name, src in (("jax_tp", JAX_ZOO), ("port_tp", PORT_ZOO)):
        (zoo / name).mkdir(parents=True)
        (zoo / name / "lm.py").write_text(textwrap.dedent(src))
    train = tdata.create_lm_record_file(str(root / "train.rec"), 128,
                                        seed=1, seq_len=SEQ, vocab=VOCAB)
    evalf = tdata.create_lm_record_file(str(root / "eval.rec"), 32,
                                        seed=2, seq_len=SEQ, vocab=VOCAB)
    return root, str(zoo), train, evalf


def _jax_initial_params(zoo):
    from elasticdl_tpu.core.model_spec import get_model_spec as jax_spec

    spec = jax_spec(zoo, "jax_tp.lm.custom_model")
    batch = {"features": np.zeros((BATCH, SEQ), np.int32)}
    return jax.tree.map(np.asarray, jax_init(
        spec.model, optax.adam(1e-3), batch, seed=0).params)


def test_minicluster_on_dp_sp_tp_matches_jax(lm_zoo):
    """MeshStrategy's path (MiniCluster(mesh=), as worker/main.py wires
    it: the zoo's rules through make_runner_for_spec, the model rebuilt
    for the mesh) on (2, 2, 2) against the JAX MiniCluster on the same
    mesh (tests/test_transformer.py:147-176), from the same weights."""
    _, zoo, train, evalf = lm_zoo
    common = dict(training_data=train, validation_data=evalf,
                  minibatch_size=BATCH, eval_steps=8)
    jax_cluster = JaxMiniCluster(
        zoo, "jax_tp.lm.custom_model",
        mesh=jmesh.make_mesh(SHAPE, AXES, devices=jax.devices()[:8]),
        **common)
    want = jax_cluster.run()[0]
    mesh = tmesh.make_mesh(SHAPE, AXES, [CPU] * 8)
    cluster = MiniCluster(zoo, "port_tp.lm.custom_model", device="cpu",
                          mesh=mesh, **common)
    cluster.spec.model.load_state_dict(bridge.state_dict_from_flax(
        _jax_initial_params(zoo)))
    got = cluster.run()[0]
    assert cluster.finished
    assert got["trained_batches"] == want["trained_batches"] == 8
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=2e-4)
    np.testing.assert_allclose(
        cluster.eval_service.completed_results[8]["perplexity"],
        jax_cluster.eval_service.completed_results[8]["perplexity"],
        rtol=2e-4)
    worker = cluster.workers[0]
    assert worker._spec.model.blocks[0].attn.mesh is mesh
    shardings = worker._step_runner.state_shardings(worker.state)
    assert shardings["params.blocks.0.mlp.wi.weight"].spec == TP("tp", None)
    assert shardings["opt_state.blocks.0.mlp.wi.weight"].spec == TP(
        "tp", None)


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_resize_dp2_to_dp_sp_tp_lands_tp_split(lm_zoo, tmp_path):
    """A live resize from dp2 to dp2 x sp2 x tp2 (the counterpart of
    tests/test_elastic_mesh_resize.py:95): the kernels land tp-split,
    every value survives, the run goes on as the one that never left
    dp2 does (within the tp run's tolerance), and its checkpoint holds
    the bytes the JAX saver writes for the same leaves; restored into a
    fresh state and placed on the mesh it holds them bit for bit."""
    _, zoo, _, _ = lm_zoo
    params = _jax_initial_params(zoo)
    spec = get_model_spec(zoo, "port_tp.lm.custom_model", device="cpu")
    mesh2 = tmesh.make_mesh((2,), ("dp",), [CPU] * 2)
    mesh8 = tmesh.make_mesh(SHAPE, AXES, [CPU] * 8)
    batches = [{k: v[:, :SEQ] if v.ndim == 2 else v for k, v in
                _batch(b=BATCH, s=SEQ, vocab=VOCAB, seed=i).items()}
               for i in range(4)]

    def start():
        runner = make_runner_for_spec(spec, mesh2)
        model = spec.make_model(mesh2)
        model.load_state_dict(bridge.state_dict_from_flax(params))
        state = runner.init_state(model, _adam, seed=0)
        step = runner.train_step(spec.loss)
        for b in batches[:2]:
            state, _ = step(state, b)
        return runner, state

    runner, state = start()
    before = state_io.named_leaves_from_state(state)
    state = runner.resize(mesh8, state, model=spec.make_model(mesh8))
    got = runner.state_shardings(state)
    assert got["params.blocks.0.mlp.wi.weight"].spec == TP("tp", None)
    assert got["params.blocks.0.attn.out.weight"].spec == TP(None, "tp")
    assert placement(state.model.blocks[0].mlp.wi,
                     "weight").num_shards == 2
    after = state_io.named_leaves_from_state(state)
    assert after.keys() == before.keys()
    for key in before:
        np.testing.assert_array_equal(after[key], before[key], err_msg=key)
    step = runner.train_step(spec.loss)
    ref_runner, ref = start()
    ref_step = ref_runner.train_step(spec.loss)
    for b in batches[2:]:
        state, m = step(state, b)
        ref, r = ref_step(ref, b)
        np.testing.assert_allclose(m["loss"].item(), r["loss"].item(),
                                   rtol=1e-5)
    hook = CheckpointHook(checkpoint_dir=str(tmp_path / "port"),
                          checkpoint_steps=1, async_save=False)
    assert hook.maybe_save(state)
    leaves = state_io.named_leaves_from_state(state)
    JaxSaver(str(tmp_path / "jax")).save(state.step, leaves)
    port_files, jax_files = (_files(tmp_path / "port"),
                             _files(tmp_path / "jax"))
    assert port_files and port_files == jax_files
    from elasticdl_tpu_torch.checkpoint import restore_from_dir

    fresh_runner = make_runner_for_spec(spec, mesh8)
    fresh = fresh_runner.init_state(spec.make_model(mesh8), _adam, seed=3)
    fresh = fresh_runner.place_state(
        restore_from_dir(fresh, str(tmp_path / "port")))
    for key, value in state_io.named_leaves_from_state(fresh).items():
        np.testing.assert_array_equal(value, leaves[key], err_msg=key)


# ---- a DenseFeatures table over 2 MB (tests/test_feature_column.py:238) ---


def _table_columns(m):
    return [m.numeric_column("x"),
            m.embedding_column(m.categorical_column_with_identity(
                "c", 1 << 15), 32)]


class _PortTableModel(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.features = pfc.DenseFeatures(_table_columns(pfc))
        self.Dense_0 = torch.nn.Linear(33, 1)

    def forward(self, features):
        return self.Dense_0(self.features(features))[..., 0]


def _table_batch(seed):
    rng = np.random.RandomState(seed)
    return {"features": {"x": rng.rand(8, 1).astype(np.float32),
                         "c": rng.randint(0, 1 << 15, (8, 2))
                         .astype(np.int32)},
            "labels": rng.rand(8).astype(np.float32),
            "mask": np.ones((8,), np.float32)}


def _sq_loss(labels, preds, mask):
    return torch.mean(torch.square(preds - labels) * mask)


@pytest.fixture(scope="module")
def jax_table_run():
    """The JAX test's model on dp4 (its 4 MB identity-column table split
    P("dp", None)), 3 SGD steps: the initial and final parameters in the
    port's names, and the losses."""
    from flax import linen as nn

    cols = _table_columns(jfc)

    class Model(nn.Module):
        @nn.compact
        def __call__(self, features, training=False):
            h = jfc.DenseFeatures(columns=cols, name="features")(features)
            return nn.Dense(1)(h)[..., 0]

    def jloss(labels, preds, mask):
        return jnp.mean(jnp.square(preds - labels) * mask)

    jm = jmesh.make_mesh((4,), ("dp",), devices=jax.devices()[:4])
    jrunner = JaxRunner(mesh=jm, donate_state=False)
    jstate = jrunner.init_state(Model(), optax.sgd(0.1), _table_batch(0),
                                seed=0)
    assert jstate.params["features"]["c_embedding"]["embedding"] \
        .sharding.spec[0] == "dp"
    start = bridge.flax_state_dict(jax.tree.map(np.array, jstate.params))
    jstep = jrunner.train_step(jloss)
    losses = []
    for i in range(3):
        jstate, metrics = jstep(jstate, _table_batch(i))
        losses.append(float(metrics["loss"]))
    return start, losses, bridge.flax_state_dict(
        jax.tree.map(np.array, jstate.params))


def _port_table_run(start, mesh):
    model = _PortTableModel()
    model.load_state_dict(start)
    runner = MeshRunner(mesh)
    state = runner.init_state(model, lambda p: torch.optim.SGD(p, lr=0.1))
    step = runner.train_step(_sq_loss)
    losses = [step(state, _table_batch(i))[1]["loss"].item()
              for i in range(3)]
    return runner, state, losses


def test_dense_features_table_split_over_dp_matches_jax(jax_table_run):
    """tests/test_feature_column.py:238 through the port on dp4: the
    table and its slots placed P("dp", None), 3 SGD steps from the same
    weights: losses and every parameter."""
    start, want, final = jax_table_run
    runner, state, losses = _port_table_run(
        start, tmesh.make_mesh((4,), ("dp",), [CPU] * 4))
    specs = runner.state_shardings(state)
    for kind in ("params", "opt_state"):
        assert specs[f"{kind}.features.c_embedding.embedding"].spec == TP(
            "dp", None)
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    got = state.model.state_dict()
    for name, value in final.items():
        np.testing.assert_allclose(got[name].numpy(), value, rtol=0,
                                   atol=1e-6, err_msg=name)


def test_split_table_run_equals_the_whole_table_run(jax_table_run):
    """The lookup over the row shards reads the rows a whole table does:
    dp4 against the plain step, bit for bit (one shard holds each row,
    the others add zeros)."""
    start = jax_table_run[0]
    _, state, losses = _port_table_run(
        start, tmesh.make_mesh((4,), ("dp",), [CPU] * 4))
    model = _PortTableModel()
    model.load_state_dict(start)
    plain = init_train_state(model, lambda p: torch.optim.SGD(p, lr=0.1))
    step = tstep.build_train_step(_sq_loss)
    want = [step(plain, _table_batch(i))[1]["loss"].item()
            for i in range(3)]
    assert losses == want
    for name, value in plain.model.state_dict().items():
        torch.testing.assert_close(state.model.state_dict()[name], value,
                                   rtol=0, atol=0)


def test_nn_embedding_table_is_split_and_read_by_rows():
    """A zoo's ``nn.Embedding`` over 2 MB (the rule takes its ``weight``
    as a table, as JAX's takes flax ``Embed``'s ``embedding``) is
    placed over dp; built as a ``PlacedEmbedding`` (the DeepFM zoo's
    tables) it is read by rows: the same rows and gradients as whole.
    The runner keeps the module's class."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(PlacedEmbedding(1 << 14, 64),
                                torch.nn.Embedding(1 << 14, 64))
    ids = torch.randint(0, 1 << 14, (6, 3))
    reference = torch.nn.Embedding(1 << 14, 64)
    reference.load_state_dict(model[0].state_dict())
    runner = MeshRunner(tmesh.make_mesh((2,), ("dp",), [CPU] * 2))
    state = runner.init_state(model, lambda p: torch.optim.SGD(p, lr=0.1))
    shardings = runner.state_shardings(state)
    for name in ("params.0.weight", "params.1.weight"):
        assert shardings[name].spec == TP("dp", None)
    assert type(model[0]) is PlacedEmbedding
    assert type(model[1]) is torch.nn.Embedding
    assert placement(model[0], "weight") == shardings["params.0.weight"]
    out = model[0](ids)
    torch.testing.assert_close(out, reference(ids), rtol=0, atol=0)
    out.square().sum().backward()
    reference(ids).square().sum().backward()
    torch.testing.assert_close(model[0].weight.grad, reference.weight.grad,
                               rtol=0, atol=0)


def test_shared_data_coordinate_is_refused_by_the_worker(monkeypatch):
    """Across processes, a mesh on which two processes share a data
    coordinate (tp or sp across them) raises at worker.main: their
    workers would pull different tasks into one batch."""
    from elasticdl_tpu_torch.worker import main as worker_main

    class TwoProcesses:
        spans_processes = True
        axis_names = ("dp", "tp")
        shape = {"dp": 1, "tp": 2}
        process_count = 2

        def block_of(self, axis):
            return (1, 0) if axis == "dp" else (2, 0)

    with pytest.raises(NotImplementedError, match="different tasks"):
        worker_main.refuse_shared_data(TwoProcesses(), "dp")

    class DataParallel(TwoProcesses):
        shape = {"dp": 2, "tp": 1}

        def block_of(self, axis):
            return (2, 0) if axis == "dp" else (1, 0)

    worker_main.refuse_shared_data(DataParallel(), "dp")


