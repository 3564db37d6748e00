"""Expert parallel in one process: the port's MeshRunner with the
transformer's rules on a (2, 4) dp x ep mesh of CPU entries against the
JAX package's MeshRunner on eight CPU devices
(tests/test_transformer.py::test_moe_expert_parallel, ::test_moe_scatter
_expert_parallel), dense and scatter dispatch; and on (2, 2, 2) dp x ep
x tp, where the experts split two dims (``moe/wi`` ``P("ep", None,
"tp")``, ``moe/wo`` ``P("ep", "tp", None)``): the run against JAX's, the
parameter and slot specs against JAX's ``state_shardings``, a checkpoint
saved and restored, and a live reshard.

Weights start equal (JAX's initial params carried across with
``bridge``). Tolerances, as tests/test_torch_tensor_parallel.py's (f32):
per-step losses 2e-4 (the JAX test's own); parameters after 3 Adam steps
within a hundredth of one step (lr / 100), the key biases (true gradient
0: Adam steps them by noise) within the steps' reach, 3 lr each way. The
scatter runs drop choices (capacity factor 1.0 over the global batch's
tokens, as JAX's one global program ranks them). Checkpoint and reshard
round trips are bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.core.train_state import init_train_state as jax_init
from elasticdl_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    TransformerLM as JaxLM,
    transformer_sharding_rules as jax_rules,
)
from elasticdl_tpu.parallel import mesh as jmesh
from elasticdl_tpu.parallel import rules as jrules
from elasticdl_tpu.parallel.mesh_runner import MeshRunner as JaxRunner
from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.checkpoint import CheckpointHook, state_io
from elasticdl_tpu_torch.models.transformer import (
    TransformerLM,
    transformer_sharding_rules,
)
from elasticdl_tpu_torch.ops.losses import masked_next_token_cross_entropy
from elasticdl_tpu_torch.parallel import mesh as tmesh
from elasticdl_tpu_torch.parallel import rules as trules
from elasticdl_tpu_torch.parallel.mesh_runner import MeshRunner
from elasticdl_tpu_torch.parallel.rules import PartitionSpec as TP
from elasticdl_tpu_torch.parallel.tensor_parallel import placement

CPU = torch.device("cpu")
LR = 1e-2
STEPS = 3
LAYOUTS = {"dp_ep": ((2, 4), ("dp", "ep")),
           "dp_ep_tp": ((2, 2, 2), ("dp", "ep", "tp"))}


def _cfg(dispatch):
    return JaxConfig(vocab_size=32, d_model=32, n_heads=4, n_layers=2,
                     d_ff=64, max_len=32, moe_experts=4, moe_every=2,
                     moe_dispatch=dispatch, moe_capacity_factor=1.0,
                     compute_dtype=jnp.float32)


def _batch(b=8, s=16, vocab=32, seed=0):
    """tests/test_transformer.py's +1-chain batch."""
    rng = np.random.RandomState(seed)
    start = rng.randint(0, vocab, (b, 1))
    seq = (start + np.arange(s + 1)[None, :]) % vocab
    return {"features": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32),
            "mask": np.ones((b,), np.float32)}


def _jax_batch_rule(path, leaf):
    name = jrules.path_str(path)
    if name in ("features", "labels") and getattr(leaf, "ndim", 0) == 2:
        return jax.sharding.PartitionSpec("dp", "sp")
    return jax.sharding.PartitionSpec("dp")


def _adam(params):
    return torch.optim.Adam(params, lr=LR)


def _port_cfg(jcfg):
    return bridge.config_from_params(
        _init_params(jcfg), compute_dtype=torch.float32,
        moe_top_k=jcfg.moe_top_k, moe_dispatch=jcfg.moe_dispatch,
        moe_capacity_factor=jcfg.moe_capacity_factor)


_INIT = {}


def _init_params(jcfg):
    if jcfg not in _INIT:
        _INIT[jcfg] = jax.tree.map(np.asarray, jax_init(
            JaxLM(jcfg), optax.adam(LR), _batch(), seed=0).params)
    return _INIT[jcfg]


def _port_model(jcfg, mesh=None):
    model = TransformerLM(_port_cfg(jcfg), mesh=mesh)
    model.load_state_dict(bridge.state_dict_from_flax(_init_params(jcfg)))
    return model


def _runner(mesh):
    return MeshRunner(
        mesh, param_rule=trules.regex_param_rule(
            transformer_sharding_rules(), mesh=mesh),
        batch_rule=lambda path, leaf: (
            TP("dp", "sp") if getattr(leaf, "ndim", 0) == 2 else TP("dp")))


@pytest.fixture(scope="module", params=[
    ("dp_ep", "dense"), ("dp_ep", "scatter"), ("dp_ep_tp", "scatter")],
    ids=["dp_ep-dense", "dp_ep-scatter", "dp_ep_tp-scatter"])
def jax_run(request):
    """JAX MeshRunner, 3 Adam steps from the shared initial params: the
    losses, the final params and the params' and ``mu``'s specs."""
    layout, dispatch = request.param
    jcfg = _cfg(dispatch)
    shape, axes = LAYOUTS[layout]
    mesh = jmesh.make_mesh(shape, axes, devices=jax.devices()[:8])
    runner = JaxRunner(mesh=mesh, param_rule=jrules.regex_param_rule(
        jax_rules(), mesh=mesh), batch_rule=_jax_batch_rule)
    state = runner.init_state(JaxLM(jcfg, mesh=mesh), optax.adam(LR),
                              _batch(), seed=0)
    state = state.replace(params=jax.device_put(
        jax.tree.map(np.array, _init_params(jcfg)),
        jax.tree.map(lambda x: x.sharding, state.params)))
    specs = jax.tree.map(lambda x: x.sharding.spec, state.params)
    mu_specs = jax.tree.map(lambda x: x.sharding.spec, state.opt_state[0].mu)
    step = runner.train_step(_jax_loss)
    losses = []
    for i in range(STEPS):
        state, metrics = step(state, _batch(seed=i))
        losses.append(float(metrics["loss"]))
    return (layout, jcfg, losses, jax.tree.map(np.asarray, state.params),
            specs, mu_specs)


def _jax_loss(labels, predictions, mask):
    from elasticdl_tpu.ops import masked_next_token_cross_entropy as jl

    return jl(labels, predictions, mask)


def _port_run(layout, jcfg):
    mesh = tmesh.make_mesh(*LAYOUTS[layout], [CPU] * 8)
    runner = _runner(mesh)
    state = runner.init_state(_port_model(jcfg, mesh), _adam, seed=0)
    step = runner.train_step(masked_next_token_cross_entropy)
    losses = [step(state, _batch(seed=i))[1]["loss"].item()
              for i in range(STEPS)]
    return runner, state, losses


def test_expert_parallel_matches_jax_mesh_runner(jax_run):
    layout, jcfg, want, final, _, _ = jax_run
    runner, state, losses = _port_run(layout, jcfg)
    np.testing.assert_allclose(losses, want, rtol=2e-4, atol=2e-4)
    moe = state.model.blocks[1].moe
    wi = placement(moe, "wi")
    assert wi.spec.normalized() == (TP("ep", None, "tp") if "tp" in layout
                                    else TP("ep")).normalized()
    assert wi.num_shards == 4      # ep 4, or ep 2 x tp 2
    if jcfg.moe_dispatch == "scatter":
        assert int(moe.dropped) > 0
    got = state.model.state_dict()
    for name, b in bridge.state_dict_from_flax(final).items():
        a = got[name]
        if name.endswith("attn.key.bias"):
            assert (a - b).abs().max() <= 2 * STEPS * LR, name
            continue
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=LR / 100, err_msg=name)


def _flax_specs_by_port_name(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    out = {}
    for path, spec in flat:
        keys = [getattr(k, "key", str(k)) for k in path]
        leaf = {"kernel": "weight", "scale": "weight"}.get(keys[-1],
                                                           keys[-1])
        if keys[0] == "token_embed":
            name = "token_embed.weight"
        elif keys[0].startswith("block_"):
            name = ".".join(["blocks", keys[0].split("_")[1]] + keys[1:-1]
                            + [leaf])
        else:
            name = ".".join(keys[:-1] + [leaf]) if len(keys) > 1 else leaf
        out[name] = _port_layout(name, spec)
    return out


def _port_layout(name, spec):
    """A JAX spec in the port's layout: bridge's transposes (q/k/v
    (d, H, Dh) -> (H*Dh, d), out (H, Dh, d) -> (d, H*Dh), Dense (in, out)
    -> (out, in)); the experts keep flax's layout."""
    spec = tuple(spec) + (None,) * 3
    if name.endswith(("moe.wi", "moe.wo")):
        return TP(*spec).normalized()
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


def test_param_and_slot_specs_match_jax(jax_run):
    """Every parameter's spec and each placed parameter's slots, as JAX's
    ``state_shardings`` (``mu`` of ``wi`` on ``wi``'s spec): on
    (2, 2, 2) the experts split two dims."""
    layout, jcfg, _, _, specs, mu_specs = jax_run
    mesh = tmesh.make_mesh(*LAYOUTS[layout], [CPU] * 8)
    runner = _runner(mesh)
    state = runner.init_state(_port_model(jcfg, mesh), _adam)
    got = runner.state_shardings(state)
    want = _flax_specs_by_port_name(specs)
    want_mu = _flax_specs_by_port_name(mu_specs)
    names = dict(state.model.named_parameters())
    assert sorted(want) == sorted(names)
    if layout == "dp_ep_tp":
        assert want["blocks.1.moe.wi"] == TP("ep", None, "tp")
        assert want["blocks.1.moe.wo"] == TP("ep", "tp")
        assert got["params.blocks.1.moe.wi"].dims == [0, 2]
    for name in names:
        assert got[f"params.{name}"].spec.normalized() == want[name], name
        if not got[f"params.{name}"].is_replicated:
            assert (got[f"opt_state.{name}"].spec.normalized()
                    == want_mu[name] == want[name]), name


def _two_dim_state():
    jcfg = _cfg("scatter")
    runner, state, _ = _port_run("dp_ep_tp", jcfg)
    return jcfg, runner, state


def test_two_dim_leaves_checkpoint_and_restore(tmp_path):
    """A (2, 2, 2) state's two-dim leaves (the experts and their Adam
    slots, held as four (ep, tp) shards each) gather for a checkpoint
    and a restore copies them back into the live shards bit for bit."""
    from elasticdl_tpu_torch.checkpoint import restore_from_dir
    from elasticdl_tpu_torch.parallel.mesh import ShardedTensor

    jcfg, runner, state = _two_dim_state()
    slots = {(n, s): v for n, s, v in state.optimizer.named_slots()}
    exp_avg = slots[("blocks.1.moe.wi", "exp_avg")]
    assert isinstance(exp_avg, ShardedTensor)
    assert exp_avg.shape == (4, 32, 64)
    assert [tuple(t.shape) for t in exp_avg.shards] == [(2, 32, 32)] * 4
    leaves = state_io.named_leaves_from_state(state)
    torch.testing.assert_close(
        torch.as_tensor(leaves["opt_state.blocks.1.moe.wi.exp_avg"]),
        torch.cat([torch.cat(exp_avg.shards[0:2], 2),
                   torch.cat(exp_avg.shards[2:4], 2)], 0), rtol=0, atol=0)
    hook = CheckpointHook(checkpoint_dir=str(tmp_path / "ckpt"),
                          checkpoint_steps=1, async_save=False)
    assert hook.maybe_save(state)
    mesh = tmesh.make_mesh(*LAYOUTS["dp_ep_tp"], [CPU] * 8)
    fresh_runner = _runner(mesh)
    fresh = fresh_runner.init_state(_port_model(jcfg, mesh), _adam, seed=3)
    fresh = fresh_runner.place_state(
        restore_from_dir(fresh, str(tmp_path / "ckpt")))
    for key, value in state_io.named_leaves_from_state(fresh).items():
        np.testing.assert_array_equal(value, leaves[key], err_msg=key)
    step = fresh_runner.train_step(masked_next_token_cross_entropy)
    ref_step = runner.train_step(masked_next_token_cross_entropy)
    _, got = step(fresh, _batch(seed=7))
    _, want = ref_step(state, _batch(seed=7))
    assert got["loss"].item() == want["loss"].item()


def test_two_dim_leaves_reshard_live():
    """A live resize from (2, 2, 2) dp x ep x tp to (1, 4, 2) and to the
    dp-only (2,): every leaf keeps its value, the experts land on the new
    placement, and the next step's loss is the unresized run's."""
    jcfg, runner, state = _two_dim_state()
    before = state_io.named_leaves_from_state(state)
    ref_runner, ref, _ = _port_run("dp_ep_tp", jcfg)
    ref_loss = ref_runner.train_step(masked_next_token_cross_entropy)(
        ref, _batch(seed=9))[1]["loss"].item()
    for shape, axes, spec, shards in (
            ((1, 4, 2), ("dp", "ep", "tp"), TP("ep", None, "tp"), 8),
            ((2,), ("dp",), TP("dp"), 2)):
        mesh = tmesh.make_mesh(shape, axes, [CPU] * int(np.prod(shape)))
        state = runner.resize(mesh, state,
                              model=_port_model(jcfg, mesh))
        got = runner.state_shardings(state)
        wi = got["opt_state.blocks.1.moe.wi"]
        assert wi.spec.normalized() == spec.normalized()
        assert wi.num_shards == shards
        after = state_io.named_leaves_from_state(state)
        assert after.keys() == before.keys()
        for key in before:
            np.testing.assert_array_equal(after[key], before[key],
                                          err_msg=key)
    loss = runner.train_step(masked_next_token_cross_entropy)(
        state, _batch(seed=9))[1]["loss"].item()
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)


def test_two_dim_leaf_of_a_plain_module_is_placed():
    """A rule splitting a plain ``Linear``'s weight over two axes places
    it and its slots (the refusal that waited for expert placement is
    gone): both gather to the whole tensor."""
    mesh = tmesh.make_mesh((2, 2), ("dp", "tp"), [CPU] * 4)

    def rule(name, leaf):
        return TP("dp", "tp") if name == "weight" else TP()

    runner = MeshRunner(mesh, param_rule=rule)
    torch.manual_seed(0)
    layer = torch.nn.Linear(4, 4)
    state = runner.init_state(layer, lambda p: torch.optim.SGD(
        p, lr=0.1, momentum=0.9))
    shardings = runner.state_shardings(state)
    assert shardings["params.weight"].dims == [0, 1]
    assert shardings["opt_state.weight"].spec == TP("dp", "tp")
    x = torch.randn(3, 4)
    state.model(x).square().sum().backward()
    state.optimizer.step()
    slots = dict(((n, s), v) for n, s, v in state.optimizer.named_slots())
    buf = slots[("weight", "momentum_buffer")]
    assert buf.shape == (4, 4)
    torch.testing.assert_close(buf.gather(), state.model.weight.grad)
