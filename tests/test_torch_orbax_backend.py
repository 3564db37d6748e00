"""The port's multi-host checkpoint backend (``checkpoint/orbax_backend``,
``torch.distributed.checkpoint`` under the JAX backend's names), in one
process: the cases of tests/test_orbax_backend.py against the port, the
hook and ``restore_from_dir`` routing, and both packages' restored
leaves for the same carried state.

States are the port's MeshRunner states of the f32 transformer with the
transformer's rules on a (2, 2, 2) dp/sp/tp mesh of ``[cpu] * 8``
entries (tp-split kernels, ZeRO-split Adam slots), trained a step so
the slots exist, and a device-sparse state whose table is row-split.
Restores are bit-equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.checkpoint.orbax_backend import OrbaxSaver as JaxOrbax
from elasticdl_tpu.checkpoint.orbax_backend import (
    restore_state as jax_restore,
)
from elasticdl_tpu.checkpoint.orbax_backend import save_state as jax_save
from elasticdl_tpu.models.transformer import TransformerConfig as JaxConfig
from elasticdl_tpu.models.transformer import TransformerLM as JaxLM
from elasticdl_tpu.models.transformer import (
    transformer_sharding_rules as jax_rules,
)
from elasticdl_tpu.parallel import rules as jrules
from elasticdl_tpu.parallel.mesh import make_mesh as jax_mesh
from elasticdl_tpu.parallel.mesh_runner import MeshRunner as JaxRunner
from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.checkpoint import (
    CheckpointHook,
    has_valid_checkpoint,
    restore_from_dir,
)
from elasticdl_tpu_torch.checkpoint.orbax_backend import (
    OrbaxSaver,
    restore_state,
    save_state,
)
from elasticdl_tpu_torch.checkpoint.state_io import named_leaves_from_state
from elasticdl_tpu_torch.core.train_state import init_train_state
from elasticdl_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    transformer_sharding_rules,
)
from elasticdl_tpu_torch.ops.losses import masked_next_token_cross_entropy
from elasticdl_tpu_torch.parallel import rules
from elasticdl_tpu_torch.parallel.mesh import ShardedTensor, make_mesh
from elasticdl_tpu_torch.parallel.mesh_runner import MeshRunner
from tests.test_torch_orbax_backend_procs import sparse_state

CPU = torch.device("cpu")
CFG = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=1, d_ff=64,
           max_len=32)


def _batch(b=8, s=16, seed=0):
    rng = np.random.RandomState(seed)
    seq = rng.randint(0, 32, (b, s + 1))
    return {"features": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32),
            "mask": np.ones((b,), np.float32)}


def _mesh_state(shape=(2, 2, 2), axes=("dp", "sp", "tp"), seed=0,
                steps=1, init=None):
    mesh = make_mesh(shape, axes, [CPU] * int(np.prod(shape)))
    torch.manual_seed(seed)
    model = TransformerLM(TransformerConfig(compute_dtype=torch.float32,
                                            **CFG), mesh=mesh)
    if init is not None:
        model.load_state_dict(init)
    runner = MeshRunner(mesh, param_rule=rules.regex_param_rule(
        transformer_sharding_rules(), mesh=mesh))
    state = runner.init_state(model, lambda p: torch.optim.Adam(
        p, lr=1e-2), seed=0)
    step = runner.train_step(masked_next_token_cross_entropy)
    for i in range(steps):
        state, _ = step(state, _batch(seed=i))
    return runner, state


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)


def test_dcp_roundtrip_keeps_placement_and_slots(tmp_path):
    runner, state = _mesh_state()
    state.step += 7
    saver = OrbaxSaver(str(tmp_path))
    save_state(saver, state)
    assert saver.get_valid_latest_version() == 8
    assert os.path.exists(tmp_path / "orbax-8" / ".metadata")

    runner2, fresh = _mesh_state(seed=5, steps=0)
    restored = restore_state(OrbaxSaver(str(tmp_path)), fresh)
    assert restored is fresh and restored.step == 8
    # The placement is the fresh state's own.
    assert runner2.param_shardings(restored.model)[
        "blocks.0.mlp.wi.weight"].spec == rules.PartitionSpec("tp", None)
    # Every leaf bit-equal: parameters, Adam's slots (created in the
    # fresh optimizer), the step and the generator.
    _assert_same(named_leaves_from_state(restored),
                 named_leaves_from_state(state))


def test_dcp_restore_onto_another_layout(tmp_path):
    """Saved on dp/sp/tp, restored onto a dp-only mesh and onto one
    unplaced model."""
    _, state8 = _mesh_state()
    state8.step += 3
    saver = OrbaxSaver(str(tmp_path))
    save_state(saver, state8)
    saver.wait()
    want = named_leaves_from_state(state8)

    _, state4 = _mesh_state((4,), ("dp",), seed=9, steps=0)
    restored = restore_state(OrbaxSaver(str(tmp_path)), state4)
    assert restored.step == 4
    _assert_same(named_leaves_from_state(restored), want)

    torch.manual_seed(3)
    plain = init_train_state(
        TransformerLM(TransformerConfig(compute_dtype=torch.float32, **CFG)),
        lambda p: torch.optim.Adam(p, lr=1e-2))
    restored = restore_state(OrbaxSaver(str(tmp_path)), plain)
    _assert_same(named_leaves_from_state(restored), want)


def test_dcp_row_split_table_onto_any_layout(tmp_path):
    """A table and its Adagrad slot table row-split over dp4 (written as
    their shards' parts), restored onto dp4, onto dp2 and onto one
    unsharded state."""
    state = sparse_state(make_mesh((4,), ("dp",), [CPU] * 4), steps=2)
    assert isinstance(state.tables["items"], ShardedTensor)
    assert len(state.tables["items"].shards) == 4
    saver = OrbaxSaver(str(tmp_path))
    save_state(saver, state)
    saver.wait()
    want = named_leaves_from_state(state)
    for mesh in (make_mesh((4,), ("dp",), [CPU] * 4),
                 make_mesh((2,), ("dp",), [CPU] * 2), None):
        restored = restore_state(OrbaxSaver(str(tmp_path)),
                                 sparse_state(mesh, seed=5))
        assert restored.step == 2
        _assert_same(named_leaves_from_state(restored), want)


def test_dcp_gc_keeps_max_and_counts_no_write_in_progress(tmp_path):
    _, state = _mesh_state((2,), ("dp",))
    saver = OrbaxSaver(str(tmp_path), keep_max=2)
    for version in (1, 2, 3, 4):
        state.step = version
        save_state(saver, state)
    saver.wait()
    assert saver.versions() == [3, 4]
    # A write in progress is not a version (nor pruned by one).
    (tmp_path / "orbax-9.dcp-tmp").mkdir()
    assert saver.versions() == [3, 4]
    state.step = 5
    save_state(saver, state)
    saver.wait()
    assert saver.versions() == [4, 5]
    assert (tmp_path / "orbax-9.dcp-tmp").is_dir()


def test_dcp_restore_missing_raises(tmp_path):
    saver = OrbaxSaver(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        saver.restore_tree({})
    _, state = _mesh_state((2,), ("dp",))
    save_state(saver, state)
    with pytest.raises(FileNotFoundError):
        restore_state(saver, state, version=99)


def test_restore_from_dir_routes_to_dcp(tmp_path):
    """The generic restore entry routes to this backend where the dir
    holds orbax versions, and honours required=False over a dir with
    only torn writes."""
    _, state = _mesh_state()
    state.step += 5
    saver = OrbaxSaver(str(tmp_path))
    save_state(saver, state)
    saver.wait()
    assert has_valid_checkpoint(str(tmp_path))

    _, fresh = _mesh_state(seed=4, steps=0)
    restored = restore_from_dir(fresh, str(tmp_path))
    assert restored.step == 6
    _assert_same(named_leaves_from_state(restored),
                 named_leaves_from_state(state))

    torn = tmp_path / "torn"
    torn.mkdir()
    (torn / "orbax-3.dcp-tmp").mkdir()
    (torn / "orbax-3.orbax-checkpoint-tmp-123").mkdir()
    assert not has_valid_checkpoint(str(torn))
    _, fresh2 = _mesh_state(seed=4, steps=0)
    out = restore_from_dir(fresh2, str(torn), required=False)
    assert out.step == 0   # started fresh, no crash
    with pytest.raises(FileNotFoundError):
        restore_from_dir(fresh2, str(torn))


def test_hook_orbax_backend_saves_every_interval(tmp_path):
    runner, state = _mesh_state((2, 2), ("dp", "tp"), steps=0)
    step = runner.train_step(masked_next_token_cross_entropy)
    hook = CheckpointHook(str(tmp_path), checkpoint_steps=2,
                          backend="orbax", keep_max=5)
    for i in range(5):
        state, _ = step(state, _batch(seed=i))
        hook.maybe_save(state)
    hook.save_final(state)
    assert OrbaxSaver(str(tmp_path)).versions() == [2, 4, 5]
    _, fresh = _mesh_state((2, 2), ("dp", "tp"), seed=2, steps=0)
    _assert_same(named_leaves_from_state(
        restore_from_dir(fresh, str(tmp_path))),
        named_leaves_from_state(state))
    with pytest.raises(ValueError, match="native backend"):
        CheckpointHook(str(tmp_path / "h"), backend="orbax",
                       host_tables={"t": object()})


def _jax_state(tmp_path):
    jcfg = JaxConfig(compute_dtype=jnp.float32, **CFG)
    mesh = jax_mesh((2, 2, 2), ("dp", "sp", "tp"),
                    devices=jax.devices()[:8])
    runner = JaxRunner(mesh=mesh, param_rule=jrules.regex_param_rule(
        jax_rules(), mesh=mesh))
    state = runner.init_state(JaxLM(jcfg, mesh=mesh), optax.adam(1e-2),
                              _batch(), seed=0)
    return state


def test_jax_orbax_directory_raises_naming_the_format(tmp_path):
    state = _jax_state(tmp_path)
    saver = JaxOrbax(str(tmp_path))
    jax_save(saver, state)
    saver.wait()
    assert has_valid_checkpoint(str(tmp_path))
    _, fresh = _mesh_state(steps=0)
    for required in (True, False):
        # Never a fresh start over a checkpoint this package cannot read.
        with pytest.raises(ValueError, match="orbax format"):
            restore_from_dir(fresh, str(tmp_path), required=required)


def test_both_packages_restore_the_same_carried_leaves(tmp_path):
    """One state carried across: each package saves it with its own
    multi-host backend and restores it onto a dp4 mesh; the restored
    parameters are the same numbers."""
    jstate = _jax_state(tmp_path)
    host = jax.tree.map(np.asarray, jstate.params)
    saver = JaxOrbax(str(tmp_path / "jax"))
    jax_save(saver, jstate)
    saver.wait()
    jmesh4 = jax_mesh((4,), ("dp",), devices=jax.devices()[:4])
    jrunner4 = JaxRunner(mesh=jmesh4)
    jfresh = jrunner4.init_state(
        JaxLM(JaxConfig(compute_dtype=jnp.float32, **CFG)),
        optax.adam(1e-2), _batch(), seed=1)
    jgot = jax_restore(JaxOrbax(str(tmp_path / "jax")), jfresh)
    jwant = bridge.state_dict_from_flax(jax.tree.map(np.asarray,
                                                     jgot.params))

    init = bridge.state_dict_from_flax(host)
    _, state = _mesh_state(steps=0, init=init)
    port_saver = OrbaxSaver(str(tmp_path / "port"))
    save_state(port_saver, state)
    port_saver.wait()
    _, fresh = _mesh_state((4,), ("dp",), seed=7, steps=0)
    got = restore_state(OrbaxSaver(str(tmp_path / "port")), fresh)
    for name, value in got.model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), jwant[name].numpy(),
                                      err_msg=name)
