"""The port's checkpoint package (``elasticdl_tpu_torch/checkpoint``)
against the JAX package's, and the JAX checkpoint tests' cases against
the port's modules.

- Saver parity: the same ordered ``{name: ndarray}`` dict (f32, f64,
  int64, uint8, a 0-d step and a bf16 leaf: ml_dtypes' bfloat16 on the
  JAX side, its bits in ``dtypes.BFLOAT16_BITS`` on the port's) and the
  same host-table rows, written by each package's ``CheckpointSaver`` at
  1 and 3 shards, as a full base and as a base plus a delta: the shard
  files are byte-equal and ``chain.json`` equal; each package restores
  the other's directory into equal arrays and rows.
- The cases of tests/test_checkpoint.py (layout and validity,
  repartition, GC, ``keep_max`` 0, a table whose rows all land in one
  shard, the corruption fallback, dirty tracking, delta chains: layout,
  repartition, torn prefix, explicit version, chain-aware GC, stale tmp
  publishes; the writer's bound, deferred error and flush; the stall
  metric; the hook's host-table deltas) against the port's modules.
- The port's own: state leaves by name (bf16 bit-exact, Adam's lazy
  slots created at restore with torch's placement, strict restore),
  and an async hook writing each interval version once. The orbax
  backend's cases are tests/test_torch_orbax_backend*.py.
"""

import json
import os
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from elasticdl_tpu.checkpoint.saver import CheckpointSaver as JaxSaver
from elasticdl_tpu_torch.checkpoint import (
    CheckpointHook,
    CheckpointSaver,
    CheckpointWriter,
    CorruptCheckpointError,
    named_leaves_from_state,
    restore_from_dir,
    restore_state_from_named_leaves,
)
from elasticdl_tpu_torch.checkpoint.hooks import has_valid_checkpoint
from elasticdl_tpu_torch.checkpoint.saver import (
    capture_tables,
    set_chaos_hooks,
)
from elasticdl_tpu_torch.common import dtypes
from elasticdl_tpu_torch.core.train_state import init_train_state
from elasticdl_tpu_torch.embedding.host_engine import _LockedTable
from elasticdl_tpu_torch.embedding.table import EmbeddingTable
from elasticdl_tpu_torch.observability import default_registry

# ---- saver parity with the JAX package ------------------------------------


def _parity_inputs(seed):
    """(JAX dense dict, port dense dict, ids, rows): the same values in
    the same order; the bf16 leaf in each package's numpy form."""
    rng = np.random.RandomState(seed)
    bf16 = rng.randn(5, 3).astype(np.float32).astype(ml_dtypes.bfloat16)
    common = [
        ("step", np.asarray(7 + seed, np.int64)),
        ("params.Dense_0.weight", rng.randn(4, 3).astype(np.float32)),
        ("params.Dense_0.bias", rng.randn(3).astype(np.float32)),
        ("opt_state.Dense_0.weight.exp_avg", rng.randn(4, 3)),
        ("rng", rng.randint(0, 255, size=(40,)).astype(np.uint8)),
        ("table_steps.emb", np.asarray(3, np.int64)),
    ] + [(f"layer_{i}/kernel", rng.randn(2, i + 1).astype(np.float32))
         for i in range(5)]
    jax_dense = dict(common + [("params.bf16", bf16)])
    port_dense = dict(common + [("params.bf16",
                                 bf16.view(np.uint16).view(
                                     dtypes.BFLOAT16_BITS))])
    ids = rng.choice(1000, size=50, replace=False).astype(np.int64)
    rows = rng.randn(50, 4).astype(np.float32)
    return jax_dense, port_dense, ids, rows


def _write(saver, kind, dense_of, rows_of):
    """A full base at version 7, plus a delta at 8 for ``kind`` delta."""
    dense, ids, rows = dense_of(0), *rows_of(0)
    saver.save(7, dense, embeddings={"emb": (ids, rows)})
    if kind == "delta":
        dense, ids, rows = dense_of(1), *rows_of(1)
        saver.save_delta(8, dense, {"emb": (ids[:9], rows[:9])}, 7, 7)


def _bits(arr):
    arr = np.asarray(arr)
    return arr.view(np.uint8).tobytes() if arr.ndim else arr.tobytes()


@pytest.mark.parametrize("num_shards", [1, 3])
@pytest.mark.parametrize("kind", ["full", "delta"])
def test_shard_files_byte_equal_to_jax_saver(num_shards, kind, tmp_path):
    inputs = {s: _parity_inputs(s) for s in (0, 1)}
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _write(JaxSaver(jdir, num_shards=num_shards, delta_chain_max=2), kind,
           lambda s: inputs[s][0], lambda s: inputs[s][2:])
    _write(CheckpointSaver(pdir, num_shards=num_shards, delta_chain_max=2),
           kind, lambda s: inputs[s][1], lambda s: inputs[s][2:])
    elements = sorted(os.listdir(jdir))
    assert elements == sorted(os.listdir(pdir)) == (
        ["delta-8", "version-7"] if kind == "delta" else ["version-7"])
    for element in elements:
        files = sorted(os.listdir(os.path.join(jdir, element)))
        assert files == sorted(os.listdir(os.path.join(pdir, element)))
        assert len([f for f in files if f.endswith(".ckpt")]) == num_shards
        for name in files:
            with open(os.path.join(jdir, element, name), "rb") as a, \
                    open(os.path.join(pdir, element, name), "rb") as b:
                assert a.read() == b.read(), (element, name)
    if kind == "delta":
        chains = [json.load(open(os.path.join(d, "delta-8", "chain.json")))
                  for d in (jdir, pdir)]
        assert chains[0] == chains[1] == {
            "version": 8, "base": 7, "prev": 7, "num_shards": num_shards}


@pytest.mark.parametrize("num_shards", [1, 3])
@pytest.mark.parametrize("kind", ["full", "delta"])
def test_each_package_restores_the_others_directory(num_shards, kind,
                                                    tmp_path):
    inputs = {s: _parity_inputs(s) for s in (0, 1)}
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _write(JaxSaver(jdir, num_shards=num_shards, delta_chain_max=2), kind,
           lambda s: inputs[s][0], lambda s: inputs[s][2:])
    _write(CheckpointSaver(pdir, num_shards=num_shards, delta_chain_max=2),
           kind, lambda s: inputs[s][1], lambda s: inputs[s][2:])
    last = 1 if kind == "delta" else 0
    jax_dense, port_dense = inputs[last][0], inputs[last][1]
    ids0, rows0 = inputs[0][2:]
    want_rows = dict(zip(ids0.tolist(), rows0))
    if kind == "delta":
        ids1, rows1 = inputs[1][2:]
        want_rows.update(zip(ids1[:9].tolist(), rows1[:9]))
    want_ids = np.array(sorted(want_rows), np.int64)
    want_table = np.stack([want_rows[i] for i in want_ids])
    # the port reads the JAX directory, and JAX the port's (2 shards:
    # a repartition restore across the whole chain)
    pv, pd, pt = CheckpointSaver(jdir, num_shards=2).restore()
    jv, jd, jt = JaxSaver(pdir, num_shards=2).restore()
    assert pv == jv == 7 + last
    assert list(pd) and sorted(pd) == sorted(port_dense) == sorted(jd)
    for name in port_dense:
        assert pd[name].dtype == np.asarray(port_dense[name]).dtype, name
        assert _bits(pd[name]) == _bits(port_dense[name]), name
        assert jd[name].dtype == np.asarray(jax_dense[name]).dtype, name
        assert _bits(jd[name]) == _bits(jax_dense[name]), name
    for table in (pt["emb"], jt["emb"]):
        ids, rows = table.to_arrays()
        np.testing.assert_array_equal(ids, want_ids)
        assert rows.tobytes() == want_table.tobytes()


# ---- tests/test_checkpoint.py's cases against the port --------------------


@pytest.fixture
def dense():
    rng = np.random.RandomState(0)
    return {
        f"layer_{i}/kernel": rng.randn(4, 3).astype(np.float32)
        for i in range(7)
    }


def test_shard_files_and_validity(tmp_path, dense):
    saver = CheckpointSaver(str(tmp_path / "ckpt"), num_shards=3)
    vdir = saver.save(10, dense)
    files = sorted(os.listdir(vdir))
    assert files == [f"variables-{i}-of-3.ckpt" for i in range(3)]
    assert saver.is_valid_version(10)
    assert saver.get_valid_latest_version() == 10
    os.remove(os.path.join(vdir, files[0]))
    assert not saver.is_valid_version(10)
    assert saver.get_valid_latest_version() is None


@pytest.mark.parametrize("written,read", [(3, 3), (4, 2), (1, 5)])
def test_roundtrip_and_repartition_restore(tmp_path, dense, written, read):
    """Written with N shards, restored by a saver configured with M
    (save_utils.py:206-259 repartition semantics)."""
    CheckpointSaver(str(tmp_path / "c"), num_shards=written).save(5, dense)
    version, restored, _ = CheckpointSaver(
        str(tmp_path / "c"), num_shards=read).restore()
    assert version == 5 and set(restored) == set(dense)
    for name in dense:
        np.testing.assert_array_equal(restored[name], dense[name])


def test_embedding_rows_repartition(tmp_path):
    table = EmbeddingTable("emb", 4)
    table.get(list(range(13)))
    expect = table.get(list(range(13))).copy()
    CheckpointSaver(str(tmp_path / "c"), num_shards=3).save(
        2, {}, {"emb": table})
    _, _, tables = CheckpointSaver(str(tmp_path / "c"),
                                   num_shards=5).restore()
    assert tables["emb"].num_rows == 13
    np.testing.assert_array_equal(tables["emb"].get(list(range(13))), expect)


@pytest.mark.parametrize("keep_max,kept", [(2, [3, 4]), (0, [1, 2, 3, 4])])
def test_gc_keeps_newest_and_zero_keeps_everything(tmp_path, dense,
                                                   keep_max, kept):
    saver = CheckpointSaver(str(tmp_path / "c"), keep_max=keep_max)
    for v in (1, 2, 3, 4):
        saver.save(v, dense)
    assert saver.list_versions() == kept


def test_restore_table_whose_rows_all_land_in_one_shard(tmp_path):
    table = EmbeddingTable("t", 4)
    rows = np.arange(12, dtype=np.float32).reshape(3, 4)
    table.set([1, 3, 5], rows)   # all odd: shard 0 of 2 holds none
    saver = CheckpointSaver(str(tmp_path / "ck"), num_shards=2)
    saver.save(7, {"w": np.ones((2,), np.float32)}, {"t": table})
    _, _, tables = saver.restore()
    assert tables["t"].dim == 4
    np.testing.assert_array_equal(tables["t"].get([3])[0], rows[1])


def _corrupt_count():
    return default_registry().counter(
        "checkpoint_corrupt_versions_total",
        "Checkpoint versions skipped at restore because a "
        "shard file failed to decode",
    ).labels().value


def _shard_path(saver, version):
    vdir = os.path.join(saver.checkpoint_dir, f"version-{version}")
    return os.path.join(vdir, sorted(os.listdir(vdir))[0])


def _truncate(blob):
    return blob[: len(blob) // 2]


def _garbage(blob):
    # msgpack decodes a 0x00-led blob into an int: decode success alone
    # is not integrity (validate_shard_payload catches it)
    return b"\x00CHAOS" + blob[7:]


@pytest.mark.parametrize("damage", [_truncate, _garbage])
def test_corrupt_latest_falls_back(tmp_path, dense, damage):
    saver = CheckpointSaver(str(tmp_path / "c"), num_shards=2)
    saver.save(1, dense)
    saver.save(2, dense)
    path = _shard_path(saver, 2)
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(damage(blob))
    assert saver.is_valid_version(2)   # count-based validity is blind
    before = _corrupt_count()
    version, restored, _ = saver.restore()
    assert version == 1 and set(restored) == set(dense)
    assert _corrupt_count() == before + 1


def test_explicit_corrupt_version_raises(tmp_path, dense):
    saver = CheckpointSaver(str(tmp_path / "c"))
    saver.save(1, dense)
    saver.save(2, dense)
    with open(_shard_path(saver, 2), "wb") as f:
        f.write(b"\x01")
    with pytest.raises(CorruptCheckpointError):
        saver.restore(version=2)
    assert saver.restore()[0] == 1


def test_every_version_corrupt_is_filenotfound(tmp_path, dense):
    saver = CheckpointSaver(str(tmp_path / "c"))
    for v in (1, 2):
        saver.save(v, dense)
        with open(_shard_path(saver, v), "wb") as f:
            f.write(b"\x00")
    with pytest.raises(FileNotFoundError):
        saver.restore()


def _chain_save(saver, version, dense, tables):
    """One save through the saver's on-disk plan (single-threaded)."""
    kind, base, prev = saver.plan_next()
    captured = {}
    for name, table in tables.items():
        if kind == "delta" and table.supports_dirty_rows:
            captured[name] = table.dirty_arrays()
        else:
            ids, rows = table.to_arrays()
            if table.supports_dirty_rows:
                table.clear_dirty()
            captured[name] = (ids, rows)
    if kind == "delta":
        saver.save_delta(version, dense, captured, base, prev)
    else:
        saver.save(version, dense, embeddings=captured)
    return kind


def _tracked(n=12):
    table = EmbeddingTable("emb", 4)
    table.enable_dirty_tracking()
    table.get(range(n))
    return table


def test_set_and_materialize_mark_dirty():
    table = EmbeddingTable("t", 4)
    table.get([1])
    assert table.dirty_count == 0     # tracking off without a consumer
    table.enable_dirty_tracking()
    table.get([1, 2])                 # 2 materialises: dirty
    table.set([2, 5], np.ones((2, 4), np.float32))
    assert table.dirty_count == 2
    ids, rows = table.dirty_arrays()
    assert ids.tolist() == [2, 5] and rows.shape == (2, 4)
    assert table.dirty_count == 0
    table.mark_dirty([5])
    assert table.dirty_count == 1


def test_full_capture_atomic_on_self_locking_views():
    table = _tracked(2)
    view = _LockedTable(table, threading.Lock())

    def split_capture():
        raise AssertionError("split to_arrays/clear_dirty capture")

    view.clear_dirty = split_capture
    captured, dirty_ids = capture_tables({"emb": view}, delta=False)
    assert captured["emb"][0].size == 2 and dirty_ids == {}
    assert table.dirty_count == 0


def test_chain_layout_roundtrip_and_compaction(tmp_path):
    table = _tracked()
    saver = CheckpointSaver(str(tmp_path / "c"), num_shards=2,
                            delta_chain_max=2)
    kinds = [_chain_save(saver, 1, {}, {"emb": table})]
    for v in (2, 3, 4, 5):
        table.set([v], np.full((1, 4), float(v)))
        kinds.append(_chain_save(saver, v, {}, {"emb": table}))
    assert kinds == ["full", "delta", "delta", "full", "delta"]
    version, _, restored = CheckpointSaver(str(tmp_path / "c")).restore()
    assert version == 5
    live_ids, live_rows = table.to_arrays()
    got_ids, got_rows = restored["emb"].to_arrays()
    np.testing.assert_array_equal(got_ids, live_ids)
    np.testing.assert_array_equal(got_rows, live_rows)


def test_repartition_restore_across_chain(tmp_path):
    table = _tracked()
    _chain_save(CheckpointSaver(str(tmp_path / "c"), num_shards=3,
                                delta_chain_max=4), 1, {}, {"emb": table})
    table.set([3, 13], np.full((2, 4), 9.0))
    assert _chain_save(CheckpointSaver(str(tmp_path / "c"), num_shards=2,
                                       delta_chain_max=4),
                       2, {}, {"emb": table}) == "delta"
    version, _, restored = CheckpointSaver(str(tmp_path / "c"),
                                           num_shards=5).restore()
    assert version == 2 and restored["emb"].num_rows == 13
    np.testing.assert_array_equal(restored["emb"].get([3, 13]),
                                  np.full((2, 4), 9.0, np.float32))


@pytest.mark.parametrize("how", ["torn_tip", "explicit_version"])
def test_chain_restores_its_intact_prefix(tmp_path, how):
    table = _tracked()
    saver = CheckpointSaver(str(tmp_path / "c"), delta_chain_max=4)
    _chain_save(saver, 1, {}, {"emb": table})
    for v in (2, 3):
        table.set([v], np.full((1, 4), float(v)))
        _chain_save(saver, v, {}, {"emb": table})
    if how == "torn_tip":
        ddir = str(tmp_path / "c" / "delta-3")
        path = os.path.join(ddir, sorted(
            f for f in os.listdir(ddir) if f.endswith(".ckpt"))[0])
        with open(path, "rb") as f:
            blob = f.read()
        with open(path, "wb") as f:
            f.write(_truncate(blob))   # crc32 mismatch
        version, _, restored = CheckpointSaver(str(tmp_path / "c")).restore()
    else:
        version, _, restored = saver.restore(version=2)
    assert version == 2
    np.testing.assert_array_equal(restored["emb"].get([2]),
                                  np.full((1, 4), 2.0, np.float32))
    # row 3's delta is not in the prefix: its initial row wins
    np.testing.assert_array_equal(restored["emb"].get([3]),
                                  EmbeddingTable("emb", 4).get([3]))


def test_keep_max_never_deletes_base_under_live_deltas(tmp_path):
    table = _tracked(6)
    saver = CheckpointSaver(str(tmp_path / "c"), keep_max=1,
                            delta_chain_max=4)
    _chain_save(saver, 1, {}, {"emb": table})
    for v in (2, 3):
        table.set([v], np.ones((1, 4)))
        _chain_save(saver, v, {}, {"emb": table})
    assert sorted(os.listdir(tmp_path / "c")) == [
        "delta-2", "delta-3", "version-1"]
    assert saver.restore()[0] == 3


def test_compaction_retires_old_chain_and_orphans(tmp_path):
    table = _tracked(6)
    saver = CheckpointSaver(str(tmp_path / "c"), keep_max=1,
                            delta_chain_max=2)
    _chain_save(saver, 1, {}, {"emb": table})
    for v in (2, 3, 4):
        table.set([v], np.ones((1, 4)))
        kind = _chain_save(saver, v, {}, {"emb": table})
    assert kind == "full"
    assert sorted(os.listdir(tmp_path / "c")) == ["version-4"]


def test_gc_reclaims_stale_tmp_publish(tmp_path):
    table = _tracked(4)
    saver = CheckpointSaver(str(tmp_path / "c"), keep_max=2,
                            delta_chain_max=4)
    _chain_save(saver, 1, {}, {"emb": table})
    stale = tmp_path / "c" / "version-5.tmp"
    stale.mkdir()
    (stale / "variables-0-of-1.ckpt").write_bytes(b"partial")
    table.set([1], np.ones((1, 4)))
    _chain_save(saver, 2, {}, {"emb": table})
    assert not stale.exists()
    assert (tmp_path / "c" / "version-1").is_dir()
    assert (tmp_path / "c" / "delta-2").is_dir()


def test_writer_bounded_nonblocking_refusal_and_flush_barrier():
    writer = CheckpointWriter(max_pending=1)
    gate, done = threading.Event(), []
    writer.submit(lambda: (gate.wait(30), done.append(1)), label="a")
    assert writer.busy
    assert not writer.submit(lambda: done.append(2), label="b",
                             block=False)
    gate.set()
    writer.flush()
    assert done == [1]
    writer.close()
    with pytest.raises(RuntimeError, match="closed"):
        writer.submit(lambda: None)


def test_writer_deferred_error_raises_on_flush_and_is_superseded():
    writer = CheckpointWriter(max_pending=2)

    def boom():
        raise IOError("disk full")

    writer.submit(boom, label="bad")
    with pytest.raises(IOError, match="disk full"):
        writer.flush()
    writer.submit(boom, label="bad2")
    writer.submit(lambda: None, label="good")
    writer.flush()
    writer.close()


def _tiny_state(seed=0, dtype=torch.float32):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4),
                                torch.nn.Linear(4, 2)).to(dtype)
    return init_train_state(model, lambda ps: torch.optim.Adam(ps, lr=0.1),
                            seed=seed)


def _step(state):
    x = torch.ones(5, 3, dtype=next(state.model.parameters()).dtype)
    state.optimizer.zero_grad()
    state.model(x).float().square().sum().backward()
    state.optimizer.step()
    state.step += 1


def test_stall_metric_observed_on_hook_save(tmp_path):
    hist = default_registry().histogram(
        "checkpoint_stall_seconds",
        "Step/push-path time spent capturing + enqueuing a "
        "checkpoint (the part the hot path actually waits on)",
    )
    before = hist.labels().count
    state = _tiny_state()
    _step(state)
    hook = CheckpointHook(str(tmp_path / "c"), checkpoint_steps=1,
                          async_save=True)
    assert hook.maybe_save(state)
    hook.flush()
    assert hist.labels().count == before + 1


def test_hook_writes_deltas_for_host_tables(tmp_path):
    """Host tables ride deltas, dense leaves ride in full,
    restore_from_dir replays the chain and leaves no dirt."""
    table = EmbeddingTable("emb", 4)
    table.get(range(8))
    ckpt = str(tmp_path / "c")
    state = _tiny_state()
    hook = CheckpointHook(ckpt, checkpoint_steps=1, async_save=False,
                          host_tables={"emb": table}, delta_chain_max=4)
    _step(state)
    assert hook.maybe_save(state)
    table.set([2], np.full((1, 4), 2.0))
    _step(state)
    assert hook.maybe_save(state)
    assert sorted(os.listdir(ckpt)) == ["delta-2", "version-1"]
    want = named_leaves_from_state(state)
    fresh, fresh_table = _tiny_state(seed=1), EmbeddingTable("emb", 4)
    restored = restore_from_dir(fresh, ckpt, host_tables={"emb": fresh_table})
    assert restored is fresh and restored.step == 2
    got = named_leaves_from_state(restored)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].tobytes() == want[name].tobytes(), name
    np.testing.assert_array_equal(fresh_table.get([2]),
                                  np.full((1, 4), 2.0, np.float32))
    assert fresh_table.num_rows == 8 and fresh_table.dirty_count == 0


# ---- the port's own ---------------------------------------------------------


def test_bf16_state_round_trips_bit_exactly(tmp_path):
    """bf16 parameters and Adam slots (torch keeps the slots in the
    parameter's dtype) through the files and back, bit for bit; the JAX
    package reads their dtype as bfloat16."""
    state = _tiny_state(dtype=torch.bfloat16)
    _step(state)
    leaves = named_leaves_from_state(state)
    assert leaves["params.0.weight"].dtype == dtypes.BFLOAT16_BITS
    assert leaves["opt_state.0.weight.exp_avg"].dtype \
        == dtypes.BFLOAT16_BITS
    CheckpointSaver(str(tmp_path / "c")).save(1, leaves)
    _, jax_dense, _ = JaxSaver(str(tmp_path / "c")).restore()
    assert jax_dense["params.0.weight"].dtype == ml_dtypes.bfloat16
    assert jax_dense["params.0.weight"].tobytes() == \
        leaves["params.0.weight"].tobytes()
    fresh = restore_from_dir(_tiny_state(seed=5, dtype=torch.bfloat16),
                             str(tmp_path / "c"))
    for (name, p), q in zip(state.model.named_parameters(),
                            fresh.model.parameters()):
        assert q.dtype == torch.bfloat16
        assert torch.equal(p.view(torch.int16), q.view(torch.int16)), name
        for slot in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(
                state.optimizer.state[p][slot].view(torch.int16),
                fresh.optimizer.state[q][slot].view(torch.int16))


OPTIMIZERS = {
    "adam": (lambda ps: torch.optim.Adam(ps, lr=0.1),
             ["exp_avg", "exp_avg_sq", "step"]),
    "adamw_amsgrad": (lambda ps: torch.optim.AdamW(ps, lr=0.1, amsgrad=True),
                      ["exp_avg", "exp_avg_sq", "max_exp_avg_sq", "step"]),
    "sgd_momentum": (lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
                     ["momentum_buffer"]),
    # Adagrad builds its slots at construction: the copy path
    "adagrad": (lambda ps: torch.optim.Adagrad(ps, lr=0.1),
                ["step", "sum"]),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_restore_creates_lazy_optimizer_slots(name):
    """A fresh torch optimizer has no slots until its first step: the
    restore creates them from the checkpoint (shapes checked), a
    per-parameter step as a 0-d f32 on the CPU, as torch places it when
    the optimizer is neither fused nor capturable; the next two steps
    then match the saved run's exactly."""
    make_optimizer, slots = OPTIMIZERS[name]

    def make(seed):
        torch.manual_seed(seed)
        return init_train_state(torch.nn.Linear(3, 2), make_optimizer)

    state = make(0)
    _step(state)
    leaves = named_leaves_from_state(state)
    assert sorted(k for k in leaves if k.startswith("opt_state.bias")) == [
        f"opt_state.bias.{slot}" for slot in slots]
    fresh = make(1)
    restore_state_from_named_leaves(fresh, leaves)
    for p in fresh.model.parameters():
        assert sorted(fresh.optimizer.state[p]) == slots
        step = fresh.optimizer.state[p].get("step")
        if step is not None:
            assert step.device.type == "cpu" and step.dtype == torch.float32
            assert step.dim() == 0
    for _ in range(2):
        _step(state)
        _step(fresh)
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(p, q)
    bad = dict(leaves)
    bad["opt_state.bias.exp_avg"] = np.zeros((5,), np.float32)
    with pytest.raises(ValueError, match="parameter shape"):
        restore_state_from_named_leaves(make(2), bad)


def test_strict_restore_raises_on_a_missing_leaf():
    state = _tiny_state()
    _step(state)
    named = named_leaves_from_state(state)
    target = _tiny_state(seed=1)
    _step(target)     # its optimizer has live slots to hold against
    for name in ("params.0.bias", "rng", "step",
                 "opt_state.1.weight.exp_avg"):
        partial = {k: v for k, v in named.items() if k != name}
        with pytest.raises(KeyError, match="missing leaf"):
            restore_state_from_named_leaves(target, partial)
        restore_state_from_named_leaves(_tiny_state(), partial, strict=False)


def test_a_state_field_without_a_rule_raises():
    from dataclasses import dataclass

    from elasticdl_tpu_torch.core.train_state import TrainState

    @dataclass
    class Extended(TrainState):
        ema: dict = None

    base = _tiny_state()
    state = Extended(model=base.model, optimizer=base.optimizer,
                     generator=base.generator)
    with pytest.raises(NotImplementedError, match="ema"):
        named_leaves_from_state(state)


def test_has_valid_checkpoint_and_the_relaunch_restore(tmp_path, dense):
    """The elastic-relaunch decision: no dir, an empty dir and a dir
    whose only version is torn hold nothing valid; ``required=False``
    then starts fresh instead of raising."""
    ckpt = str(tmp_path / "c")
    assert not has_valid_checkpoint("")
    assert not has_valid_checkpoint(str(tmp_path / "missing"))
    state = _tiny_state()
    assert restore_from_dir(state, ckpt, required=False) is state
    assert state.step == 0
    saver = CheckpointSaver(ckpt, num_shards=2)
    saver.save(3, dense)
    assert has_valid_checkpoint(ckpt)
    os.remove(_shard_path(saver, 3))
    assert not has_valid_checkpoint(ckpt)


def test_chaos_hooks_see_every_save_restore_and_fsync(tmp_path, dense):
    seen = []
    set_chaos_hooks(
        post_save=lambda d, v, vdir: seen.append(("save", v,
                                                  os.path.isdir(vdir))),
        post_restore=lambda d, v: seen.append(("restore", v)),
        fsync=lambda kind: seen.append(("fsync", kind)))
    try:
        saver = CheckpointSaver(str(tmp_path / "c"), num_shards=2)
        saver.save(4, dense)
        saver.restore()
    finally:
        set_chaos_hooks()
    assert seen == [("fsync", "checkpoint"), ("fsync", "checkpoint"),
                    ("save", 4, True), ("restore", 4)]


def test_async_hook_writes_each_version_once(tmp_path):
    """Every second version and the final one, each written once, though
    the writes land after the steps that asked for them."""
    saves = default_registry().counter(
        "checkpoint_saves_total", "Checkpoint versions written")
    before = saves.labels().value
    gate = threading.Event()
    state = _tiny_state()
    hook = CheckpointHook(str(tmp_path / "c"), checkpoint_steps=2,
                          keep_max=0)
    real_save = hook.saver.save

    def slow_save(*args, **kwargs):
        gate.wait(30)
        return real_save(*args, **kwargs)

    hook.saver.save = slow_save
    for _ in range(2):
        _step(state)
        hook.maybe_save(state)
    _step(state)   # version 3: the write of 2 is still held at the gate
    assert not hook.maybe_save(state)
    gate.set()
    _step(state)
    assert hook.maybe_save(state)
    assert not hook.save_final(state)
    assert hook.saver.list_versions() == [2, 4]
    assert saves.labels().value == before + 2
