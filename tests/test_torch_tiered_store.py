"""The port's two-tier row store (``elasticdl_tpu_torch/storage/
tiered.py``) on the CPU: the JAX package's ``tests/test_tiered_store.py``
cases (``TestTieredTable``, ``TestSlotLockstep``, ``TestNativeErase``,
``TestTieredCheckpoint``, ``TestCheckStore``) run against the port, and a
tiered port ``HostRowService`` held to a tiered JAX one: the same pushes
leave equal rows, slots, step counters and tier readings, their
checkpoint directories are byte-equal, and each restores the other's
mid-run checkpoint."""

import json
import os

import numpy as np
import pytest

from elasticdl_tpu.embedding import row_service as jrs
from elasticdl_tpu.embedding.optimizer import Adagrad as JaxAdagrad
from elasticdl_tpu.embedding.optimizer import Adam as JaxAdam
from elasticdl_tpu.native import row_store as jnative
from elasticdl_tpu.observability import default_registry as jax_registry
from elasticdl_tpu_torch.checkpoint.saver import CheckpointSaver
from elasticdl_tpu_torch.embedding import row_service as prs
from elasticdl_tpu_torch.embedding.optimizer import (
    SGD,
    Adagrad,
    Adam,
    HostOptimizerWrapper,
)
from elasticdl_tpu_torch.embedding.table import EmbeddingTable
from elasticdl_tpu_torch.native import native_available
from elasticdl_tpu_torch.native import row_store as pnative
from elasticdl_tpu_torch.observability import default_registry
from elasticdl_tpu_torch.observability.registry import MetricsRegistry
from elasticdl_tpu_torch.storage import (
    ColdRowStore,
    TierGroup,
    TierPolicy,
    tier_host_tables,
)
from elasticdl_tpu_torch.storage.cold_store import (
    INDEX_SNAPSHOT_FILE,
    record_bytes,
)
from elasticdl_tpu_torch.tools.check_store import check_store

DIM = 8
needs_native = pytest.mark.skipif(not native_available(),
                                  reason="native library unavailable")


def _rows(rng, n):
    return rng.rand(n, DIM).astype(np.float32)


def _tiered(tmp_path, budget, *, registry=None, table=None, **policy_kw):
    registry = registry or MetricsRegistry()
    policy_kw.setdefault("background_compact", False)
    tables = {"t": table if table is not None
              else EmbeddingTable("t", DIM)}
    tiered = tier_host_tables(
        tables, str(tmp_path / "cold"), TierPolicy(budget, **policy_kw),
        metrics_registry=registry,
    )
    return tiered["t"], registry


def _count(registry, name):
    return registry.counter(name).labels().value


# ---- TieredTable / TierGroup: admission, eviction, dirty tracking ---------


def test_budget_enforced_and_faults_byte_equal(tmp_path):
    table, registry = _tiered(tmp_path, budget=8)
    rng = np.random.RandomState(0)
    ids = np.arange(32, dtype=np.int64)
    rows = _rows(rng, 32)
    table.set(ids, rows)
    group = table.tier_group
    assert isinstance(group, TierGroup)
    assert group.hot_rows() <= 8
    assert table.num_rows == 32
    # Cold rows fault back byte-equal, and the budget still holds.
    np.testing.assert_array_equal(table.get(ids[:6]), rows[:6])
    assert group.hot_rows() <= 8
    assert _count(registry, "row_tier_evictions_total") > 0


def test_lru_keeps_the_working_set_hot(tmp_path):
    table, registry = _tiered(tmp_path, budget=8)
    rng = np.random.RandomState(1)
    table.set(np.arange(64, dtype=np.int64), _rows(rng, 64))
    hot_set = np.arange(6, dtype=np.int64)
    for _ in range(4):
        table.get(hot_set)
    faults_before = _count(registry, "row_tier_faults_total")
    # Cold strangers one at a time: the hot working set is never the
    # victim, so re-reading it stays fault-free.
    for cold_id in range(40, 48):
        table.get(np.array([cold_id], np.int64))
        table.get(hot_set)
    assert _count(registry, "row_tier_faults_total") - faults_before == 8


def test_one_fault_event_per_batched_pull(tmp_path):
    table, registry = _tiered(tmp_path, budget=4)
    rng = np.random.RandomState(2)
    ids = np.arange(32, dtype=np.int64)
    table.set(ids, _rows(rng, 32))
    faults0 = _count(registry, "row_tier_faults_total")
    rows0 = _count(registry, "row_tier_fault_rows_total")
    table.get(ids[:20])  # >= 16 of these are cold
    assert _count(registry, "row_tier_faults_total") - faults0 == 1
    assert _count(registry, "row_tier_fault_rows_total") - rows0 >= 16


def test_bulk_set_streams_through_budget(tmp_path):
    table, _ = _tiered(tmp_path, budget=8)
    rng = np.random.RandomState(3)
    table.set(np.arange(100, dtype=np.int64), _rows(rng, 100))
    assert table.tier_group.hot_rows() <= 8
    assert table.num_rows == 100


def test_erase_and_contains_span_tiers(tmp_path):
    table, _ = _tiered(tmp_path, budget=4)
    rng = np.random.RandomState(4)
    table.set(np.arange(16, dtype=np.int64), _rows(rng, 16))
    # id 15 is hot (just written), id 0 is cold by now.
    mask = table.contains(np.array([0, 15, 99], np.int64))
    np.testing.assert_array_equal(mask, [True, True, False])
    assert table.erase(np.array([0, 15, 99], np.int64)) == 2
    assert table.num_rows == 14
    mask = table.contains(np.array([0, 15], np.int64))
    np.testing.assert_array_equal(mask, [False, False])


def test_to_arrays_all_ids_and_peek_span_tiers(tmp_path):
    table, registry = _tiered(tmp_path, budget=4)
    rng = np.random.RandomState(5)
    ids = np.arange(20, dtype=np.int64)
    rows = _rows(rng, 20)
    table.set(ids, rows)
    out_ids, out_rows = table.to_arrays()
    np.testing.assert_array_equal(out_ids, ids)
    np.testing.assert_array_equal(out_rows, rows)
    np.testing.assert_array_equal(table.all_ids(), ids)
    # peek reads cold rows without promoting them.
    hot_before = set(table._hot)
    faults = _count(registry, "row_tier_faults_total")
    np.testing.assert_array_equal(table.peek(ids[::3]), rows[::3])
    assert set(table._hot) == hot_before
    assert _count(registry, "row_tier_faults_total") == faults


def test_demoted_dirty_row_drains_from_cold(tmp_path):
    table, _ = _tiered(tmp_path, budget=4)
    table.enable_dirty_tracking()
    rng = np.random.RandomState(6)
    marked = _rows(rng, 1)
    table.set(np.array([7], np.int64), marked)
    # Demote id 7 by touching a budget's worth of strangers.
    table.set(np.arange(100, 108, dtype=np.int64), _rows(rng, 8))
    assert 7 not in table._hot
    ids, rows = table.dirty_arrays()
    assert 7 in ids.tolist()
    np.testing.assert_array_equal(rows[ids.tolist().index(7)], marked[0])


def test_demote_repromote_redirty_exactly_once(tmp_path):
    # A row demoted while dirty, re-promoted and re-dirtied drains once,
    # with its newest bytes.
    table, _ = _tiered(tmp_path, budget=4)
    table.enable_dirty_tracking()
    rng = np.random.RandomState(7)
    table.set(np.array([7], np.int64), _rows(rng, 1))
    table.set(np.arange(100, 108, dtype=np.int64), _rows(rng, 8))
    assert 7 not in table._hot
    table.get(np.array([7], np.int64))
    final = _rows(rng, 1)
    table.set(np.array([7], np.int64), final)
    ids, rows = table.dirty_arrays()
    assert ids.tolist().count(7) == 1
    np.testing.assert_array_equal(rows[ids.tolist().index(7)], final[0])
    ids2, _ = table.dirty_arrays()
    assert 7 not in ids2.tolist()


def test_faulted_clean_row_demotes_without_rewrite(tmp_path):
    table, _ = _tiered(tmp_path, budget=4, compact_live_fraction=0.0)
    rng = np.random.RandomState(8)
    ids = np.arange(12, dtype=np.int64)
    table.set(ids, _rows(rng, 12))

    def records():
        return sum(s["records"]
                   for s in table._cold.stats()["segments"].values())

    table.get(ids[:4])
    before = records()
    # Faulting 4-7 demotes 0-3, clean faulted rows whose cold records
    # are current: no new record is written.
    table.get(ids[4:8])
    assert records() == before


def test_float64_table_rejected(tmp_path):
    with pytest.raises(TypeError):
        _tiered(tmp_path, budget=4,
                table=EmbeddingTable("t", DIM, dtype=np.float64))


def test_prefault_promotes_outside_the_lock(tmp_path):
    """``prefault`` (the service's pre-lock hook) promotes a pull's cold
    rows byte-equal in one fault event; the later ``get`` finds them
    hot."""
    table, registry = _tiered(tmp_path, budget=4)
    rng = np.random.RandomState(9)
    ids = np.arange(16, dtype=np.int64)
    rows = _rows(rng, 16)
    table.set(ids, rows)
    faults = _count(registry, "row_tier_faults_total")
    table.prefault(ids[:3])
    assert set(ids[:3].tolist()) <= table._hot
    assert _count(registry, "row_tier_faults_total") == faults + 1
    np.testing.assert_array_equal(table.get(ids[:3], _defer_sweep=True),
                                  rows[:3])
    assert _count(registry, "row_tier_faults_total") == faults + 1
    table.maybe_sweep()
    assert table.tier_group.hot_rows() <= 4


# ---- optimizer-slot lockstep ----------------------------------------------


def _apply_schedule(wrapper, table, rng, n_pushes=6):
    for _ in range(n_pushes):
        ids = np.unique(rng.randint(0, 64, 24)).astype(np.int64)
        wrapper.apply_gradients(table, ids, _rows(rng, ids.size))


@pytest.mark.parametrize("rule,slots", [
    ("adam", {"t-m", "t-v"}), ("adagrad", {"t-accumulator"})])
@pytest.mark.parametrize("native", [False, True])
def test_slots_demote_and_fault_with_primary(tmp_path, native, rule,
                                             slots):
    if native and not native_available():
        pytest.skip("native library unavailable")
    opt = Adam(lr=0.01) if rule == "adam" else Adagrad(lr=0.05)
    if native:
        table_in = pnative.make_host_table("t", DIM)
        wrapper = pnative.NativeOptimizerWrapper(opt)
    else:
        table_in = EmbeddingTable("t", DIM)
        wrapper = HostOptimizerWrapper(opt)
    table, _ = _tiered(tmp_path, budget=8, table=table_in)
    rng = np.random.RandomState(9)
    _apply_schedule(wrapper, table, rng)
    group = table.tier_group
    # The slots landed in the primary's group and follow its budget.
    assert set(group.slots) == slots
    for slot in group.slots.values():
        assert len(slot._hot) <= 8
        assert slot._hot == table._hot
        # A demoted row took real optimizer state with it: the cold
        # record is not the slot's initial value.
        cold_only = sorted(set(slot._cold.live_ids().tolist()) - slot._hot)
        assert cold_only
        init = slot.slot_init_value
        assert np.abs(slot._cold.get_rows(np.array(cold_only, np.int64))
                      - init).max() > 0


@pytest.mark.parametrize("native", [False, True])
def test_tiered_matches_untiered_trajectory(tmp_path, native):
    # Tiering is invisible to training: the same pushes land byte-equal
    # rows with and without tiers.
    if native and not native_available():
        pytest.skip("native library unavailable")
    if native:
        plain = pnative.make_host_table("t", DIM)
        inner = pnative.make_host_table("t", DIM)
        w1 = pnative.NativeOptimizerWrapper(Adagrad(lr=0.1))
        w2 = pnative.NativeOptimizerWrapper(Adagrad(lr=0.1))
    else:
        plain, inner = EmbeddingTable("t", DIM), EmbeddingTable("t", DIM)
        w1, w2 = HostOptimizerWrapper(SGD(lr=0.1)), \
            HostOptimizerWrapper(SGD(lr=0.1))
    tiered, _ = _tiered(tmp_path, budget=6, table=inner)
    _apply_schedule(w1, plain, np.random.RandomState(10), n_pushes=8)
    _apply_schedule(w2, tiered, np.random.RandomState(10), n_pushes=8)
    ids_a, rows_a = plain.to_arrays()
    ids_b, rows_b = tiered.to_arrays()
    order = np.argsort(ids_a)
    np.testing.assert_array_equal(ids_a[order], ids_b)
    np.testing.assert_array_equal(np.asarray(rows_a)[order], rows_b)


# ---- native arena: erase/contains and the get-touch regression ------------


@needs_native
def test_native_erase_contains_and_slot_reuse():
    t = pnative.NativeEmbeddingTable("t", DIM)
    rows = t.get([1, 2, 3])
    assert t.erase([2, 99]) == 1
    assert t.num_rows == 2
    np.testing.assert_array_equal(t.contains([1, 2, 3]),
                                  [True, False, True])
    assert sorted(t.to_arrays()[0].tolist()) == [1, 3]
    created = t.created_count
    np.testing.assert_array_equal(t.get([2]), rows[1:2])
    assert t.num_rows == 3
    assert t.created_count == created + 1
    np.testing.assert_array_equal(t.get([1]), rows[0:1])
    np.testing.assert_array_equal(t.get([3]), rows[2:3])


@needs_native
def test_native_get_after_erase_marks_dirty_in_reused_slot():
    # A fault that re-materialises a row into a freed slot must mark it
    # dirty (keyed on the monotonic created_count, not the live size).
    t = pnative.NativeEmbeddingTable("t", DIM)
    t.get([1, 2])
    t.enable_dirty_tracking()
    t.clear_dirty()
    t.erase([1])
    before = t.num_rows
    t.get([1])
    assert t.num_rows == before + 1
    ids, _ = t.dirty_arrays()
    assert 1 in ids.tolist()


@needs_native
def test_native_erase_drops_dirty_mark():
    t = pnative.NativeEmbeddingTable("t", DIM)
    t.enable_dirty_tracking()
    t.set(np.array([5], np.int64), np.ones((1, DIM), np.float32))
    assert t.dirty_count == 1
    t.erase([5])
    ids, _ = t.dirty_arrays()
    assert ids.size == 0


# ---- checkpoints across tiers ---------------------------------------------


def _service(pkg, ckpt_dir, cold_dir=None, budget=16, rule="adam",
             **ckpt_kw):
    """A one-table service of either package (native store where the
    library builds), tiered when ``cold_dir`` is given."""
    if pkg == "jax":
        mod, native = jrs, jnative
        opt = JaxAdam(lr=0.01) if rule == "adam" else JaxAdagrad(lr=0.05)
    else:
        mod, native = prs, pnative
        opt = Adam(lr=0.01) if rule == "adam" else Adagrad(lr=0.05)
    svc = mod.HostRowService({"t": native.make_host_table("t", DIM)},
                             native.make_host_optimizer(opt))
    if cold_dir is not None:
        svc.configure_tiering(str(cold_dir), budget, segment_max_bytes=4096,
                              background_compact=False)
    if ckpt_dir is not None:
        ckpt_kw.setdefault("checkpoint_steps", 5)
        ckpt_kw.setdefault("delta_chain_max", 3)
        svc.configure_checkpoint(str(ckpt_dir), async_write=False,
                                 **ckpt_kw)
    return svc


def _drive(svc, seed, pushes, client, pull=False):
    rng = np.random.RandomState(seed)
    for seq in range(1, pushes + 1):
        ids = np.unique(rng.randint(0, 200, 48)).astype(np.int64)
        grads = _rows(rng, ids.size)
        if pull:
            svc._pull_rows({"table": "t", "ids": ids[::2]})
        svc._push_row_grads({"table": "t", "ids": ids, "grads": grads,
                             "client": client, "seq": seq})


def _row_state(svc):
    return {name: view.to_arrays()
            for name, view in svc.host_tables.items()
            if name != "__row_service_seqs__"}


def _assert_state_equal(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        np.testing.assert_array_equal(np.asarray(a[name][0]),
                                      np.asarray(b[name][0]), err_msg=name)
        np.testing.assert_array_equal(
            np.asarray(a[name][1], np.float32),
            np.asarray(b[name][1], np.float32), err_msg=name)


def test_mid_run_checkpoint_restores_byte_equal(tmp_path):
    # A mid-run checkpoint (a base and a delta chain, dirty rows in both
    # tiers) restores byte-equal rows into a tiered twin and an untiered
    # one.
    svc = _service("port", tmp_path / "ckpt", tmp_path / "cold")
    _drive(svc, seed=11, pushes=12, client="a")
    assert svc.checkpoint_now()
    want = _row_state(svc)
    stats = svc.tier_stats()["t"]
    assert stats["hot_rows"] <= 16 and stats["cold_rows"] > 0
    svc.stop()
    tiered_twin = _service("port", tmp_path / "ckpt", tmp_path / "cold2")
    _assert_state_equal(want, _row_state(tiered_twin))
    assert tiered_twin.tier_stats()["t"]["hot_rows"] <= 16
    tiered_twin.stop()
    untiered_twin = _service("port", tmp_path / "ckpt")
    _assert_state_equal(want, _row_state(untiered_twin))
    untiered_twin.stop()


def test_delta_carries_cold_dirty_rows(tmp_path):
    # checkpoint_steps 5 over 12 pushes: version 5 a base, 10 a delta;
    # rows demoted between saves ride the delta, and the chain restores
    # what the live service holds.
    svc = _service("port", tmp_path / "ckpt", tmp_path / "cold", budget=8)
    _drive(svc, seed=12, pushes=10, client="a")
    entries = os.listdir(tmp_path / "ckpt")
    assert "version-5" in entries and "delta-10" in entries
    want = _row_state(svc)
    svc.stop()
    twin = _service("port", tmp_path / "ckpt")
    assert twin._push_count == 10
    _assert_state_equal(want, _row_state(twin))
    twin.stop()


def test_repartition_across_tiers(tmp_path):
    # N → M repartition: the capture spans both tiers, the refill
    # streams back through a smaller tier.
    src, _ = _tiered(tmp_path, budget=8)
    rng = np.random.RandomState(13)
    ids = np.arange(0, 120, dtype=np.int64)
    rows = _rows(rng, 120)
    src.set(ids, rows)
    CheckpointSaver(str(tmp_path / "ck"), num_shards=3).save(
        1, {}, embeddings={"t": src})
    _v, _dense, tables = CheckpointSaver(
        str(tmp_path / "ck"), num_shards=2).restore()
    got_ids, got_rows = tables["t"].to_arrays()
    order = np.argsort(np.asarray(got_ids))
    np.testing.assert_array_equal(np.asarray(got_ids)[order], ids)
    np.testing.assert_array_equal(np.asarray(got_rows)[order], rows)
    dst, _ = _tiered(tmp_path / "dst", budget=4)
    dst.set(np.asarray(got_ids), np.asarray(got_rows))
    out_ids, out_rows = dst.to_arrays()
    np.testing.assert_array_equal(out_ids, ids)
    np.testing.assert_array_equal(out_rows, rows)
    assert dst.tier_group.hot_rows() <= 4


def test_configure_tiering_after_checkpoint_raises(tmp_path):
    svc = _service("port", tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="before configure_checkpoint"):
        svc.configure_tiering(str(tmp_path / "cold"), 16)
    svc.stop()


# ---- the port's service against the JAX service ---------------------------

_TIER_COUNTERS = ("row_tier_faults_total", "row_tier_fault_rows_total",
                  "row_tier_evictions_total")


def _tier_counts(registry):
    return {name: registry.counter(name).labels().value
            for name in _TIER_COUNTERS}


@pytest.mark.parametrize("rule", ["adam", "adagrad"])
def test_same_pushes_through_jax_and_port_tiered_services(tmp_path, rule):
    """The same pushes (and pulls) through a tiered JAX and a tiered port
    service: equal rows, slots, step counters, seq maps and tier
    readings (hot and cold rows, faults, evictions)."""
    jax_svc = _service("jax", None, tmp_path / "jcold", budget=16,
                       rule=rule)
    port_svc = _service("port", None, tmp_path / "pcold", budget=16,
                        rule=rule)
    j0, p0 = _tier_counts(jax_registry()), _tier_counts(default_registry())
    _drive(jax_svc, seed=14, pushes=10, client="w", pull=True)
    _drive(port_svc, seed=14, pushes=10, client="w", pull=True)
    jd = {k: v - j0[k] for k, v in _tier_counts(jax_registry()).items()}
    pd = {k: v - p0[k] for k, v in _tier_counts(default_registry()).items()}
    assert pd == jd
    assert pd["row_tier_evictions_total"] > 0
    assert pd["row_tier_faults_total"] > 0
    want = {n: v.to_arrays() for n, v in jax_svc.host_tables.items()}
    got = {n: v.to_arrays() for n, v in port_svc.host_tables.items()}
    _assert_state_equal(want, got)
    assert prs.SEQS_TABLE_NAME in got
    js, ps = jax_svc.tier_stats()["t"], port_svc.tier_stats()["t"]
    assert (ps["hot_rows"], ps["cold_rows"]) == (js["hot_rows"],
                                                 js["cold_rows"])
    assert ps["members"].keys() == js["members"].keys()
    for name in js["members"]:
        assert ps["members"][name]["hot"] == js["members"][name]["hot"]
        assert (ps["members"][name]["cold_only"]
                == js["members"][name]["cold_only"])
    jax_svc.stop()
    port_svc.stop()


def _tree(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_tiered_checkpoints_are_byte_equal_to_jax(tmp_path):
    jax_svc = _service("jax", tmp_path / "jax", tmp_path / "jcold",
                       budget=8)
    port_svc = _service("port", tmp_path / "port", tmp_path / "pcold",
                        budget=8)
    _drive(jax_svc, seed=15, pushes=12, client="w")
    _drive(port_svc, seed=15, pushes=12, client="w")
    assert jax_svc.checkpoint_now() and port_svc.checkpoint_now()
    jfiles, pfiles = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(pfiles) == sorted(jfiles)
    assert any(name.startswith("delta-") for name in pfiles)
    for name in jfiles:
        assert pfiles[name] == jfiles[name], name
    jax_svc.stop()
    port_svc.stop()
    # The cold stores the two closed hold the same segments and index.
    jcold, pcold = _tree(tmp_path / "jcold"), _tree(tmp_path / "pcold")
    assert sorted(pcold) == sorted(jcold)
    for name in jcold:
        assert pcold[name] == jcold[name], name


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_tiered_service_restores_the_others_checkpoint(tmp_path, writer,
                                                       reader):
    """A mid-run checkpoint (base 5, delta 10, then 12 on the drain)
    written by one package's tiered service restores byte-equal into the
    other's tiered service."""
    src = _service(writer, tmp_path / "ckpt", tmp_path / "cold_w", budget=8)
    _drive(src, seed=16, pushes=12, client="w")
    assert src.checkpoint_now()
    want = _row_state(src)
    src.stop()
    dst = _service(reader, tmp_path / "ckpt", tmp_path / "cold_r", budget=8)
    assert dst._push_count == 12
    _assert_state_equal(want, _row_state(dst))
    assert dst.tier_stats()["t"]["hot_rows"] <= 8
    dst.stop()


# ---- fsck (tools/check_store) ---------------------------------------------


def _store_with_rows(path, n=12):
    store = ColdRowStore(
        str(path), dim=DIM, segment_max_bytes=4 * record_bytes(DIM),
        background_compact=False, compact_live_fraction=0.0,
    )
    rng = np.random.RandomState(14)
    store.put_rows(np.arange(n, dtype=np.int64), _rows(rng, n))
    return store


def test_check_store_clean_store_passes(tmp_path):
    _store_with_rows(tmp_path / "c").close()
    errors, report = check_store(str(tmp_path))
    assert errors == []
    assert report["live_rows"] == 12
    assert report["stores"][0]["index_snapshot"]


def test_check_store_torn_tail_reported_not_fatal(tmp_path):
    _store_with_rows(tmp_path / "c").close(write_index=False)
    segs = ColdRowStore.list_segments(str(tmp_path / "c"))
    seg = os.path.join(tmp_path / "c", f"segment-{segs[-1]:06d}.seg")
    with open(seg, "rb+") as f:
        f.truncate(os.path.getsize(seg) - 7)
    errors, report = check_store(str(tmp_path))
    assert errors == []
    assert report["stores"][0]["torn_tail"] is not None


def test_check_store_mid_store_corruption_fails(tmp_path):
    _store_with_rows(tmp_path / "c").close(write_index=False)
    segs = ColdRowStore.list_segments(str(tmp_path / "c"))
    seg = os.path.join(tmp_path / "c", f"segment-{segs[0]:06d}.seg")
    with open(seg, "rb+") as f:
        f.seek(record_bytes(DIM) // 2)
        f.write(b"\xde\xad\xbe\xef")
    errors, _ = check_store(str(tmp_path))
    assert errors


def test_check_store_stale_index_snapshot_fails(tmp_path):
    _store_with_rows(tmp_path / "c").close()
    snap = os.path.join(tmp_path / "c", INDEX_SNAPSHOT_FILE)
    with open(snap) as f:
        data = json.load(f)
    data["index"]["999"] = [0, 0]
    with open(snap, "w") as f:
        json.dump(data, f)
    errors, _ = check_store(str(tmp_path))
    assert any("999" in e for e in errors)


def test_check_store_garbage_accounting(tmp_path):
    store = _store_with_rows(tmp_path / "c")
    rng = np.random.RandomState(15)
    # 2 of 4 records overwritten in each of the first two segments: the
    # live fraction stays 0.5, nothing compacts (threshold 0.0).
    store.put_rows(np.array([0, 1, 4, 5], np.int64), _rows(rng, 4))
    store.close()
    errors, report = check_store(str(tmp_path))
    assert errors == []
    rep = report["stores"][0]
    assert rep["garbage_records"] == 4
    assert rep["garbage_bytes"] == 4 * record_bytes(DIM)


def _jax_check_store():
    import sys

    tools = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    from check_store import check_store as jax_check

    return jax_check


def test_check_store_reports_equal_jax_tool(tmp_path):
    """The port's fsck and the JAX one over the same damaged tree (a
    tiered service's stores, one torn, one with a stale index): the
    same errors and report."""
    import subprocess
    import sys

    svc = _service("port", None, tmp_path / "cold", budget=8)
    _drive(svc, seed=17, pushes=6, client="w")
    svc.stop()
    stores = sorted(os.path.join(b, "") for b, _, f in
                    os.walk(tmp_path / "cold") if "MANIFEST.json" in f)
    assert len(stores) == 3
    snap = os.path.join(stores[0], INDEX_SNAPSHOT_FILE)
    with open(snap) as f:
        data = json.load(f)
    data["index"]["4242"] = [0, 0]
    with open(snap, "w") as f:
        json.dump(data, f)
    os.unlink(os.path.join(stores[1], INDEX_SNAPSHOT_FILE))
    segs = ColdRowStore.list_segments(stores[1])
    seg = os.path.join(stores[1], f"segment-{segs[-1]:06d}.seg")
    with open(seg, "ab") as f:
        f.write(b"torn")
    want = _jax_check_store()(str(tmp_path / "cold"))
    got = check_store(str(tmp_path / "cold"))
    assert got == want
    assert got[0]
    assert sum(r["torn_tail"] is not None for r in got[1]["stores"]) == 1
    rc = subprocess.run(
        [sys.executable, "-m", "elasticdl_tpu_torch.tools.check_store",
         str(tmp_path / "cold")], capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert rc.returncode == 1, rc.stderr
    assert "4242" in rc.stderr


def test_profile_tier_sweep_tool(tmp_path, capsys):
    """``tools/profile_tier_sweep``'s JSON line at a small shape: the
    profiled pulls ran through the sweep and its victim buffer."""
    from elasticdl_tpu_torch.tools import profile_tier_sweep

    profile_tier_sweep.main(["--vocab", "80000", "--dim", "8", "--budget",
                             "10000", "--batches", "4", "--dir",
                             str(tmp_path / "cold")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["profiled_pulls"] == 2 and line["ms_a_pull"] > 0
    assert line["cumulative_s"]["sweep"] > 0
    assert line["cumulative_s"]["_rebuild_victim_buf"] > 0
    assert line["cold_rows"] >= 70000
