"""The row service's live resharding and hot-row replicas in the port
(``embedding/row_service.py``, ``master/row_reshard.py``,
``tools/check_reshard.py``) on the CPU.

The JAX package's ``tests/test_reshard.py`` cases (a version bump in the
middle of a stream, slots moving with their rows, fenced pushes applied
once, replica refresh and staleness, a replica miss, cold rows streamed
without promotion, the controller's persistence, its journal record, the
policy, the fsck) and ``tests/test_failover.py``'s retirement cases run
against the port. Then the two packages are held to each other: the same
seeded schedule through a JAX fleet under the JAX controller and a port
fleet under the port controller, with a split, a merge and the drained
shard's retirement at the same points, gives byte-equal rows, slots,
step counters and seq maps on every shard, byte-equal state files and
equal ``shard_stats``; a JAX controller moves a range between port
services over gRPC and a port controller between JAX services; a hedged
pull rides out a stalled handler.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest

from elasticdl_tpu.embedding import optimizer as jopt
from elasticdl_tpu.embedding import row_service as jrs
from elasticdl_tpu.embedding import table as jtable
from elasticdl_tpu.master import row_reshard as jrr
from elasticdl_tpu.native import row_store as jnative
from elasticdl_tpu_torch.embedding import optimizer as popt
from elasticdl_tpu_torch.embedding import row_service as prs
from elasticdl_tpu_torch.embedding import table as ptable
from elasticdl_tpu_torch.embedding.row_service import (
    DirectTransport,
    HostRowService,
    make_remote_engine,
)
from elasticdl_tpu_torch.embedding.shard_map import ShardMap, bucket_of
from elasticdl_tpu_torch.master import row_reshard as prr
from elasticdl_tpu_torch.master.row_reshard import (
    ReshardPolicy,
    ShardMapController,
)
from elasticdl_tpu_torch.native import row_store as pnative
from elasticdl_tpu_torch.observability import default_registry
from elasticdl_tpu_torch.tools.check_reshard import check_reshard

DIM = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_check_reshard():
    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    from check_reshard import check_reshard as jax_check

    return jax_check


# ---- fixtures -----------------------------------------------------------


def _start_shard(opt=None, **kwargs):
    svc = HostRowService(
        {"items": ptable.EmbeddingTable("items", DIM)},
        popt.HostOptimizerWrapper(opt or popt.SGD(lr=0.5)), **kwargs,
    )
    return svc.start()


def _fleet(n, tmp_path, policy=None, opt=None):
    """n started shards wired to each other and to a controller by
    in-process transports, the map bootstrapped over them."""
    shards = [_start_shard(opt=opt) for _ in range(n)]
    addrs = [f"localhost:{s.port}" for s in shards]
    by_addr = dict(zip(addrs, shards))

    def factory(a):
        return DirectTransport(by_addr[a])

    for s in shards:
        s.transport_factory = factory
    ctrl = ShardMapController(str(tmp_path / "shard_map.json"),
                              transport_factory=factory, policy=policy)
    ctrl.bootstrap(addrs)
    return shards, addrs, by_addr, ctrl


def _add_target(shards, by_addr, opt=None):
    target = _start_shard(opt=opt)
    addr = f"localhost:{target.port}"
    by_addr[addr] = target
    target.transport_factory = shards[0].transport_factory
    shards.append(target)
    return target, addr


def _engine(addrs, **kwargs):
    return make_remote_engine(",".join(addrs), id_keys={"items": "ids"},
                              retries=2, backoff_secs=0.1, **kwargs)


def _stop(shards):
    for s in shards:
        s.stop(0)


def _spread_ids(n, seed=5):
    rng = np.random.RandomState(seed)
    return np.unique(rng.randint(0, 1_000_000, n).astype(np.int64))


def _family(name):
    snap = default_registry().snapshot()["families"]
    for f in snap:
        if f["name"].endswith(name):
            return f
    return None


def _total(name):
    f = _family(name)
    if f is None:
        return 0.0
    return sum(s.get("value", s.get("count", 0)) for s in f["series"])


# ---- the table's peek ---------------------------------------------------


def test_peek_reads_without_materialising_as_jax():
    jt, pt = jtable.EmbeddingTable("t", DIM), ptable.EmbeddingTable("t", DIM)
    ids = np.array([3, 70, 9001], np.int64)
    for t in (jt, pt):
        t.get(ids)
        t.enable_dirty_tracking()
    np.testing.assert_array_equal(pt.peek(ids), jt.peek(ids))
    assert pt.dirty_count == 0 and pt.num_rows == 3
    with pytest.raises(KeyError):
        pt.peek([4])
    assert pt.num_rows == 3


# ---- REDIRECT convergence (a version bump mid-stream) --------------------


def test_map_version_bump_mid_stream_retries_cleanly(tmp_path):
    """A client routing under epoch v is not told of a cutover: its pulls
    and pushes to the old home are redirected and land on the new home
    without loss or a second apply."""
    shards, addrs, by_addr, ctrl = _fleet(2, tmp_path)
    engine = _engine(addrs)
    table = engine.tables["items"]
    ids = _spread_ids(64)
    before = table.get(ids)
    assert engine.shard_map.version == 1

    _target, addr3 = _add_target(shards, by_addr)
    ctrl.split(0, new_addr=addr3)
    assert ctrl.map.version == 3

    np.testing.assert_array_equal(table.get(ids), before)
    assert engine.shard_map.version == ctrl.map.version
    grads = np.ones((ids.size, DIM), np.float32)
    engine.optimizer.apply_gradients(table, ids, grads)
    np.testing.assert_allclose(table.get(ids), before - 0.5 * grads,
                               rtol=1e-6)
    m = ctrl.map
    for i in ids.tolist():
        homes = [k for k, svc in enumerate(shards)
                 if bool(svc._tables["items"].contains([i])[0])]
        assert homes == [int(m.home_of_ids([i])[0])]
    engine.close()
    _stop(shards)


def test_migration_moves_optimizer_slots_in_lockstep(tmp_path):
    """Adam: a migrated row's m/v slots land on the target exactly as the
    source held them and leave the source; the apply counts follow."""
    shards, addrs, by_addr, ctrl = _fleet(2, tmp_path,
                                          opt=popt.Adam(lr=0.05))
    engine = _engine(addrs)
    table = engine.tables["items"]
    ids = _spread_ids(48, seed=9)
    rng = np.random.RandomState(3)
    for _ in range(3):
        engine.optimizer.apply_gradients(
            table, ids, rng.rand(ids.size, DIM).astype(np.float32))
    lo, hi = ctrl.map.split_plan(0)
    b = bucket_of(ids)
    moved = ids[(b >= lo) & (b < hi) & (ctrl.map.home_of_ids(ids) == 0)]
    assert moved.size > 0
    src_slots = {
        name: np.asarray(view.get(moved.tolist()))
        for name, view in shards[0].host_tables.items()
        if name.startswith("items-")
    }
    assert sorted(src_slots) == ["items-m", "items-v"]
    assert any(np.abs(v).sum() > 0 for v in src_slots.values())

    target, addr3 = _add_target(shards, by_addr, opt=popt.Adam(lr=0.05))
    ctrl.split(0, new_addr=addr3)
    assert ctrl.map.home_of_ids(moved).tolist() == [2] * moved.size
    for name, want in src_slots.items():
        got = np.asarray(target.host_tables[name].get(moved.tolist()))
        np.testing.assert_array_equal(got, want)
        assert not shards[0]._optimizer._slot_tables[name].contains(
            moved).any()
    assert target._optimizer._steps.get("items") == (
        shards[0]._optimizer._steps.get("items")) == 3
    engine.close()
    _stop(shards)


def test_fenced_pushes_retry_and_apply_exactly_once(tmp_path):
    """A push racing the migration lands once: either in the copy's
    catch-up or, refused by the write fence, on its retry."""
    shards, addrs, by_addr, ctrl = _fleet(2, tmp_path)
    engine = _engine(addrs)
    table = engine.tables["items"]
    ids = _spread_ids(32, seed=13)
    before = table.get(ids)
    pushed = {"n": 0}

    def racing_push(_svc, _mig, _view, _chunk):
        if pushed["n"] == 0:
            pushed["n"] = 1

            def go():
                engine.optimizer.apply_gradients(
                    table, ids, np.ones((ids.size, DIM), np.float32))

            pushed["thread"] = threading.Thread(target=go, daemon=True)
            pushed["thread"].start()

    _target, addr3 = _add_target(shards, by_addr)
    prs.set_reshard_chaos_hooks(mid_migrate=racing_push)
    try:
        ctrl.split(0, new_addr=addr3)
    finally:
        prs.set_reshard_chaos_hooks(mid_migrate=None)
    assert pushed["n"] == 1
    pushed["thread"].join(timeout=30)
    np.testing.assert_allclose(table.get(ids), before - 0.5, rtol=1e-6)
    engine.close()
    _stop(shards)


def test_fence_refuses_a_push_until_the_cutover(tmp_path):
    """Between the final delta and the cutover a push to the range
    answers "fenced" and applies nothing; the cutover turns the fence
    into a redirect, and an expired fence lifts itself."""
    svc = HostRowService({"items": ptable.EmbeddingTable("items", DIM)},
                         popt.HostOptimizerWrapper(popt.SGD(lr=0.5)))
    two = ShardMap.bootstrap(["a", "b"])
    svc.install_shard_map(two, 0)
    ids = np.array([10, 20], np.int64)
    req = {"table": "items", "ids": ids,
           "grads": np.ones((2, DIM), np.float32)}
    svc._fences.append((0, 64, time.monotonic() + 60))
    assert svc._push_row_grads(dict(req)) == {
        "reshard": {"reason": "fenced"}}
    assert svc._push_count == 0
    with pytest.raises(prs.ReshardFenced):
        prs._check_reshard({"reshard": {"reason": "fenced"}})
    svc.install_shard_map(two.move_range(0, 64, 1), 0)
    assert svc._fences == []
    assert svc._push_row_grads(dict(req))["reshard"]["reason"] == \
        "not_owner"
    svc._fences.append((100, 200, time.monotonic() - 1))
    far = {"table": "items", "ids": np.array([150], np.int64),
           "grads": np.ones((1, DIM), np.float32)}
    assert "reshard" not in svc._push_row_grads(far)
    assert svc._fences == [] and svc._push_count == 1


# ---- hot-row replicas ---------------------------------------------------


def test_replica_refresh_and_staleness_metric(tmp_path):
    """A push to a replicated id refreshes its copies; replica reads
    serve the fresh bytes and the staleness histogram observes the
    lag."""
    policy = ReshardPolicy(replica_min_pulls=2, replica_top_k=8,
                           replica_count=2)
    shards, addrs, by_addr, ctrl = _fleet(3, tmp_path, policy=policy)
    engine = _engine(addrs)
    table = engine.tables["items"]
    hot = np.array([5, 9000], np.int64)
    for _ in range(6):
        table.get(hot)
    stale0 = _total("row_replica_staleness_seconds")
    reads0 = _total("row_replica_reads_total")
    assert ctrl.update_replicas()
    m = ctrl.map
    assert all(m.replica_targets("items", int(i)) for i in hot)
    table.get(hot)
    assert engine.shard_map.version == m.version

    engine.optimizer.apply_gradients(
        table, hot, np.ones((hot.size, DIM), np.float32))
    ok = False
    deadline = time.time() + 5.0
    while time.time() < deadline and not ok:
        ok = True
        for i in hot.tolist():
            home = int(m.home_of_ids([i])[0])
            fresh = by_addr[m.shards[home]]._tables["items"].get([i])[0]
            for r in m.replica_targets("items", i):
                entry = by_addr[m.shards[r]]._replica_store.get(
                    "items", {}).get(i)
                if entry is None or not np.array_equal(
                        entry[0], np.asarray(fresh, np.float32)):
                    ok = False
        time.sleep(0.02)
    assert ok, "replica copies did not refresh within the window"
    ref = table.get(hot)
    for _ in range(4):
        np.testing.assert_array_equal(table.get(hot), ref)
    assert _total("row_replica_staleness_seconds") > stale0
    assert _total("row_replica_reads_total") > reads0
    engine.close()
    _stop(shards)


def test_replica_miss_falls_back_to_home(tmp_path):
    """A designated replica whose refresh has not landed answers a miss;
    the read falls back to the home."""
    shards, addrs, by_addr, ctrl = _fleet(2, tmp_path)
    engine = _engine(addrs)
    table = engine.tables["items"]
    ids = np.array([123], np.int64)
    ref = table.get(ids)
    with ctrl._lock:
        ctrl._map = ctrl.map.with_replicas({"items": {123: (1,)}})
        ctrl._persist()
        ctrl._sync_locked()
    by_addr[addrs[1]]._replica_store.clear()
    for _ in range(4):
        np.testing.assert_array_equal(table.get(ids), ref)
    engine.close()
    _stop(shards)


def test_dead_replica_falls_back_to_home(tmp_path):
    """A replica whose server is gone must not fail the read."""
    shards, addrs, by_addr, ctrl = _fleet(2, tmp_path)
    engine = _engine(addrs)
    table = engine.tables["items"]
    ids = np.array([7], np.int64)
    ref = table.get(ids)
    with ctrl._lock:
        ctrl._map = ctrl.map.with_replicas({"items": {7: (1,)}})
        ctrl._persist()
        ctrl._sync_locked()
    engine.shard_map.update(ctrl.map.to_json())
    shards[1].stop(0)
    for _ in range(3):
        np.testing.assert_array_equal(table.get(ids), ref)
    engine.close()
    shards[0].stop(0)


# ---- migration with tiered tables ---------------------------------------


def test_migration_streams_cold_rows_without_promotion(tmp_path):
    """A tiered source migrates a mostly cold range by segment reads:
    no cold row is promoted through the hot budget, the target gets the
    rows byte for byte, and the source drops them from both tiers."""
    svc = HostRowService({"items": ptable.EmbeddingTable("items", DIM)},
                         popt.HostOptimizerWrapper(popt.SGD(lr=0.5)))
    svc.configure_tiering(str(tmp_path / "cold"), hot_budget_rows=32,
                          background_compact=False)
    svc.start()
    target = _start_shard()
    by_addr = {f"localhost:{svc.port}": svc,
               f"localhost:{target.port}": target}
    svc.transport_factory = lambda a: DirectTransport(by_addr[a])
    target.transport_factory = svc.transport_factory
    ctrl = ShardMapController(
        str(tmp_path / "sm.json"),
        transport_factory=lambda a: DirectTransport(by_addr[a]))
    ctrl.bootstrap([f"localhost:{svc.port}"])
    ids = np.arange(0, 256, dtype=np.int64) * 37
    rows = np.random.RandomState(7).rand(ids.size, DIM).astype(np.float32)
    table = svc._tables["items"]
    table.set(ids, rows)
    assert svc.tier_stats()["items"]["cold_rows"] > 0
    hot_before = set(table._hot)
    stats = ctrl.split(0, new_addr=f"localhost:{target.port}")
    assert set(table._hot) <= hot_before
    moved = ids[ctrl.map.home_of_ids(ids) == 1]
    assert moved.size > 0 and stats["rows"] == moved.size
    np.testing.assert_array_equal(
        target._tables["items"].get(moved.tolist()),
        rows[np.isin(ids, moved)])
    assert not table.contains(moved).any()
    svc.stop(0)
    target.stop(0)


# ---- the controller: persistence, journal, policy -----------------------


def test_controller_persist_and_resume(tmp_path):
    shards, addrs, by_addr, ctrl = _fleet(2, tmp_path)
    _target, addr3 = _add_target(shards, by_addr)
    ctrl.split(0, new_addr=addr3)
    again = ShardMapController(
        str(tmp_path / "shard_map.json"),
        transport_factory=lambda a: DirectTransport(by_addr[a]))
    assert again.map == ctrl.map
    assert again.resume() is None
    assert again.map.version == ctrl.map.version == 3
    state = json.load(open(tmp_path / "shard_map.json"))
    assert state["migration"] is None and state["mig_seq"] == 1
    _stop(shards)


def test_controller_appends_shard_map_records_to_its_journal(tmp_path):
    """Each published epoch appends a ``shard_map`` record (version and
    map) to the journal it was given, the JAX controller's records; a
    journal that fails does not stop the epoch."""

    class FakeJournal:
        def __init__(self, fail=False):
            self.records, self.fail = [], fail

        def append(self, kind, **fields):
            if self.fail:
                raise OSError("disk full")
            self.records.append((kind, fields))

    addrs = ["a", "b", "c"]
    fakes = {a: FakeShardTransport() for a in addrs}
    journals = {}
    for name, mod in (("port", prr), ("jax", jrr)):
        journals[name] = FakeJournal()
        ctrl = mod.ShardMapController(
            str(tmp_path / f"{name}.json"),
            transport_factory=lambda a: fakes[a], journal=journals[name])
        ctrl.bootstrap(addrs[:2])
        ctrl.add_shard("c")
        ctrl.move_range(0, 0, 64, 2)
    assert journals["port"].records == journals["jax"].records
    kinds = [k for k, _ in journals["port"].records]
    assert set(kinds) == {"shard_map"}
    assert [f["version"] for _, f in journals["port"].records] == [
        1, 2, 2, 3, 3]
    assert journals["port"].records[-1][1]["map"] == ShardMap.from_json(
        journals["port"].records[-1][1]["map"]).to_json()
    broken = prr.ShardMapController(
        str(tmp_path / "broken.json"),
        transport_factory=lambda a: fakes[a], journal=FakeJournal(True))
    assert broken.bootstrap(addrs[:2]).version == 1
    assert os.path.exists(tmp_path / "broken.json")


@pytest.mark.parametrize("rates", [
    {0: 10, 1: 10}, {0: 300, 1: 290}, {0: 900, 1: 100}, {0: 500},
    {0: 50, 1: 400, 2: 60}, {0: 0, 1: 2000},
])
def test_policy_pick_move_thresholds(rates):
    policy = ReshardPolicy(imbalance_factor=2.0, min_rows_per_tick=100)
    want = jrr.ReshardPolicy(imbalance_factor=2.0,
                             min_rows_per_tick=100).pick_move(rates)
    assert policy.pick_move(rates) == want
    assert ReshardPolicy(imbalance_factor=2.0, min_rows_per_tick=100
                         ).pick_move({0: 900, 1: 100}) == (0, 1)


@pytest.mark.parametrize("num_shards,count", [(3, 2), (4, 1), (1, 2),
                                              (2, 0)])
def test_policy_pick_replicas_ring_spread(num_shards, count):
    kw = dict(replica_top_k=2, replica_min_pulls=10, replica_count=count)
    hot = {"items": {7: 100, 8: 50, 9: 5}, "other": {3: 64}}
    out = ReshardPolicy(**kw).pick_replicas(
        hot, num_shards, home_of=lambda table, i: i % num_shards)
    assert out == jrr.ReshardPolicy(**kw).pick_replicas(
        hot, num_shards, home_of=lambda table, i: i % num_shards)
    if num_shards == 3 and count == 2:
        assert set(out["items"]) == {7, 8}
        assert out["items"][7] == (2, 0)


# ---- retirement of a merged-away shard -----------------------------------


class FakeShardTransport:
    def __init__(self):
        self.map = None
        self.shard_id = None

    def call(self, method, **fields):
        if method == "set_shard_map":
            self.map = fields["map"]
            self.shard_id = int(fields["shard_id"])
            return {}
        if method == "shard_stats":
            return {
                "shard_id": self.shard_id,
                "map_version": self.map["version"] if self.map else 0,
                "pulled_rows": 0, "pushed_rows": 0,
                "num_rows": {}, "hot": {},
            }
        return {}  # begin_ingest / migrate_out / end_ingest


def test_controller_retires_drained_shard(tmp_path):
    fakes = {addr: FakeShardTransport() for addr in ("a", "b", "c")}
    controller = ShardMapController(
        str(tmp_path / "map.json"),
        transport_factory=lambda addr: fakes[addr],
        policy=ReshardPolicy(cooldown_secs=30.0))
    controller.bootstrap(["a", "b", "c"])
    controller.merge(2, 0)
    assert controller.map.buckets_owned(2) == 0
    assert len(controller.map.shards) == 3
    assert controller.tick(now=100.0) is None
    assert controller.tick(now=200.0) == "retire:2"
    assert controller.map.shards == ["a", "b"]
    assert {fakes[a].map["version"] for a in ("a", "b")} == {
        controller.map.version}
    assert {fakes[a].shard_id for a in ("a", "b")} == {0, 1}
    again = ShardMapController(str(tmp_path / "map.json"),
                               transport_factory=lambda addr: fakes[addr])
    assert again._drained == []
    assert again.map.shards == ["a", "b"]


def test_controller_keeps_drained_shard_while_laggards_exist(tmp_path):
    fakes = {addr: FakeShardTransport() for addr in ("a", "b", "c")}

    class Laggard(FakeShardTransport):
        def call(self, method, **fields):
            if method == "set_shard_map":
                return {}  # never installs (a restart-looping shard)
            return super().call(method, **fields)

    fakes["b"] = Laggard()
    controller = ShardMapController(
        str(tmp_path / "map.json"),
        transport_factory=lambda addr: fakes[addr],
        policy=ReshardPolicy(cooldown_secs=30.0))
    controller.bootstrap(["a", "b", "c"])
    controller.merge(2, 0)
    for now in (100.0, 200.0, 300.0):
        assert controller.tick(now=now) != "retire:2"
    assert len(controller.map.shards) == 3


def test_tick_moves_a_range_off_an_imbalance(tmp_path):
    """The policy tick, primed by one poll, moves the hot shard's upper
    half to the cold shard once their row rates part by the factor."""
    policy = ReshardPolicy(imbalance_factor=2.0, min_rows_per_tick=10,
                           replica_count=0, cooldown_secs=0.0)
    shards, addrs, by_addr, ctrl = _fleet(2, tmp_path, policy=policy)
    ids0 = np.arange(0, 64, dtype=np.int64)  # buckets of shard 0
    assert (ctrl.map.home_of_ids(ids0) == 0).all()
    assert ctrl.tick(now=10.0) is None  # primes the rates
    for _ in range(4):
        shards[0]._pull_rows({"table": "items", "ids": ids0})
    lo, hi = ctrl.map.split_plan(0)
    assert (lo, hi) == (2048, 4096)
    assert ctrl.tick(now=20.0) == "move:0->1"
    assert ctrl.map.version == 2
    assert ctrl.map.ranges_of(0) == [(0, lo)]
    assert ctrl.map.buckets_owned(1) == 8192 - lo
    assert [s._shard_map.version for s in shards] == [2, 2]
    _stop(shards)


# ---- the fsck -----------------------------------------------------------


def _write(path, state):
    with open(path, "w") as fh:
        json.dump(state, fh)


_FSCK_CASES = {
    "missing": None,
    "clean": {},
    "copy": {"phase": "copy"},
    "cutover_before_flip": {"phase": "cutover"},
    "unknown_phase": {"phase": "warp"},
    "bad_range": {"phase": "copy", "lo": 5, "hi": 5},
    "source_outside": {"phase": "copy", "source": 7},
}


@pytest.mark.parametrize("case", sorted(_FSCK_CASES))
def test_check_reshard_fsck_matches_jax(tmp_path, case):
    """The port's fsck and the JAX tool give the same errors and report
    on the same state file."""
    state = str(tmp_path / "sm.json")
    spec = _FSCK_CASES[case]
    m = ShardMap.bootstrap(["a", "b"])
    if spec is not None:
        good = {"map": m.to_json(), "migration": None, "mig_seq": 0}
        if spec:
            lo, hi = m.split_plan(0)
            good["migration"] = {"migration_id": "m1", "source": 0,
                                 "target": 1, "lo": lo, "hi": hi}
            good["migration"].update(spec)
        _write(state, good)
    errors, report = check_reshard(state)
    assert (errors, report) == _jax_check_reshard()(state)
    if case == "clean":
        assert not errors and report["map_version"] == 1
    elif case == "copy":
        assert not errors and report["resumable"]
    else:
        assert errors


def test_check_reshard_probes_live_shards(tmp_path):
    shards, addrs, by_addr, ctrl = _fleet(2, tmp_path)
    path = str(tmp_path / "shard_map.json")
    errors, report = check_reshard(path, probe_addrs=addrs)
    assert not errors and report["shards_probed"] == 2
    with ctrl._lock:
        ctrl._map = ctrl.map.move_range(0, 8, 1)
        ctrl._persist()
    errors, report = check_reshard(path, probe_addrs=addrs)
    assert not errors and report["shards_behind"] == addrs
    shards[0].install_shard_map(ctrl.map.move_range(8, 16, 1), 0)
    errors, _ = check_reshard(path, probe_addrs=addrs)
    assert any("AHEAD" in e for e in errors)
    from elasticdl_tpu_torch.tools import check_reshard as tool

    assert tool.main([path]) == 0
    assert tool.main([path, "--probe", ",".join(addrs)]) == 1
    _stop(shards)


# ---- the two packages held to each other ----------------------------------

ADDRS = ["shard-a", "shard-b", "shard-c"]
PKGS = {"port": (prs, popt, ptable, pnative, prr),
        "jax": (jrs, jopt, jtable, jnative, jrr)}
SCHEDULE_PUSHES, SPLIT_AT, MERGE_AT = 12, 4, 8


def _pkg_service(pkg, store, rule):
    rs, opt, table, native, _ = PKGS[pkg]
    optimizer = {"sgd": lambda: opt.SGD(lr=0.3),
                 "adam": lambda: opt.Adam(lr=0.01),
                 "adagrad": lambda: opt.Adagrad(lr=0.1)}[rule]()
    if store == "native":
        return rs.HostRowService(
            {"items": native.make_host_table("items", DIM)},
            native.make_host_optimizer(optimizer))
    return rs.HostRowService({"items": table.EmbeddingTable("items", DIM)},
                             opt.HostOptimizerWrapper(optimizer))


def _schedule(seed=11):
    rng = np.random.RandomState(seed)
    hot = np.array([17, 8300, 500_001], np.int64)
    out = []
    for _ in range(SCHEDULE_PUSHES):
        ids = np.unique(np.concatenate(
            [rng.randint(0, 1_000_000, 40).astype(np.int64), hot]))
        out.append((ids, rng.rand(ids.size, DIM).astype(np.float32)))
    return hot, out


def _route(ctrl, services, method, ids, **fields):
    m = ctrl.map
    home = m.home_of_ids(ids)
    for s in sorted(set(home.tolist())):
        sel = home == s
        req = {"table": "items", "ids": ids[sel]}
        for k, v in fields.items():
            req[k] = v[sel] if isinstance(v, np.ndarray) else v
        resp = getattr(services[m.shards[s]], method)(req)
        assert "reshard" not in resp, resp


def _settle_replicas(services, ctrl):
    """Wait until every replica copy equals its home's row."""
    m = ctrl.map
    deadline = time.time() + 10.0
    while True:
        stale = []
        for addr in m.shards:
            store = services[addr]._replica_store.get("items", {})
            for i, entry in store.items():
                home = services[m.shards[int(m.home_of_ids([i])[0])]]
                want = np.asarray(home._tables["items"].get([i])[0],
                                  np.float32)
                if not np.array_equal(entry[0], want):
                    stale.append(i)
        designated = sum(len(r) for r in
                         m.replicas.get("items", {}).values())
        held = sum(len(services[a]._replica_store.get("items", {}))
                   for a in m.shards)
        if not stale and held == designated:
            return held
        assert time.time() < deadline, (stale, held, designated)
        time.sleep(0.02)


def _run_package(pkg, store, rule, tmp_path):
    """One package's fleet through the schedule: a split onto shard-c at
    SPLIT_AT, replicas designated, a merge of shard-c back at MERGE_AT,
    then the drained shard retired. Returns every shard's views, the
    state file's bytes at each stage, shard_stats and replica counts."""
    rs, _, _, _, rr = PKGS[pkg]
    services = {a: _pkg_service(pkg, store, rule) for a in ADDRS}

    def factory(a):
        return rs.DirectTransport(services[a])

    for svc in services.values():
        svc.transport_factory = factory
    state = str(tmp_path / f"{pkg}.json")
    ctrl = rr.ShardMapController(
        state, transport_factory=factory,
        policy=rr.ReshardPolicy(replica_min_pulls=2, replica_top_k=4,
                                replica_count=1, cooldown_secs=30.0))
    ctrl.bootstrap(ADDRS[:2])
    hot, schedule = _schedule()
    files, stats = [], []
    for k, (ids, grads) in enumerate(schedule):
        if k == SPLIT_AT:
            for _ in range(3):
                _route(ctrl, services, "_pull_rows", hot)
            split = ctrl.split(0, new_addr=ADDRS[2])
            files.append(open(state, "rb").read())
            assert ctrl.update_replicas()
            files.append(open(state, "rb").read())
        if k == MERGE_AT:
            ctrl.merge(2, 1)
            files.append(open(state, "rb").read())
        _route(ctrl, services, "_push_row_grads", ids, grads=grads,
               client="trainer", seq=k + 1)
        _route(ctrl, services, "_pull_rows", ids[:8])
    held = _settle_replicas(services, ctrl)
    stats = {a: services[a]._shard_stats({"top_k": 6}) for a in ADDRS}
    assert ctrl.tick(now=100.0) is None
    acted = ctrl.tick(now=200.0)
    files.append(open(state, "rb").read())
    views = {a: {n: v.to_arrays()
                 for n, v in services[a].host_tables.items()}
             for a in ADDRS}
    out = dict(views=views, files=files, stats=stats, acted=acted,
               held=held, split=split, map=ctrl.map.to_json(),
               versions={a: services[a]._shard_map.version for a in ADDRS})
    ctrl.close()
    for svc in services.values():
        svc.stop(0)
    return out


@pytest.mark.parametrize("store,rule", [
    ("python", "adam"), ("python", "sgd"), ("native", "adam"),
    ("native", "adagrad"),
])
def test_split_merge_retire_parity_with_jax(tmp_path, store, rule):
    port = _run_package("port", store, rule, tmp_path)
    jax = _run_package("jax", store, rule, tmp_path)
    assert port["acted"] == jax["acted"] == "retire:2"
    assert port["files"] == jax["files"]
    assert len(port["files"]) == 4
    assert port["stats"] == jax["stats"]
    assert port["held"] == jax["held"] > 0
    for key in ("rows", "bytes", "catchup_rounds"):
        assert port["split"][key] == jax["split"][key]
    assert port["map"] == jax["map"] and len(port["map"]["shards"]) == 2
    assert port["versions"] == jax["versions"]
    for addr in ADDRS:
        pv, jv = port["views"][addr], jax["views"][addr]
        assert sorted(pv) == sorted(jv)
        for name in pv:
            for a, b in zip(pv[name], jv[name]):
                assert a.dtype == b.dtype and a.shape == b.shape, name
                assert a.tobytes() == b.tobytes(), (addr, name)
    # Every id lives on one home; the merged-away shard holds nothing.
    assert port["views"]["shard-c"]["items"][0].size == 0
    assert port["stats"]["shard-c"]["num_rows"]["items"] == 0


# ---- interop: each package's controller over the other's services --------


def _wire_fleet(pkg):
    rs, opt, table, _, _ = PKGS[pkg]
    svcs = [rs.HostRowService(
        {"items": table.EmbeddingTable("items", DIM)},
        opt.HostOptimizerWrapper(opt.Adam(lr=0.02))).start()
        for _ in range(3)]
    return svcs, [f"localhost:{s.port}" for s in svcs]


@pytest.mark.parametrize("services,controller", [("port", "jax"),
                                                 ("jax", "port")])
def test_controller_moves_a_range_over_the_other_package(
        tmp_path, services, controller):
    """Over gRPC: one package's controller splits a live fleet of the
    other's services in the middle of a push stream from a port client;
    the rows gathered from the fleet equal a fleet that never moved."""
    rr = PKGS[controller][4]
    ids = _spread_ids(96, seed=31)
    rng = np.random.RandomState(2)
    grads = [rng.rand(ids.size, DIM).astype(np.float32) for _ in range(4)]
    gathered = {}
    for moved in (True, False):
        svcs, addrs = _wire_fleet(services)
        ctrl = rr.ShardMapController(str(tmp_path / f"{moved}.json"))
        try:
            ctrl.bootstrap(addrs[:2])
            engine = _engine(addrs[:2])
            for k, g in enumerate(grads):
                if moved and k == 2:
                    stats = ctrl.split(0, new_addr=addrs[2])
                    assert stats["rows"] > 0
                engine.optimizer.apply_gradients(
                    engine.tables["items"], ids, g)
            gathered[moved] = engine.tables["items"].get(ids)
            if moved:
                assert ctrl.map.version == 3
                assert engine.shard_map.version == 3
                for s, svc in enumerate(svcs):
                    held = svc._tables["items"].all_ids()
                    assert (ctrl.map.home_of_ids(held) == s).all()
                assert svcs[2]._tables["items"].num_rows > 0
            engine.close()
        finally:
            ctrl.close()
            for s in svcs:
                s.stop(0)
    np.testing.assert_array_equal(gathered[True], gathered[False])


# ---- hedged pulls -------------------------------------------------------


def test_hedged_pull_rides_out_a_stalled_handler():
    """With ``hedge_reads`` a pull whose first send stalls past the
    fleet's p99 is sent again; the second answer wins with the same
    bytes."""
    svc = HostRowService({"items": ptable.EmbeddingTable("items", DIM)},
                         popt.HostOptimizerWrapper(popt.SGD(lr=0.5)))
    real = svc._pull_rows
    stall = {"next": False}

    def pull(request):
        if stall["next"]:
            stall["next"] = False
            time.sleep(0.6)
        return real(request)

    svc._pull_rows = pull
    svc.start()
    try:
        engine = make_remote_engine(f"localhost:{svc.port}",
                                    id_keys={"items": "ids"},
                                    hedge_reads=True)
        table = engine.tables["items"]
        ids = np.array([1, 2, 3], np.int64)
        ref = table.get(ids)
        for _ in range(8):  # the p99 learns a fast pull
            table.get(ids)
        wins0 = _total("rpc_hedge_wins_total")
        stall["next"] = True
        t0 = time.monotonic()
        np.testing.assert_array_equal(table.get(ids), ref)
        assert time.monotonic() - t0 < 0.5
        assert _total("rpc_hedge_wins_total") == wins0 + 1
        engine.close()
    finally:
        svc.stop(0)


# ---- the master hosts the controller ------------------------------------


def test_master_main_starts_and_ticks_a_controller(tmp_path):
    """``master.main --row_reshard --row_reshard_state S
    --row_service_addr a,b`` bootstraps the map over the shards, ticks
    the controller in its run loop and closes it on stop; without a
    state file the flag is refused."""
    from elasticdl_tpu_torch.common.args import parse_master_args
    from elasticdl_tpu_torch.master.main import Master
    from elasticdl_tpu_torch.testing.data import (
        create_frappe_record_file,
        model_zoo_dir,
    )

    svcs = [_start_shard() for _ in range(2)]
    addrs = ",".join(f"localhost:{s.port}" for s in svcs)
    rec = create_frappe_record_file(str(tmp_path / "t.rec"), 64, seed=0,
                                    input_length=10, max_id=5500)
    base = ["--model_zoo", model_zoo_dir(), "--model_def",
            "deepfm.deepfm_host.custom_model", "--training_data", rec,
            "--minibatch_size", "16", "--master_addr", "localhost:0",
            "--row_service_addr", addrs, "--row_reshard"]
    state = str(tmp_path / "authority.json")
    master = Master(parse_master_args(
        base + ["--row_reshard_state", state,
                "--row_reshard_cooldown_secs", "5",
                "--row_replica_count", "1"]))
    ticks = []
    try:
        master.prepare()
        ctrl = master.row_reshard
        assert ctrl.policy.cooldown_secs == 5.0
        assert ctrl.policy.replica_count == 1
        assert [s._shard_map.version for s in svcs] == [1, 1]
        real_tick = ctrl.tick

        def tick():
            ticks.append(real_tick())
            master.request_stop()  # one tick, then the loop exits

        ctrl.tick = tick
        master.run(poll_secs=0.01)  # stops the master and the controller
        assert ticks == [None]  # the first tick primes the rates
        assert ctrl._transports == {}  # closed
    finally:
        for s in svcs:
            s.stop(0)
    errors, report = check_reshard(state)
    assert not errors and report["num_shards"] == 2
    no_state = Master(parse_master_args(base))
    with pytest.raises(ValueError, match="row_reshard_state"):
        no_state.prepare()
    no_state.stop()
    with pytest.raises(NotImplementedError, match="item 8d"):
        Master(parse_master_args(base + ["--row_reshard_state", state,
                                         "--row_pod_autoscale"]))
