"""The port's row service over several shards, on the CPU: the JAX
package's sharded ``tests/test_row_service.py`` cases run against the
port (its slow two-shard job at a tier-1 size), plus the shard map's
enforcement (REDIRECT, erase on a new epoch, the map riding the
checkpoint) and the multi-table remote engine, whose table fan-out
matches the in-process serial loop.
"""

import threading
import time

import numpy as np
import pytest

from elasticdl_tpu_torch.checkpoint import CheckpointSaver
from elasticdl_tpu_torch.embedding.host_engine import (
    HostEmbeddingEngine,
    HostStepRunner,
)
from elasticdl_tpu_torch.embedding.optimizer import (
    SGD,
    Adagrad,
    HostOptimizerWrapper,
)
from elasticdl_tpu_torch.embedding.row_service import (
    HostRowService,
    make_remote_engine,
    validate_shard_layout,
)
from elasticdl_tpu_torch.embedding.shard_map import ShardMap
from elasticdl_tpu_torch.embedding.table import EmbeddingTable
from elasticdl_tpu_torch.model_zoo.deepfm import (
    deepfm_host,
    deepfm_host_multi,
)
from elasticdl_tpu_torch.native.row_store import make_host_optimizer
from elasticdl_tpu_torch.testing.cluster import MiniCluster
from elasticdl_tpu_torch.testing.data import (
    create_frappe_record_file,
    model_zoo_dir,
)

DIM = 8


def _start_shard(port=0, lr=0.5, ckpt=""):
    return HostRowService(
        {"items": EmbeddingTable("items", DIM)},
        HostOptimizerWrapper(SGD(lr=lr)),
        checkpoint_dir=ckpt, checkpoint_steps=1 if ckpt else 0,
    ).start(f"localhost:{port}")


def _homes_hold(shards, smap, table="items"):
    """Every materialised row of every shard sits on its map home."""
    for s, svc in enumerate(shards):
        ids, _ = svc._tables[table].to_arrays()
        assert ids.size > 0, s
        assert (smap.home_of_ids(ids) == s).all(), (s, ids)


def test_sharded_engine_routes_by_shard_map():
    """Pulls and pushes scatter through the bootstrap map: each server
    materialises only the rows it homes; values equal the single-table
    reference."""
    shards = [_start_shard(), _start_shard()]
    try:
        addrs = [f"localhost:{s.port}" for s in shards]
        engine = make_remote_engine(",".join(addrs),
                                    id_keys={"items": "ids"})
        table = engine.tables["items"]
        assert table.dim == DIM
        smap = ShardMap.bootstrap(addrs)
        ids = np.array([3, 8, 13, 5000, 7123], np.int64)
        assert set(smap.home_of_ids(ids).tolist()) == {0, 1}
        rows = table.get(ids)
        ref = EmbeddingTable("items", DIM)
        np.testing.assert_array_equal(rows, ref.get(ids))

        grads = np.arange(5 * DIM, dtype=np.float32).reshape(5, DIM)
        engine.optimizer.apply_gradients(table, ids, grads)
        after = table.get(ids)
        np.testing.assert_allclose(after, rows - 0.5 * grads, rtol=1e-6)
        _homes_hold(shards, smap)
    finally:
        for s in shards:
            s.stop(0)


def test_sharded_engine_rejects_mismatched_shards():
    a = HostRowService({"items": EmbeddingTable("items", DIM)},
                       HostOptimizerWrapper(SGD(lr=0.5))).start()
    b = HostRowService({"other": EmbeddingTable("other", DIM)},
                       HostOptimizerWrapper(SGD(lr=0.5))).start()
    try:
        with pytest.raises(ValueError, match="different tables"):
            make_remote_engine(
                f"localhost:{a.port},localhost:{b.port}",
                id_keys={"items": "ids"},
            )
    finally:
        a.stop(0)
        b.stop(0)


def test_sharded_export_dense_merges_home_shards():
    shards = [_start_shard(), _start_shard()]
    try:
        addr = ",".join(f"localhost:{s.port}" for s in shards)
        engine = make_remote_engine(addr, id_keys={"items": "ids"})
        table = engine.tables["items"]
        ids = np.array([1, 2, 6])
        engine.optimizer.apply_gradients(
            table, ids, np.ones((3, DIM), np.float32)
        )
        dense = table.export_dense(10, chunk=4)
        assert dense.shape == (10, DIM)
        ref = EmbeddingTable("items", DIM)
        want = np.asarray(ref.get(np.arange(10)), np.float32)
        want[ids] -= 0.5
        np.testing.assert_allclose(dense, want, rtol=1e-6)
    finally:
        for s in shards:
            s.stop(0)


def test_two_shard_job_rides_a_shard_relaunch(tmp_path):
    """A 2-worker deepfm_host job over a 2-shard row service; shard 1 is
    stopped after the first reported task and relaunched on the same
    port from its own checkpoint. The workers ride the outage on RPC
    retries, the job drains, and every shard holds only the rows the
    bootstrap map homes on it."""
    train = create_frappe_record_file(str(tmp_path / "t.rec"), 96,
                                      seed=11, max_id=deepfm_host.MAX_ID)

    def shard_service(port=0, ckpt=""):
        svc = deepfm_host.make_row_service()
        if ckpt:
            svc.configure_checkpoint(ckpt, checkpoint_steps=1)
        return svc.start(f"localhost:{port}")

    ckpt1 = str(tmp_path / "shard1_ckpt")
    shards = [shard_service(), shard_service(ckpt=ckpt1)]
    addr = ",".join(f"localhost:{s.port}" for s in shards)
    port1 = shards[1].port
    state = {"killed": False, "relaunched": None}

    def kill_once(_request):
        if state["killed"]:
            return
        state["killed"] = True
        shards[1].stop(0)

        def relaunch():
            time.sleep(1.0)
            for _ in range(20):
                try:
                    state["relaunched"] = shard_service(port=port1,
                                                        ckpt=ckpt1)
                    return
                except Exception:
                    time.sleep(0.5)

        threading.Thread(target=relaunch, daemon=True).start()

    cluster = MiniCluster(
        model_zoo=model_zoo_dir(),
        model_def="deepfm.deepfm_host.custom_model",
        training_data=train,
        minibatch_size=16,
        num_minibatches_per_task=1,
        num_workers=2,
        step_runner_factory=lambda: deepfm_host.make_host_runner(
            remote_addr=addr
        ),
        worker_callbacks={"report_task_result": kill_once},
        device="cpu",
    )
    results = cluster.run()
    assert cluster.finished
    assert sum(r["trained_batches"] for r in results) == 96 // 16
    assert state["killed"] and state["relaunched"] is not None
    live = [shards[0], state["relaunched"]]
    try:
        _homes_hold(live, ShardMap.bootstrap(addr.split(",")),
                    deepfm_host.TABLE_NAME)
    finally:
        for svc in live:
            svc.stop(0)


def test_shard_layout_guard(tmp_path):
    """A relaunch under another static shard layout fails loudly; a
    directory with versions and no marker is the one-shard layout."""
    ckpt = str(tmp_path / "ck")
    validate_shard_layout(ckpt, shard=1, num_shards=2)  # fresh: records
    validate_shard_layout(ckpt, shard=1, num_shards=2)  # same: ok
    with pytest.raises(SystemExit, match="shard 1/2"):
        validate_shard_layout(ckpt, shard=1, num_shards=4)

    legacy = str(tmp_path / "legacy")
    CheckpointSaver(legacy).save(1, {"w": np.zeros((2,), np.float32)})
    with pytest.raises(SystemExit, match="shard 0/1"):
        validate_shard_layout(legacy, shard=0, num_shards=2)
    validate_shard_layout(legacy, shard=0, num_shards=1)  # unchanged: ok


def test_sharded_table_concurrent_pull_while_push_disjoint_masks():
    """A pull in flight while the pushes of another id set land, over 3
    shards: every pulled value has one right answer, and every push
    lands exactly once on its home shard."""
    shards = [_start_shard(lr=1.0) for _ in range(3)]
    try:
        addr = ",".join(f"localhost:{s.port}" for s in shards)
        engine = make_remote_engine(addr, id_keys={"items": "ids"})
        table = engine.tables["items"]
        ref = EmbeddingTable("items", DIM)
        # x271 spreads the ids across the bucket space.
        pull_ids = np.arange(0, 30, dtype=np.int64) * 271
        push_ids = np.arange(100, 130, dtype=np.int64) * 271
        grads = np.ones((len(push_ids), DIM), np.float32)
        errors = []
        rounds = 8
        barrier = threading.Barrier(2)

        def puller():
            try:
                for _ in range(rounds):
                    barrier.wait()
                    got = table.get(pull_ids)
                    np.testing.assert_array_equal(got, ref.get(pull_ids))
            except Exception as exc:
                errors.append(exc)

        def pusher():
            try:
                for _ in range(rounds):
                    barrier.wait()
                    engine.optimizer.apply_gradients(table, push_ids,
                                                     grads)
            except Exception as exc:
                errors.append(exc)

        threads = [threading.Thread(target=puller),
                   threading.Thread(target=pusher)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        np.testing.assert_allclose(
            table.get(push_ids),
            np.asarray(ref.get(push_ids)) - rounds * 1.0 * grads,
            rtol=1e-6,
        )
        _homes_hold(shards, engine.shard_map.get())
    finally:
        for s in shards:
            s.stop(0)


def test_sharded_export_dense_stride_interleave_n3_nondivisible():
    shards = [_start_shard() for _ in range(3)]
    try:
        addr = ",".join(f"localhost:{s.port}" for s in shards)
        engine = make_remote_engine(addr, id_keys={"items": "ids"})
        table = engine.tables["items"]
        vocab = 10  # 10 % 3 != 0, 10 % 4 != 0
        trained = np.array([0, 1, 2, 5, 9], np.int64)
        engine.optimizer.apply_gradients(
            table, trained, np.ones((len(trained), DIM), np.float32)
        )
        dense = table.export_dense(vocab, chunk=4)
        assert dense.shape == (vocab, DIM)
        ref = EmbeddingTable("items", DIM)
        want = np.asarray(ref.get(np.arange(vocab)), np.float32)
        want[trained] -= 0.5
        np.testing.assert_allclose(dense, want, rtol=1e-6)
    finally:
        for s in shards:
            s.stop(0)


# ---- the map's enforcement ---------------------------------------------


def test_stale_client_follows_redirect():
    """A client bootstrapped on one shard meets a two-shard epoch: the
    old shard redirects the ids it gave away, the client adopts the
    carried map, and pulls and pushes reach the new home."""
    a, b = _start_shard(), _start_shard()
    try:
        addr_a, addr_b = f"localhost:{a.port}", f"localhost:{b.port}"
        engine = make_remote_engine(addr_a, id_keys={"items": "ids"})
        table = engine.tables["items"]
        assert engine.shard_map.version == 1
        ids = np.array([1, 4097, 8000], np.int64)  # buckets 1, 4097, 8000
        before = table.get(ids)
        assert a._tables["items"].num_rows == 3
        split = ShardMap.bootstrap([addr_a]).add_shard(addr_b).move_range(
            4096, 8192, 1)
        b.install_shard_map(split, 1)
        resp = a.install_shard_map(split, 0)
        assert resp == {"accepted": True, "version": 3, "erased_rows": 2}
        engine.optimizer.apply_gradients(table, ids,
                                         np.ones((3, DIM), np.float32))
        assert engine.shard_map.version == 3
        np.testing.assert_allclose(table.get(ids), before - 0.5,
                                   rtol=1e-6)
        np.testing.assert_array_equal(a._tables["items"].all_ids(), [1])
        np.testing.assert_array_equal(b._tables["items"].all_ids(),
                                      [4097, 8000])
        redirects = a._m_redirects.snapshot()
        assert sum(s["value"] for s in redirects["series"]) >= 1
    finally:
        a.stop(0)
        b.stop(0)


def test_new_epoch_erases_unowned_rows_and_slots():
    svc = HostRowService({"items": EmbeddingTable("items", DIM)},
                         HostOptimizerWrapper(Adagrad(lr=0.1)))
    ids = np.array([5, 4100, 9000], np.int64)  # buckets 5, 4100, 808
    svc._push_row_grads({"table": "items", "ids": ids,
                         "grads": np.ones((3, DIM), np.float32)})
    two = ShardMap.bootstrap(["a:1", "b:2"])
    assert svc.install_shard_map(two, 0)["erased_rows"] == 2  # row + slot
    acc = svc._optimizer._slot_table(svc._tables["items"], "accumulator")
    np.testing.assert_array_equal(svc._tables["items"].all_ids(), [5, 9000])
    np.testing.assert_array_equal(acc.all_ids(), [5, 9000])
    # Same version: idempotent, nothing erased; an older one refused.
    assert svc.install_shard_map(two, 0)["erased_rows"] == 0
    newer = two.move_range(0, 8192, 1)
    svc.install_shard_map(newer, 0)
    assert svc._get_shard_map({})["map"]["version"] == 2
    older = {"map": two.to_json(), "shard_id": 0}
    assert svc._set_shard_map(older) == {"accepted": False, "version": 2}
    # Shard 0 owns nothing now: a push is redirected, applies nothing.
    resp = svc._push_row_grads({"table": "items", "ids": ids[:1],
                                "grads": np.ones((1, DIM), np.float32)})
    assert resp["reshard"]["reason"] == "not_owner"
    assert resp["reshard"]["map"] == newer.to_json()
    assert svc._push_count == 1


def test_map_rides_the_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ck")
    two = ShardMap.bootstrap(["a:1", "b:2"])
    svc = HostRowService({"items": EmbeddingTable("items", DIM)},
                         HostOptimizerWrapper(SGD(lr=0.5)),
                         checkpoint_dir=ckpt, checkpoint_steps=1)
    svc.install_shard_map(two, 1)
    ids = np.array([4100, 5000], np.int64)
    svc._push_row_grads({"table": "items", "ids": ids,
                         "grads": np.ones((2, DIM), np.float32)})
    svc.stop()
    back = HostRowService({"items": EmbeddingTable("items", DIM)},
                          HostOptimizerWrapper(SGD(lr=0.5)),
                          checkpoint_dir=ckpt)
    assert back._get_shard_map({}) == {"map": two.to_json(),
                                       "shard_id": 1}
    assert back._push_count == 1
    np.testing.assert_array_equal(back._tables["items"].get(ids),
                                  svc._tables["items"].get(ids))
    assert back._pull_rows({"table": "items", "ids": [1]})["reshard"][
        "reason"] == "not_owner"


def test_replica_map_reads_go_through_the_replica():
    """A hot id designated to a replica shard: once the home's warm-up
    refresh lands, the client's reads alternate between home and replica
    (``row_replica_reads_total`` rises) and answer the home's bytes; a
    push refreshes the copy."""
    from elasticdl_tpu_torch.observability import default_registry

    def reads():
        for f in default_registry().snapshot()["families"]:
            if f["name"].endswith("row_replica_reads_total"):
                return sum(s["value"] for s in f["series"])
        return 0.0

    shards = [_start_shard() for _ in range(2)]
    try:
        addrs = [f"localhost:{s.port}" for s in shards]
        engine = make_remote_engine(",".join(addrs),
                                    id_keys={"items": "ids"})
        hot = np.array([3], np.int64)  # bucket 3: homed on shard 0
        table = engine.tables["items"]
        ref = table.get(hot)
        smap = ShardMap.bootstrap(addrs).with_replicas({"items": {3: (1,)}})
        for k, s in enumerate(shards):
            s.install_shard_map(smap, k)
        deadline = time.time() + 5
        while 3 not in shards[1]._replica_store.get("items", {}):
            assert time.time() < deadline, "the replica never warmed"
            time.sleep(0.01)
        before = reads()
        for _ in range(4):
            np.testing.assert_array_equal(table.get(hot), ref)
        assert engine.shard_map.version == smap.version
        assert reads() >= before + 1
        engine.optimizer.apply_gradients(table, hot,
                                         np.ones((1, DIM), np.float32))
        fresh = shards[0]._tables["items"].get(hot)
        while not np.array_equal(
                shards[1]._replica_store["items"][3][0], fresh[0]):
            assert time.time() < deadline + 5, "the copy never refreshed"
            time.sleep(0.01)
        for _ in range(2):
            np.testing.assert_array_equal(table.get(hot), fresh)
        engine.close()
    finally:
        for s in shards:
            s.stop(0)


def _multi_run(tmp_path, remote):
    """deepfm_host_multi through one worker with a synchronous runner:
    over the remote engine, whose three tables' pulls and pushes fan out
    on the engine's pool, or over the zoo's in-process tables, which
    take the engine's serial loop. Returns the per-step losses, the
    tables' (ids, rows) and whether the engine's pool ran."""
    svc = deepfm_host_multi.make_row_service().start() if remote else None
    try:
        id_keys = {name: key for name, (key, _) in
                   deepfm_host_multi.FIELD_GROUPS.items()}
        engines = []

        def runner():
            if remote:
                engine = make_remote_engine(f"localhost:{svc.port}",
                                            id_keys=id_keys)
            else:
                engine = HostEmbeddingEngine(
                    deepfm_host_multi._make_tables(),
                    make_host_optimizer(SGD(lr=0.05)), id_keys=id_keys)
            engines.append(engine)
            return HostStepRunner(engine, async_apply=False)

        cluster = MiniCluster(
            model_zoo=model_zoo_dir(),
            model_def="deepfm.deepfm_host_multi.custom_model",
            training_data=str(tmp_path / "t.rec"),
            minibatch_size=16, num_minibatches_per_task=2,
            step_runner_factory=runner, device="cpu",
        )
        losses = []
        worker = cluster.workers[0]
        step = worker._step_runner.train_step

        def recording_train_step(loss_fn):
            inner = step(loss_fn)

            def run(state, batch):
                state, metrics = inner(state, batch)
                losses.append(float(metrics["loss"]))
                return state, metrics
            return run

        worker._step_runner.train_step = recording_train_step
        cluster.run()
        assert cluster.finished
        pooled = engines[0]._table_pool is not None
        held = svc.host_tables if remote else engines[0].tables
        tables = {name: held[name].to_arrays()
                  for name in deepfm_host_multi.FIELD_GROUPS}
        return losses, tables, pooled
    finally:
        if svc is not None:
            svc.stop(0)


def test_multi_table_fanout_matches_serial(tmp_path):
    create_frappe_record_file(str(tmp_path / "t.rec"), 64, seed=5,
                              max_id=deepfm_host_multi.MAX_ID)
    fan_losses, fan_tables, fan_pooled = _multi_run(tmp_path, True)
    ser_losses, ser_tables, ser_pooled = _multi_run(tmp_path, False)
    assert fan_pooled and not ser_pooled
    assert len(fan_losses) == 4
    assert fan_losses == ser_losses
    for name in deepfm_host_multi.FIELD_GROUPS:
        np.testing.assert_array_equal(fan_tables[name][0],
                                      ser_tables[name][0])
        np.testing.assert_array_equal(fan_tables[name][1],
                                      ser_tables[name][1])
