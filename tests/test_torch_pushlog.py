"""The port's write-ahead push log (``elasticdl_tpu_torch/storage/
pushlog.py``) on the CPU: the JAX package's ``tests/test_pushlog.py``
cases run against the port (group commit, ack modes, torn tails,
checkpoint-fenced truncation, replay through the row service, the
fsck), and the two packages' logs held to each other: records are
byte-equal, and a log written by either package's service replays
through the other's to equal rows and (client, seq) maps. The quake
drill's fast lane, the fsync-stall SLO rule and the fsck umbrella wait
for the port of the chaos plane, the SLO engine and ``tools/fsck``."""

import json
import os
import sys
import threading

import numpy as np
import pytest

from elasticdl_tpu.embedding import row_service as jrs
from elasticdl_tpu.embedding.optimizer import Adam as JaxAdam
from elasticdl_tpu.native import row_store as jnative
from elasticdl_tpu.observability import default_registry as jax_registry
from elasticdl_tpu.storage import pushlog as jlog
from elasticdl_tpu_torch.checkpoint.saver import CheckpointSaver
from elasticdl_tpu_torch.embedding import row_service as prs
from elasticdl_tpu_torch.embedding.optimizer import Adam
from elasticdl_tpu_torch.native import row_store as pnative
from elasticdl_tpu_torch.observability import default_registry
from elasticdl_tpu_torch.storage import pushlog as plog
from elasticdl_tpu_torch.storage.pushlog import (
    PushLog,
    PushLogError,
    encode_record,
)
from elasticdl_tpu_torch.tools.check_pushlog import (
    check_one_log,
    check_pushlog,
)

DIM = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _push(log, version, ids=None, client="c", seq=None):
    ids = np.asarray(
        ids if ids is not None else [version, version + 1], np.int64
    )
    return log.append(
        version=version, client=client,
        seq=seq if seq is not None else version, table="t",
        ids=ids, grads=np.full((ids.size, DIM), float(version), np.float32),
        applied_at=100.0 + version, map_version=0,
    )


def _build_service(ckpt_dir=None, log_dir=None, steps=4, group_ms=0.5,
                   pkg="port"):
    mod, native, opt = ((prs, pnative, Adam(lr=0.01)) if pkg == "port"
                        else (jrs, jnative, JaxAdam(lr=0.01)))
    svc = mod.HostRowService({"t": native.make_host_table("t", DIM)},
                             native.make_host_optimizer(opt))
    if ckpt_dir:
        svc.configure_checkpoint(str(ckpt_dir), checkpoint_steps=steps,
                                 delta_chain_max=3, async_write=False)
    if log_dir:
        svc.configure_push_log(str(log_dir), group_ms=group_ms)
    return svc


def _schedule(n, seed=3, vocab=96):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = np.unique(rng.randint(0, vocab, 14)).astype(np.int64)
        out.append((ids, rng.rand(ids.size, DIM).astype(np.float32)))
    return out


def _drive(svc, schedule, start, end, client):
    for seq in range(start, end + 1):
        ids, grads = schedule[seq - 1]
        svc._push_row_grads({"table": "t", "ids": ids, "grads": grads,
                             "client": client, "seq": seq})


def _row_state(svc):
    return {name: view.to_arrays()
            for name, view in svc.host_tables.items()
            if name != "__row_service_seqs__"}


def _assert_state_equal(a, b):
    assert sorted(a) == sorted(b)
    for name in sorted(a):
        assert np.array_equal(np.asarray(a[name][0]),
                              np.asarray(b[name][0])), name
        assert np.array_equal(np.asarray(a[name][1], np.float64),
                              np.asarray(b[name][1], np.float64)), name


# ---- raw log semantics ----------------------------------------------------


def test_append_replay_roundtrip(tmp_path):
    log = PushLog(str(tmp_path / "wal"), group_ms=0.5)
    for v in range(1, 6):
        _push(log, v).wait(10.0)
    log.close()
    reopened = PushLog(str(tmp_path / "wal"), group_ms=0.5)
    records = list(reopened.replay_records())
    assert [r["v"] for r in records] == [1, 2, 3, 4, 5]
    assert records[2]["client"] == "c" and records[2]["seq"] == 3
    assert np.array_equal(records[2]["ids"], np.asarray([3, 4], np.int64))
    assert float(records[2]["grads"][0, 0]) == 3.0
    assert records[2]["applied_at"] == pytest.approx(103.0)
    reopened.close()


def test_durable_ticket_is_on_disk_when_acked(tmp_path):
    log = PushLog(str(tmp_path / "wal"), group_ms=0.5)
    _push(log, 1).wait(10.0)
    stats = log.segment_stats()
    assert stats[0]["last_v"] == 1 and stats[0]["bytes"] > 0
    # A fresh scan (what a relaunch does) sees the record.
    records, torn = plog.scan_segment(stats[0]["path"])
    assert torn is None and [r["v"] for _, _, r in records] == [1]
    log.close()


def test_stop_drains_queued_applied_ack_records(tmp_path):
    # applied acks: the handler never waits, but close() lands every
    # queued record.
    log = PushLog(str(tmp_path / "wal"), group_ms=200.0, ack="applied")
    for v in range(1, 9):
        _push(log, v)
    log.close()
    reopened = PushLog(str(tmp_path / "wal"))
    assert [r["v"] for r in reopened.replay_records()] == list(range(1, 9))
    reopened.close()


def test_abandon_loses_at_most_the_group_window(tmp_path):
    # The SIGKILL stand-in: queued records die with the process, and a
    # dropped ticket fails at once instead of hanging a waiter.
    log = PushLog(str(tmp_path / "wal"), group_ms=60_000.0, ack="applied")
    t = _push(log, 1)
    log.abandon()
    reopened = PushLog(str(tmp_path / "wal"))
    assert list(reopened.replay_records()) == []
    reopened.close()
    with pytest.raises(PushLogError, match="abandoned"):
        t.wait(1.0)


def test_barrier_covers_inflight_batch(tmp_path, monkeypatch):
    """A duplicate push's ack barriers on the original record, which may
    sit in a batch the commit thread already dequeued but has not
    fsynced: the queue is empty then, and the barrier must still
    block."""
    log = PushLog(str(tmp_path / "wal"), group_ms=0.0)
    gate = threading.Event()
    entered = threading.Event()
    real_fsync = os.fsync

    def slow_fsync(fd):
        entered.set()
        gate.wait(10.0)
        return real_fsync(fd)

    monkeypatch.setattr(plog.os, "fsync", slow_fsync)
    ticket = _push(log, 1)
    assert entered.wait(5.0)
    done = threading.Event()
    threading.Thread(target=lambda: (log.barrier(), done.set()),
                     daemon=True).start()
    assert not done.wait(0.3)
    gate.set()
    assert done.wait(5.0)
    ticket.wait(5.0)
    monkeypatch.undo()
    log.close()


def test_append_after_close_raises(tmp_path):
    log = PushLog(str(tmp_path / "wal"))
    log.close()
    with pytest.raises(PushLogError):
        _push(log, 1)


def test_bad_ack_mode_raises(tmp_path):
    with pytest.raises(ValueError, match="push_log_ack"):
        PushLog(str(tmp_path / "wal"), ack="sometimes")


def test_torn_tail_truncates_to_intact_prefix(tmp_path):
    log = PushLog(str(tmp_path / "wal"), group_ms=0.5)
    for v in (1, 2, 3):
        _push(log, v).wait(10.0)
    log.close()
    seg = str(tmp_path / "wal" / "pushlog-000000.wal")
    with open(seg, "ab") as fh:
        fh.write(b"\xff\x00\x00\x00TORN-GROUP-COMMIT")
    reopened = PushLog(str(tmp_path / "wal"))
    assert [r["v"] for r in reopened.replay_records()] == [1, 2, 3]
    _push(reopened, 4).wait(10.0)
    reopened.close()
    final = PushLog(str(tmp_path / "wal"))
    assert [r["v"] for r in final.replay_records()] == [1, 2, 3, 4]
    final.close()


def test_rotation_and_checkpoint_fenced_truncation(tmp_path):
    log = PushLog(str(tmp_path / "wal"), group_ms=0.0,
                  segment_max_bytes=256)
    for v in range(1, 13):
        _push(log, v).wait(10.0)
    stats = log.segment_stats()
    assert len(stats) > 2
    tail = max(stats)
    covered = stats[sorted(stats)[1]]["last_v"]
    assert log.truncate_through(covered) == 2
    stats = log.segment_stats()
    assert tail in stats
    # Never the tail, even when wholly covered.
    assert log.truncate_through(10 ** 9) == len(stats) - 1
    assert list(log.segment_stats()) == [tail]
    _push(log, 13).wait(10.0)
    log.close()
    reopened = PushLog(str(tmp_path / "wal"))
    versions = [r["v"] for r in reopened.replay_records()]
    assert versions and versions[-1] == 13
    assert versions == list(range(versions[0], 14))
    reopened.close()


def test_fsync_hook_runs_ahead_of_each_commit(tmp_path):
    calls = []
    plog.set_chaos_hooks(fsync=calls.append)
    try:
        log = PushLog(str(tmp_path / "wal"), group_ms=0.0)
        _push(log, 1).wait(10.0)
        log.close()
    finally:
        plog.set_chaos_hooks()
    assert calls and set(calls) == {"pushlog"}


# ---- service integration --------------------------------------------------


def test_kill_and_relaunch_replays_without_redriving(tmp_path):
    """Kill (abandon) mid-run; the relaunch restores the chain and
    replays the WAL's tail, no push is driven again, and the state lands
    byte-equal to a run that was never killed."""
    schedule = _schedule(20)
    twin = _build_service(tmp_path / "twin_ckpt")
    _drive(twin, schedule, 1, 20, "push")
    twin_state = _row_state(twin)
    twin.stop()
    svc = _build_service(tmp_path / "ckpt", tmp_path / "wal")
    _drive(svc, schedule, 1, 13, "push")
    svc._push_log.abandon()
    svc._ckpt_writer.close()
    svc2 = _build_service(tmp_path / "ckpt", tmp_path / "wal")
    assert svc2._push_count == 13
    _drive(svc2, schedule, 14, 20, "push")
    _assert_state_equal(twin_state, _row_state(svc2))
    svc2.stop()


def test_replay_is_idempotent_across_repeated_relaunches(tmp_path):
    schedule = _schedule(7)
    svc = _build_service(tmp_path / "ckpt", tmp_path / "wal", steps=100)
    _drive(svc, schedule, 1, 7, "push")
    svc._push_log.abandon()
    svc._ckpt_writer.close()
    state = None
    for _ in range(3):
        svc = _build_service(tmp_path / "ckpt", tmp_path / "wal",
                             steps=100)
        assert svc._push_count == 7
        fresh = _row_state(svc)
        if state is not None:
            _assert_state_equal(state, fresh)
        state = fresh
        svc._push_log.abandon()
        svc._ckpt_writer.close()


def test_duplicate_push_after_replay_is_deduped(tmp_path):
    schedule = _schedule(5)
    svc = _build_service(tmp_path / "ckpt", tmp_path / "wal")
    _drive(svc, schedule, 1, 5, "push")
    svc._push_log.abandon()
    svc._ckpt_writer.close()
    svc2 = _build_service(tmp_path / "ckpt", tmp_path / "wal")
    ids, grads = schedule[4]
    resp = svc2._push_row_grads({"table": "t", "ids": ids, "grads": grads,
                                 "client": "push", "seq": 5})
    assert resp.get("duplicate") is True
    assert svc2._push_count == 5
    svc2.stop()


def test_replay_filters_ranges_that_migrated_away(tmp_path):
    from elasticdl_tpu_torch.embedding.shard_map import (
        NUM_BUCKETS,
        ShardMap,
        bucket_of,
    )

    schedule = _schedule(8, vocab=2 * NUM_BUCKETS)
    svc = _build_service(log_dir=tmp_path / "wal")
    _drive(svc, schedule, 1, 8, "push")
    svc._push_log.abandon()
    # The relaunch owns only the lower half of the buckets: the WAL's
    # records for the upper half must not resurrect rows moved away.
    svc2 = _build_service()
    half = NUM_BUCKETS // 2
    shard_map = ShardMap.bootstrap(["here:1", "away:1"])
    assert shard_map.owner_table[half] == 1
    svc2.install_shard_map(shard_map, 0)
    svc2.configure_push_log(str(tmp_path / "wal"))
    ids, _ = svc2._tables["t"].to_arrays()
    assert ids.size
    assert (bucket_of(np.asarray(ids, np.int64)) < half).all()
    # The version advances through filtered records.
    assert svc2._push_count == 8
    svc2._push_log.close()


def test_service_stop_drains_applied_ack_queue(tmp_path):
    schedule = _schedule(6)
    svc = _build_service()
    svc.configure_push_log(str(tmp_path / "wal"), group_ms=500.0,
                           ack="applied")
    _drive(svc, schedule, 1, 6, "push")
    svc.stop()
    relaunched = _build_service(log_dir=tmp_path / "wal")
    assert relaunched._push_count == 6
    relaunched._push_log.close()


def test_durable_wait_timeout_counts_and_raises(tmp_path, monkeypatch):
    """A durable ack whose covering fsync outlasts the wait ceiling
    raises and counts in row_push_durable_wait_timeouts_total; the
    record still commits."""
    gate = threading.Event()
    real_fsync = os.fsync

    def slow_fsync(fd):
        gate.wait(10.0)
        return real_fsync(fd)

    svc = _build_service(log_dir=tmp_path / "wal", group_ms=0.0)
    svc.configure_push_durable_wait(0.05)
    counter = default_registry().counter(
        "row_push_durable_wait_timeouts_total").labels()
    before = counter.value
    monkeypatch.setattr(plog.os, "fsync", slow_fsync)
    ids, grads = _schedule(1)[0]
    with pytest.raises(PushLogError, match="did not complete in time"):
        svc._push_row_grads({"table": "t", "ids": ids, "grads": grads,
                             "client": "c", "seq": 1})
    assert counter.value == before + 1
    gate.set()
    svc.stop()
    monkeypatch.undo()
    relaunched = _build_service(log_dir=tmp_path / "wal")
    assert relaunched._push_count == 1
    relaunched._push_log.close()


def test_main_flags_configure_a_durable_tiered_service(tmp_path):
    """``python -m elasticdl_tpu_torch.embedding.row_service`` with the
    tier and WAL flags: pushes over gRPC, a SIGKILL, and a relaunch that
    restores the checkpoint, replays the log's tail and answers the
    pulls of before the kill bit for bit."""
    import re
    import signal
    import subprocess

    from elasticdl_tpu_torch.embedding.row_service import make_remote_engine
    from elasticdl_tpu_torch.testing.data import model_zoo_dir

    ckpt, wal = str(tmp_path / "ckpt"), str(tmp_path / "wal")
    flags = ["--model_zoo", model_zoo_dir(), "--model_def",
             "deepfm.deepfm_host.custom_model", "--addr", "localhost:0",
             "--checkpoint_dir", ckpt, "--checkpoint_steps", "4",
             "--checkpoint_sync", "--hot_budget_rows", "16",
             "--push_log_dir", wal, "--push_log_group_ms", "1"]
    env = dict(os.environ, PYTHONPATH=REPO)

    def start(name):
        log = open(tmp_path / name, "w+")
        proc = subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.embedding."
             "row_service"] + flags, env=env, stdout=log,
            stderr=subprocess.STDOUT)
        import time

        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            log.seek(0)
            text = log.read()
            found = re.search(r"Row service on port (\d+)", text)
            if found:
                return proc, log, int(found.group(1))
            assert proc.poll() is None, text
            time.sleep(0.05)
        proc.kill()
        raise AssertionError("no port")

    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin

    proc, log, port = start("first.log")
    try:
        engine = make_remote_engine(f"localhost:{port}",
                                    {twin.TABLE_NAME: twin.FEATURE_KEY},
                                    retries=2, backoff_secs=0.1)
        table = engine.tables[twin.TABLE_NAME]
        rng = np.random.RandomState(5)
        touched = set()
        for _ in range(6):
            ids = np.unique(rng.randint(0, 400, 40)).astype(np.int64)
            touched.update(ids.tolist())
            engine.optimizer.apply_gradients(
                table, ids, rng.rand(ids.size, twin.EMBEDDING_DIM)
                .astype(np.float32) * 1e-2)
        touched = np.array(sorted(touched), np.int64)
        live = table.get(touched)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(30)
        log.close()
    assert CheckpointSaver(ckpt).get_valid_latest_version() == 4
    proc, log, port = start("second.log")
    try:
        again = make_remote_engine(
            f"localhost:{port}", {twin.TABLE_NAME: twin.FEATURE_KEY},
            retries=2, backoff_secs=0.1).tables[twin.TABLE_NAME]
        np.testing.assert_array_equal(again.get(touched), live)
    finally:
        proc.kill()
        proc.wait(30)
        log.seek(0)
        text = log.read()
        log.close()
    assert "restored version 4" in text
    assert "replayed 2 record(s) past checkpoint version 4" in text
    errors, report = check_one_log(wal, ckpt)
    assert errors == [] and report["last_version"] == 6


# ---- the two packages' logs -----------------------------------------------

_RECORDS = [
    {"v": 1, "client": "w-0", "seq": 1, "table": "t",
     "ids": np.asarray([3, 9], np.int64),
     "grads": np.arange(2 * DIM, dtype=np.float32).reshape(2, DIM),
     "applied_at": 1.7e9 + 0.25, "map_version": 0},
    {"v": 2**40, "client": "", "seq": -1, "table": "ünïcode",
     "ids": np.zeros((0,), np.int64),
     "grads": np.zeros((0, DIM), np.float32),
     "applied_at": 0.0, "map_version": 7},
    {"v": 17, "client": "x" * 300, "seq": 70000, "table": "t",
     "ids": np.asarray([2**62], np.int64),
     "grads": np.full((1, DIM), -1e-30, np.float32),
     "applied_at": 12.0, "map_version": 2**33},
]


@pytest.mark.parametrize("k", range(len(_RECORDS)))
def test_encode_record_byte_equal_to_jax(k):
    record = _RECORDS[k]
    got = encode_record(record)
    assert got == jlog.encode_record(record)
    # Each package decodes the other's.
    back = plog.tensor_utils.loads(plog.unframe_shard_blob(got[4:]))
    assert plog.validate_record_fields(back) is None
    assert jlog.validate_record_fields(back) is None
    assert back["v"] == record["v"] and back["client"] == record["client"]
    np.testing.assert_array_equal(back["grads"], record["grads"])


def test_wal_segments_byte_equal_to_jax(tmp_path):
    """The same appends through both packages' logs (group commit,
    rotation) leave the same files."""
    for mod, name in ((jlog, "jax"), (plog, "port")):
        log = mod.PushLog(str(tmp_path / name), group_ms=0.0,
                          segment_max_bytes=300)
        for v in range(1, 9):
            _push(log, v).wait(10.0)
        log.close()
    jfiles = sorted(os.listdir(tmp_path / "jax"))
    assert jfiles == sorted(os.listdir(tmp_path / "port"))
    assert len(jfiles) > 3
    for name in jfiles:
        with open(tmp_path / "jax" / name, "rb") as a, \
                open(tmp_path / "port" / name, "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_each_package_replays_the_others_wal(tmp_path, writer, reader):
    """A service of one package logs pushes (a checkpoint at 4, a kill
    at 9); the other package's service restores the chain and replays
    the tail: rows, slots, step counters and the (client, seq) map equal
    the writer's, and the next push continues the version count."""
    schedule = _schedule(9, seed=4)
    src = _build_service(tmp_path / "ckpt", tmp_path / "wal", pkg=writer)
    _drive(src, schedule[:5], 1, 5, "a")
    _drive(src, schedule, 6, 9, "b")
    want = {n: v.to_arrays() for n, v in src.host_tables.items()}
    want_seq = dict(src._applied_seq)
    src._push_log.close()
    src._ckpt_writer.close()
    dst = _build_service(tmp_path / "ckpt", tmp_path / "wal", pkg=reader)
    assert dst._push_count == 9
    got = {n: v.to_arrays() for n, v in dst.host_tables.items()}
    _assert_state_equal(want, got)
    assert dict(dst._applied_seq) == want_seq
    assert dst._table_versions["t"] >= 1
    dst.stop()


def test_metric_family_names_equal_jax(tmp_path, monkeypatch):
    """The ``row_push_log_*``, ``row_tier_*`` and durable-wait families
    the port registers are the JAX package's, name for name. Each
    package registers into a fresh registry of its own (the tier gauges
    bind once a process, so their flag is cleared for the test)."""
    from elasticdl_tpu.observability.registry import (
        MetricsRegistry as JaxRegistry,
    )
    from elasticdl_tpu.storage import tiered as jtiered
    from elasticdl_tpu_torch.observability.registry import MetricsRegistry
    from elasticdl_tpu_torch.storage import tiered as ptiered

    prefixes = ("edl_tpu_row_push_log_", "edl_tpu_row_tier_",
                "edl_tpu_row_push_durable")
    names = {}
    for pkg, reg, tiered, log_mod, mod, native, opt in (
            ("jax", JaxRegistry(), jtiered, jlog, jrs, jnative,
             JaxAdam(lr=0.01)),
            ("port", MetricsRegistry(), ptiered, plog, prs, pnative,
             Adam(lr=0.01))):
        monkeypatch.setattr(tiered, "_metrics_bound", False)
        table = tiered.tier_host_tables(
            {"t": native.make_host_table("t", DIM)},
            str(tmp_path / f"cold_{pkg}"),
            tiered.TierPolicy(4, background_compact=False),
            metrics_registry=reg)["t"]
        table.get(np.arange(12, dtype=np.int64))
        table.get(np.arange(4, dtype=np.int64))
        table.tier_group.close()
        log = log_mod.PushLog(str(tmp_path / f"wal_{pkg}"), group_ms=0.0,
                              metrics_registry=reg)
        _push(log, 1).wait(10.0)
        log.close()
        mod.HostRowService({"t": native.make_host_table("t", DIM)},
                           native.make_host_optimizer(opt),
                           metrics_registry=reg)
        names[pkg] = sorted(f["name"] for f in reg.snapshot()["families"]
                            if f["name"].startswith(prefixes))
        # The replay counter lives on the package's default registry.
        _build_service(log_dir=tmp_path / f"wal_{pkg}", pkg=pkg).stop()
        default = jax_registry() if pkg == "jax" else default_registry()
        assert "edl_tpu_row_push_log_replayed_records_total" in {
            f["name"] for f in default.snapshot()["families"]}
    assert names["port"] == names["jax"]
    for name in ("row_push_log_fsync_seconds", "row_push_log_group_size",
                 "row_push_log_bytes_total", "row_push_log_truncations_total",
                 "row_push_durable_wait_timeouts_total",
                 "row_tier_hot_rows", "row_tier_cold_rows",
                 "row_tier_faults_total", "row_tier_fault_rows_total",
                 "row_tier_fault_seconds", "row_tier_evictions_total",
                 "row_tier_compactions_total"):
        assert "edl_tpu_" + name in names["port"], name


# ---- fsck (tools/check_pushlog) -------------------------------------------


def _hand_log(path, records):
    os.makedirs(path)
    with open(os.path.join(path, "MANIFEST.json"), "w") as fh:
        json.dump({"format": "pushlog-v1"}, fh)
    with open(os.path.join(path, "pushlog-000000.wal"), "wb") as fh:
        for v, seq in records:
            fh.write(encode_record({
                "v": v, "client": "c", "seq": seq, "table": "t",
                "ids": np.asarray([1], np.int64),
                "grads": np.ones((1, DIM), np.float32),
                "applied_at": 0.0, "map_version": 0,
            }))


def test_check_pushlog_green_and_coverage(tmp_path):
    svc = _build_service(tmp_path / "ckpt", tmp_path / "wal")
    _drive(svc, _schedule(9), 1, 9, "push")
    svc.stop()
    errors, report = check_one_log(str(tmp_path / "wal"),
                                   str(tmp_path / "ckpt"))
    assert errors == []
    assert report["records"] >= 1
    assert report["checkpoint_tip"] == 8
    errors, tree = check_pushlog(str(tmp_path))
    assert errors == []
    assert tree["records"] == report["records"]


def test_check_pushlog_flags_sealed_tear_and_seq_regression(tmp_path):
    log = PushLog(str(tmp_path / "wal"), group_ms=0.0,
                  segment_max_bytes=128)
    for v in range(1, 7):
        _push(log, v).wait(10.0)
    log.close()
    segs = sorted(p for p in os.listdir(tmp_path / "wal")
                  if p.endswith(".wal"))
    assert len(segs) > 2
    sealed = str(tmp_path / "wal" / segs[0])
    with open(sealed, "r+b") as fh:
        fh.truncate(os.path.getsize(sealed) - 3)
    errors, _ = check_one_log(str(tmp_path / "wal"))
    assert any("sealed segment torn" in e for e in errors)
    _hand_log(str(tmp_path / "bad"), [(1, 5), (2, 4)])
    errors, _ = check_one_log(str(tmp_path / "bad"))
    assert any("strictly monotonic" in e for e in errors)


def test_version_gap_covered_by_checkpoint_is_legal(tmp_path):
    _hand_log(str(tmp_path / "wal"), [(1, 1), (2, 2), (3, 3), (6, 6)])
    errors, report = check_one_log(str(tmp_path / "wal"))
    assert errors == []
    assert report["version_gaps"] == [[3, 6]]
    CheckpointSaver(str(tmp_path / "ckpt")).save(5, {}, embeddings={})
    errors, _ = check_one_log(str(tmp_path / "wal"), str(tmp_path / "ckpt"))
    assert errors == []
    CheckpointSaver(str(tmp_path / "ckpt2")).save(4, {}, embeddings={})
    errors, _ = check_one_log(str(tmp_path / "wal"),
                              str(tmp_path / "ckpt2"))
    assert any("uncovered version gap" in e for e in errors)


def test_check_pushlog_flags_coverage_gap(tmp_path):
    svc = _build_service(tmp_path / "ckpt", tmp_path / "wal", steps=100)
    _drive(svc, _schedule(4), 1, 4, "push")
    svc.stop()
    _hand_log(str(tmp_path / "gap"), [(50, 1)])
    errors, _ = check_one_log(str(tmp_path / "gap"), str(tmp_path / "ckpt"))
    assert any("coverage gap" in e for e in errors)


def test_check_pushlog_matches_jax_tool_and_exit_codes(tmp_path):
    """The port's fsck and the JAX one over the same logs give the same
    errors and report; ``python -m`` exits 0 on a clean log, 1 on a
    broken one."""
    import subprocess

    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import check_pushlog as jax_check

    svc = _build_service(tmp_path / "ckpt", tmp_path / "wal")
    _drive(svc, _schedule(9), 1, 9, "push")
    svc.stop()
    _hand_log(str(tmp_path / "bad"), [(1, 5), (2, 4), (9, 6)])
    for path, ckpt in ((tmp_path / "wal", tmp_path / "ckpt"),
                       (tmp_path / "bad", tmp_path / "ckpt"),
                       (tmp_path, None)):
        ckpt = str(ckpt) if ckpt else None
        assert check_pushlog(str(path), ckpt) == \
            jax_check.check_pushlog(str(path), ckpt)
    for path, code in ((tmp_path / "wal", 0), (tmp_path / "bad", 1)):
        rc = subprocess.run(
            [sys.executable, "-m", "elasticdl_tpu_torch.tools.check_pushlog",
             str(path), "--checkpoint", str(tmp_path / "ckpt")],
            capture_output=True, text=True, cwd=REPO)
        assert rc.returncode == code, rc.stdout + rc.stderr
        assert ("OK:" if code == 0 else "FAIL:") in rc.stdout
