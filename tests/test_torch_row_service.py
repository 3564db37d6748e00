"""The port's row service (``embedding/row_service.py``), one shard, on
the CPU: the JAX package's ``tests/test_row_service.py`` cases of one
shard run against the port, and the same pushes through a JAX
``HostRowService`` and a port one give bit-equal state.

Both packages' services apply pushes with the same row rules (the same
``row_store.cc`` on the native store, the same numpy arithmetic on the
Python one) to rows lazily initialised from the same (name, id) hash,
and key clients by the same blake2b digest, so rows, optimizer slots,
step counters and seq tables are bit-equal, and so are the checkpoint
files (the port's saver writes the JAX saver's bytes).
"""

import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from elasticdl_tpu.checkpoint.saver import CheckpointSaver as JaxSaver
from elasticdl_tpu.embedding import row_service as jrs
from elasticdl_tpu.embedding.optimizer import SGD as JaxSGD
from elasticdl_tpu.embedding.optimizer import Adagrad as JaxAdagrad
from elasticdl_tpu.embedding.optimizer import HostOptimizerWrapper as JaxWrap
from elasticdl_tpu.embedding.table import EmbeddingTable as JaxTable
from elasticdl_tpu.native import row_store as jnative
from elasticdl_tpu_torch.checkpoint import CheckpointHook, CheckpointSaver
from elasticdl_tpu_torch.core.train_state import init_train_state
from elasticdl_tpu_torch.embedding import HostStepRunner
from elasticdl_tpu_torch.embedding import row_service as rs
from elasticdl_tpu_torch.embedding.optimizer import (
    SGD,
    Adagrad,
    HostOptimizerWrapper,
)
from elasticdl_tpu_torch.embedding.row_service import (
    HostRowService,
    make_remote_engine,
)
from elasticdl_tpu_torch.embedding.table import (
    EmbeddingTable,
    get_slot_table_name,
)
from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host
from elasticdl_tpu_torch.native import row_store as pnative
from elasticdl_tpu_torch.testing.cluster import MiniCluster
from elasticdl_tpu_torch.testing.data import (
    create_frappe_record_file,
    model_zoo_dir,
)

DIM = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def service():
    svc = HostRowService(
        {"items": EmbeddingTable("items", DIM)},
        HostOptimizerWrapper(SGD(lr=0.5)),
    ).start()
    yield svc
    svc.stop(0)


def test_pull_initializes_lazily_and_push_updates(service):
    engine = make_remote_engine(
        f"localhost:{service.port}", id_keys={"items": "ids"}
    )
    table = engine.tables["items"]
    assert table.dim == DIM
    rows = table.get(np.array([3, 7]))
    # Lazy init matches the server-side table's deterministic init.
    ref = EmbeddingTable("items", DIM)
    np.testing.assert_array_equal(rows, ref.get([3, 7]))

    grads = np.ones((2, DIM), np.float32)
    engine.optimizer.apply_gradients(table, np.array([3, 7]), grads)
    after = table.get(np.array([3, 7]))
    np.testing.assert_allclose(after, rows - 0.5 * grads, rtol=1e-6)


def test_remote_runner_has_no_local_checkpoint_duty(service):
    engine = make_remote_engine(
        f"localhost:{service.port}", id_keys={"items": "ids"}
    )
    assert HostStepRunner(engine).host_tables is None


def test_two_workers_one_row_service(tmp_path):
    """Two workers with separate remote engines train ONE table through
    the service; every trained row lives on the service."""
    train = create_frappe_record_file(str(tmp_path / "t.rec"), 128, seed=8,
                                      max_id=deepfm_host.MAX_ID)
    svc = deepfm_host.make_row_service().start()
    try:
        addr = f"localhost:{svc.port}"
        cluster = MiniCluster(
            model_zoo=model_zoo_dir(),
            model_def="deepfm.deepfm_host.custom_model",
            training_data=train,
            minibatch_size=16,
            num_minibatches_per_task=2,
            num_workers=2,
            step_runner_factory=lambda: deepfm_host.make_host_runner(
                remote_addr=addr
            ),
            device="cpu",
        )
        results = cluster.run()
        assert cluster.finished
        assert sum(r["trained_batches"] for r in results) == 128 // 16
        table = svc.host_tables[deepfm_host.TABLE_NAME]
        assert table.num_rows > 0
    finally:
        svc.stop(0)


def test_server_side_checkpoint_roundtrip(tmp_path):
    svc = HostRowService(
        {"items": EmbeddingTable("items", DIM)},
        HostOptimizerWrapper(Adagrad(lr=0.1)),
    ).start()
    try:
        engine = make_remote_engine(
            f"localhost:{svc.port}", id_keys={"items": "ids"}
        )
        ids = np.array([1, 5, 9])
        engine.tables["items"].get(ids)
        engine.optimizer.apply_gradients(
            engine.tables["items"], ids, np.ones((3, DIM), np.float32)
        )
        ckpt = str(tmp_path / "ckpt")
        # Server-side checkpoint: rows + Adagrad accumulators + steps.
        state = init_train_state(
            torch.nn.Linear(2, 1),
            lambda params: torch.optim.SGD(params, lr=0.1))
        hook = CheckpointHook(
            checkpoint_dir=ckpt, checkpoint_steps=1, async_save=False,
            host_tables=svc.host_tables,
        )
        hook._save(1, state)

        _, _, embeddings = CheckpointSaver(ckpt).restore()
        assert embeddings["items"].num_rows == 3
        acc_key = get_slot_table_name("items", "accumulator")
        assert embeddings[acc_key].num_rows == 3
    finally:
        svc.stop(0)


def test_build_worker_host_tier_guards(tmp_path):
    """build_worker: a host-tier model with num_workers > 1 demands a
    row service; with --row_service_addr it builds a remote runner."""
    from elasticdl_tpu_torch.common.args import parse_worker_args
    from elasticdl_tpu_torch.worker.main import build_worker

    train = create_frappe_record_file(str(tmp_path / "t.rec"), 32, seed=9)
    base = [
        "--worker_id", "0",
        "--model_zoo", model_zoo_dir(),
        "--model_def", "deepfm.deepfm_host.custom_model",
        "--training_data", train,
        "--minibatch_size", "16",
        "--job_name", "host-guard-test",
        "--device", "cpu",
    ]

    class _StubMaster:
        pass

    with pytest.raises(ValueError, match="row service"):
        build_worker(
            parse_worker_args([*base, "--num_workers", "2"]),
            master_client=_StubMaster(),
        )

    svc = deepfm_host.make_row_service().start()
    try:
        worker = build_worker(
            parse_worker_args([
                *base, "--num_workers", "2",
                "--row_service_addr", f"localhost:{svc.port}",
            ]),
            master_client=_StubMaster(),
        )
        assert worker._step_runner is not None
        assert worker._step_runner.host_tables is None  # service owns rows
    finally:
        svc.stop(0)


def test_service_relaunch_restores_and_clients_retry(tmp_path):
    """The service checkpoints every push, dies, relaunches on the SAME
    port restoring the newest version; an in-flight pull rides the
    outage on retries."""
    ckpt = str(tmp_path / "svc_ckpt")

    def fresh_service(port=0):
        return HostRowService(
            {"items": EmbeddingTable("items", DIM)},
            HostOptimizerWrapper(SGD(lr=0.5)),
            checkpoint_dir=ckpt, checkpoint_steps=1,
        ).start(f"localhost:{port}")

    svc = fresh_service()
    port = svc.port
    engine = make_remote_engine(
        f"localhost:{port}", id_keys={"items": "ids"},
        retries=8, backoff_secs=0.2,
    )
    table = engine.tables["items"]
    ids = np.array([2, 4])
    before = table.get(ids)
    engine.optimizer.apply_gradients(
        table, ids, np.ones((2, DIM), np.float32)
    )  # push 1 -> checkpoint version 1

    svc.stop(0)  # simulated pod death
    relaunched = {}

    def relaunch_later():
        time.sleep(0.8)
        for _ in range(20):
            try:
                relaunched["svc"] = fresh_service(port)
                return
            except Exception:
                time.sleep(0.5)

    t = threading.Thread(target=relaunch_later)
    t.start()
    after = table.get(ids)  # hits the dead service, retries across
    t.join()
    try:
        np.testing.assert_allclose(after, before - 0.5, rtol=1e-6)
        assert relaunched["svc"]._push_count == 1
    finally:
        relaunched["svc"].stop(0)


def _serving_port(proc, timeout=60.0):
    """The port a row-service process logged (``Row service on port
    N``), read from its merged output."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        line = proc.stdout.readline()
        m = re.search(r"Row service on port (\d+)", line or "")
        if m:
            return int(m.group(1))
        if not line and proc.poll() is not None:
            break
    raise AssertionError("service did not report its port")


def test_row_service_process_main(tmp_path):
    """``python -m elasticdl_tpu_torch.embedding.row_service`` serves a
    zoo module's make_row_service."""
    from elasticdl_tpu_torch.comm.rpc import RpcStub

    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.embedding.row_service",
         "--model_zoo", model_zoo_dir(),
         "--model_def", "deepfm.deepfm_host.custom_model",
         "--addr", "localhost:0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path),
    )
    try:
        port = _serving_port(proc)
        stub = RpcStub(f"localhost:{port}", "RowService")
        info = stub.call("table_info", timeout=30)["tables"]
        assert info == {deepfm_host.TABLE_NAME:
                        {"dim": deepfm_host.EMBEDDING_DIM}}
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_retried_push_after_relaunch_is_deduplicated(tmp_path):
    """The restored service still recognises the retried push (the seq
    map rides the checkpoint) and does not apply it twice."""
    ckpt = str(tmp_path / "svc_ckpt")

    def fresh(port=0):
        return HostRowService(
            {"items": EmbeddingTable("items", DIM)},
            HostOptimizerWrapper(SGD(lr=0.5)),
            checkpoint_dir=ckpt, checkpoint_steps=1,
        ).start(f"localhost:{port}")

    svc = fresh()
    engine = make_remote_engine(
        f"localhost:{svc.port}", id_keys={"items": "ids"},
        retries=2, backoff_secs=0.1,
    )
    table = engine.tables["items"]
    ids = np.array([11])
    before = table.get(ids)
    opt = engine.optimizer
    opt.apply_gradients(table, ids, np.ones((1, DIM), np.float32))
    port = svc.port
    svc.stop(0)  # died AFTER the checkpoint that includes the push

    svc2 = fresh(port)
    try:
        # The client retries the SAME seq on its per-shard stream.
        ropt = opt._reg.optimizer(f"localhost:{port}")
        ropt._local.seq -= 1
        opt.apply_gradients(table, ids, np.ones((1, DIM), np.float32))
        after = table.get(ids)
        np.testing.assert_allclose(after, before - 0.5, rtol=1e-6)
    finally:
        svc2.stop(0)


def test_remote_export_dense_no_server_inflation(service):
    engine = make_remote_engine(
        f"localhost:{service.port}", id_keys={"items": "ids"}
    )
    table = engine.tables["items"]
    table.get(np.array([3]))  # one touched row on the server
    dense = table.export_dense(50, chunk=16)
    assert dense.shape == (50, DIM)
    assert service.host_tables["items"].num_rows == 1
    ref = EmbeddingTable("items", DIM)
    np.testing.assert_array_equal(dense[10], ref.get([10])[0])


def test_concurrent_pushes_and_checkpoints_stay_consistent(tmp_path):
    """4 client threads pull and push while a checkpoint follows every
    push: every push lands exactly once, every surviving version is a
    consistent snapshot, and the drain checkpoint restores the live
    rows."""
    ckpt = str(tmp_path / "ckpt")
    svc = HostRowService(
        {"items": EmbeddingTable("items", DIM)},
        HostOptimizerWrapper(SGD(lr=1.0)),
        checkpoint_dir=ckpt, checkpoint_steps=1,
    ).start()
    try:
        addr = f"localhost:{svc.port}"
        pushes, threads_n = 25, 4
        errors = []

        def hammer(tid):
            try:
                engine = make_remote_engine(
                    addr, id_keys={"items": "ids"},
                    retries=2, backoff_secs=0.1,
                )
                table = engine.tables["items"]
                ids = np.array([tid])  # one private row per thread
                for _ in range(pushes):
                    table.get(ids)
                    engine.optimizer.apply_gradients(
                        table, ids, np.ones((1, DIM), np.float32)
                    )
            except Exception as exc:  # surfaced after join
                errors.append(exc)

        threads = [threading.Thread(target=hammer, args=(t,))
                   for t in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive(), "pusher thread hung"
        assert not errors, errors

        ref = EmbeddingTable("items", DIM)
        live = svc.host_tables["items"]
        for tid in range(threads_n):
            expected = ref.get([tid])[0] - pushes * 1.0
            np.testing.assert_allclose(
                live.get(np.array([tid]))[0], expected, rtol=1e-5
            )
        assert svc._push_count == pushes * threads_n

        saver = CheckpointSaver(ckpt)
        for version in saver.list_versions():
            _, _, embeddings = saver.restore(version)
            ids_v, rows_v = embeddings["items"].to_arrays()
            for rid, row in zip(ids_v, rows_v):
                k = ref.get([int(rid)])[0] - row
                np.testing.assert_allclose(k, k[0], atol=1e-5)
                assert -1e-5 <= k[0] <= pushes + 1e-5

        engine = make_remote_engine(
            addr, id_keys={"items": "ids"}, retries=2, backoff_secs=0.1,
        )
        engine.optimizer.apply_gradients(
            engine.tables["items"], np.array([threads_n]),
            np.zeros((1, DIM), np.float32),
        )
        assert svc.checkpoint_now()
        svc2 = HostRowService(
            {"items": EmbeddingTable("items", DIM)},
            HostOptimizerWrapper(SGD(lr=1.0)),
            checkpoint_dir=ckpt,
        )
        restored = svc2.host_tables["items"]
        for tid in range(threads_n):
            np.testing.assert_array_equal(
                restored.get(np.array([tid]))[0],
                live.get(np.array([tid]))[0],
            )
    finally:
        svc.stop(0)


def test_service_restart_mid_job_drains(tmp_path):
    """Kill the row service while a MiniCluster job runs, relaunch it on
    the same port from its checkpoint: the job still drains."""
    train = create_frappe_record_file(str(tmp_path / "t.rec"), 128,
                                      seed=12, max_id=deepfm_host.MAX_ID)
    ckpt = str(tmp_path / "svc_ckpt")

    def fresh(port=0):
        svc = deepfm_host.make_row_service()
        svc.configure_checkpoint(ckpt, checkpoint_steps=2)
        return svc.start(f"localhost:{port}")

    svc = fresh()
    port = svc.port
    cluster = MiniCluster(
        model_zoo=model_zoo_dir(),
        model_def="deepfm.deepfm_host.custom_model",
        training_data=train,
        minibatch_size=16,
        num_minibatches_per_task=2,
        step_runner_factory=lambda: deepfm_host.make_host_runner(
            remote_addr=f"localhost:{port}"
        ),
        device="cpu",
    )
    holder = {}

    def kill_and_relaunch():
        time.sleep(1.0)
        svc.stop(0)
        time.sleep(0.5)
        for _ in range(20):
            try:
                holder["svc"] = fresh(port)
                return
            except Exception:
                time.sleep(0.5)

    t = threading.Thread(target=kill_and_relaunch)
    t.start()
    cluster.run()
    t.join(timeout=60)
    assert cluster.finished
    assert "svc" in holder
    assert holder["svc"].host_tables[deepfm_host.TABLE_NAME].num_rows > 0
    holder["svc"].stop(0)


def test_failed_apply_does_not_burn_seq():
    """A push whose apply raises leaves the seq unrecorded, so the
    client's retry applies instead of being dropped as a duplicate."""

    class FlakyOptimizer(HostOptimizerWrapper):
        def __init__(self):
            super().__init__(SGD(lr=0.5))
            self.fail_next = True

        def apply_gradients(self, table, ids, grads):
            if self.fail_next:
                self.fail_next = False
                raise RuntimeError("transient apply failure")
            return super().apply_gradients(table, ids, grads)

    svc = HostRowService(
        {"items": EmbeddingTable("items", DIM)}, FlakyOptimizer()
    )
    ids = np.array([1, 2], np.int64)
    grads = np.ones((2, DIM), np.float32)
    before = svc._tables["items"].get(ids).copy()
    push = {"table": "items", "ids": ids, "grads": grads,
            "client": "w0", "seq": 1}
    with pytest.raises(RuntimeError):
        svc._push_row_grads(dict(push))
    resp = svc._push_row_grads(dict(push))
    assert not resp.get("duplicate")
    after = svc._tables["items"].get(ids)
    np.testing.assert_allclose(after, before - 0.5 * grads, rtol=1e-6)
    resp = svc._push_row_grads(dict(push))
    assert resp.get("duplicate") is True


# ---- the same pushes through a JAX service and a port one --------------

STORES = {
    "python": (
        lambda opt: ({"items": JaxTable("items", DIM)}, JaxWrap(opt)),
        lambda opt: ({"items": EmbeddingTable("items", DIM)},
                     HostOptimizerWrapper(opt)),
    ),
    "native": (
        lambda opt: ({"items": jnative.NativeEmbeddingTable("items", DIM)},
                     jnative.NativeOptimizerWrapper(opt)),
        lambda opt: ({"items": pnative.NativeEmbeddingTable("items", DIM)},
                     pnative.NativeOptimizerWrapper(opt)),
    ),
}
RULES = {"sgd": (lambda: JaxSGD(lr=0.5), lambda: SGD(lr=0.5)),
         "adagrad": (lambda: JaxAdagrad(lr=0.1), lambda: Adagrad(lr=0.1))}


def _twin_services(store, rule, ckpt_root=None):
    if store == "native" and not (jnative.native_available()
                                  and pnative.native_available()):
        pytest.fail("the native row store did not build in both packages")
    make_jax, make_port = STORES[store]
    jax_rule, port_rule = RULES[rule]
    jax_svc = jrs.HostRowService(*make_jax(jax_rule()))
    port_svc = rs.HostRowService(*make_port(port_rule()))
    if ckpt_root is not None:
        jax_svc.configure_checkpoint(os.path.join(ckpt_root, "jax"), 2,
                                     delta_chain_max=2, async_write=False)
        port_svc.configure_checkpoint(os.path.join(ckpt_root, "port"), 2,
                                      delta_chain_max=2, async_write=False)
    return jax_svc, port_svc


def _push_script(seed=0, pushes=7):
    """Seeded pushes with explicit clients; every third one re-sends the
    previous seq of its client (a retried push, dropped by both)."""
    rng = np.random.RandomState(seed)
    seqs = {"w0": 0, "w1": 0}
    out = []
    for k in range(pushes):
        client = ("w0", "w1")[k % 2]
        if k % 3 == 2:
            seq = seqs[client]
        else:
            seqs[client] += 1
            seq = seqs[client]
        ids = np.unique(rng.randint(0, 40, 6)).astype(np.int64)
        grads = rng.standard_normal((ids.size, DIM)).astype(np.float32)
        out.append({"table": "items", "ids": ids, "grads": grads,
                    "client": client, "seq": seq})
    return out


def _state(svc):
    return {name: view.to_arrays()
            for name, view in svc.host_tables.items()}


@pytest.mark.parametrize("store", sorted(STORES))
@pytest.mark.parametrize("rule", sorted(RULES))
def test_same_pushes_give_bit_equal_state(store, rule):
    jax_svc, port_svc = _twin_services(store, rule)
    replies = []
    for push in _push_script():
        jax_svc._pull_rows({"table": "items", "ids": push["ids"]})
        port_svc._pull_rows({"table": "items", "ids": push["ids"]})
        replies.append((jax_svc._push_row_grads(dict(push)),
                        port_svc._push_row_grads(dict(push))))
    assert [j.get("duplicate") for j, _ in replies] == \
        [p.get("duplicate") for _, p in replies]
    assert sum(bool(p.get("duplicate")) for _, p in replies) == 2
    want, got = _state(jax_svc), _state(port_svc)
    assert sorted(want) == sorted(got)
    assert rs.SEQS_TABLE_NAME in got
    for name in want:
        np.testing.assert_array_equal(got[name][0], want[name][0])
        np.testing.assert_array_equal(got[name][1], want[name][1])
    assert port_svc._push_count == jax_svc._push_count == 5
    assert port_svc._table_versions == jax_svc._table_versions


@pytest.mark.parametrize("lo,hi,stride,offset", [
    (0, 10, 1, 0), (0, 40, 3, 1), (5, 37, 4, 2)])
def test_range_export_matches_jax(lo, hi, stride, offset):
    """The range form of ``export_rows`` (the JAX client's
    ``export_range``): trained rows over the lazy ones, strided."""
    jax_svc, port_svc = _twin_services("python", "sgd")
    for push in _push_script():
        jax_svc._push_row_grads(dict(push))
        port_svc._push_row_grads(dict(push))
    request = {"table": "items", "lo": lo, "hi": hi, "stride": stride,
               "offset": offset}
    got = port_svc._export_rows(dict(request))["rows"]
    np.testing.assert_array_equal(
        got, jax_svc._export_rows(dict(request))["rows"])
    assert got.shape == (len(range(lo + offset, hi, stride)), DIM)
    assert port_svc._tables["items"].num_rows == \
        jax_svc._tables["items"].num_rows


def _tree(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("store", sorted(STORES))
@pytest.mark.parametrize("rule", sorted(RULES))
def test_service_checkpoints_are_byte_equal(tmp_path, store, rule):
    """A base and two deltas (every second push, chains of 2), then the
    drain checkpoint: the two directories hold the same files, byte for
    byte, and each package restores the other's."""
    jax_svc, port_svc = _twin_services(store, rule, str(tmp_path))
    for push in _push_script(seed=3, pushes=10):
        jax_svc._push_row_grads(dict(push))
        port_svc._push_row_grads(dict(push))
    assert jax_svc.checkpoint_now() and port_svc.checkpoint_now()
    jax_files = _tree(tmp_path / "jax")
    port_files = _tree(tmp_path / "port")
    assert sorted(port_files) == sorted(jax_files)
    assert any(name.startswith("delta-") for name in port_files)
    for name in jax_files:
        assert port_files[name] == jax_files[name], name
    version = JaxSaver(str(tmp_path / "port")).get_valid_latest_version()
    assert version == CheckpointSaver(
        str(tmp_path / "jax")).get_valid_latest_version() == 7


def test_helpers_match_jax():
    for client in ("", "w0", "4f1c9e-0", "ünïcode-client"):
        assert rs._client_key(client) == jrs._client_key(client)
    table = EmbeddingTable("items", DIM)
    table.get([9, 2, 5])
    jtable = JaxTable("items", DIM)
    jtable.get([9, 2, 5])
    np.testing.assert_array_equal(rs._all_ids(table), jrs._all_ids(jtable))
    assert rs.SERVICE_NAME == jrs.SERVICE_NAME
    assert rs.SEQS_TABLE_NAME == jrs.SEQS_TABLE_NAME
    assert rs.PLACEMENT_SCHEME == jrs.PLACEMENT_SCHEME


@pytest.mark.parametrize("store", sorted(STORES))
def test_table_erase_contains_all_ids_match_jax(store):
    make_jax, make_port = STORES[store]
    jtables, _ = make_jax(JaxSGD(lr=0.5))
    ptables, _ = make_port(SGD(lr=0.5))
    jt, pt = jtables["items"], ptables["items"]
    ids = np.array([30, 4, 17, 8, 4096], np.int64)
    jt.get(ids)
    pt.get(ids)
    probe = np.array([4, 5, 17, 4096, 1], np.int64)
    np.testing.assert_array_equal(pt.contains(probe), jt.contains(probe))
    assert pt.erase([17, 5, 4096]) == jt.erase([17, 5, 4096]) == 2
    np.testing.assert_array_equal(pt.all_ids(), [4, 8, 30])
    np.testing.assert_array_equal(pt.to_arrays()[0], jt.to_arrays()[0])
    np.testing.assert_array_equal(pt.to_arrays()[1], jt.to_arrays()[1])
    # An erased row comes back as its lazy initial value.
    np.testing.assert_array_equal(pt.get([17]), jt.get([17]))


@pytest.mark.parametrize("request_fields,match", [
    ({"table": "nope", "ids": [1]}, "unknown table"),
    ({"table": "items", "ids": [1, 1],
      "grads": np.ones((2, DIM), np.float32)}, "unique"),
    ({"table": "items", "ids": [1, 2],
      "grads": np.ones((2, DIM + 1), np.float32)}, "grads shape"),
    ({"table": "items", "ids": [[1, 2]]}, "1-D"),
])
def test_malformed_pushes_are_invalid_requests(request_fields, match):
    from elasticdl_tpu_torch.comm.rpc import InvalidRequest

    svc = HostRowService({"items": EmbeddingTable("items", DIM)},
                         HostOptimizerWrapper(SGD(lr=0.5)))
    with pytest.raises(InvalidRequest, match=match):
        svc._push_row_grads(dict(request_fields))
    assert svc._push_count == 0
    assert svc._tables["items"].num_rows == 0


def _handler_pair(pkg):
    """A service of either package with a second one of the same package
    behind its in-process transport (a migration's target)."""
    mod, table, wrap, sgd = ((rs, EmbeddingTable, HostOptimizerWrapper, SGD)
                             if pkg == "port" else
                             (jrs, JaxTable, JaxWrap, JaxSGD))

    def make():
        return mod.HostRowService({"items": table("items", DIM)},
                                  wrap(sgd(lr=0.5)))

    svc, target = make(), make()
    svc.transport_factory = lambda addr: mod.DirectTransport(target)
    return mod, svc, target


def _grads(n):
    return np.arange(n * DIM, dtype=np.float32).reshape(n, DIM) / 64


# method: (calls made first, on (service, target), then the request).
_HANDLER_CASES = {
    "table_info": ((), {}),
    "table_versions": ((), {}),
    "pull_rows": ((), {"table": "items", "ids": np.array([3, 9])}),
    "push_row_grads": ((), {"table": "items", "ids": np.array([3, 9]),
                            "grads": _grads(2), "client": "c", "seq": 1}),
    "export_rows": ((), {"table": "items", "lo": 0, "hi": 6}),
    "get_shard_map": ((), {}),
    "set_shard_map": ((), {"map": {"version": 2, "shards": ["a", "b"],
                                   "ranges": [[0, 100, 1], [100, 8192, 0]],
                                   "replicas": {}},
                           "shard_id": 0}),
    "shard_stats": ((("svc", "pull_rows", {"table": "items",
                                           "ids": np.array([3, 3000])}),),
                    {"top_k": 4}),
    "migrate_out": ((("svc", "pull_rows", {"table": "items",
                                           "ids": np.array([3, 700, 9])}),
                     ("target", "begin_ingest", {"migration_id": "m",
                                                 "lo": 0, "hi": 600})),
                    {"migration_id": "m", "lo": 0, "hi": 600,
                     "target_addr": "b"}),
    "begin_ingest": ((), {"migration_id": "m", "lo": 0, "hi": 8}),
    "end_ingest": ((("svc", "begin_ingest", {"migration_id": "m",
                                             "lo": 0, "hi": 8}),),
                   {"migration_id": "m"}),
    "ingest_rows": ((("svc", "begin_ingest", {"migration_id": "m",
                                              "lo": 0, "hi": 8}),),
                    {"migration_id": "m", "table": "items",
                     "ids": np.array([1, 2]), "rows": _grads(2)}),
    "ingest_steps": ((("svc", "begin_ingest", {"migration_id": "m",
                                               "lo": 0, "hi": 8}),),
                     {"migration_id": "m", "steps": {"items": 5}}),
    "pull_replica_rows": ((("svc", "replica_refresh", {
        "table": "items", "ids": np.array([4]), "rows": _grads(1),
        "applied_at": 12.5, "read_at": 0.0, "map_version": 3}),),
        {"table": "items", "ids": np.array([4, 5])}),
    "replica_refresh": ((), {"table": "items", "ids": np.array([4, 6]),
                             "rows": _grads(2), "applied_at": 1.0,
                             "read_at": 0.0, "map_version": 1}),
}


def _plain(reply):
    """A reply with arrays as lists and wall-clock fields dropped."""
    if isinstance(reply, dict):
        return {k: _plain(v) for k, v in reply.items()
                if k not in ("seconds", "applied_at")}
    if isinstance(reply, np.ndarray):
        return [reply.dtype.str, reply.tolist()]
    return reply


@pytest.mark.parametrize("method", sorted(_HANDLER_CASES))
def test_every_handler_answers_as_jax(method):
    """The port's handler set is the JAX service's, and each handler
    answers the JAX handler's reply to the same requests (the timing
    fields aside) and leaves the same rows behind."""
    before, request = _HANDLER_CASES[method]
    replies, rows = {}, {}
    for pkg in ("port", "jax"):
        _mod, svc, target = _handler_pair(pkg)
        for who, name, req in before:
            (svc if who == "svc" else target).handlers()[name](dict(req))
        replies[pkg] = svc.handlers()[method](dict(request))
        rows[pkg] = [v.to_arrays() for svc_ in (svc, target)
                     for v in svc_.host_tables.values()]
        handlers = sorted(svc.handlers())
        replies[pkg + "_handlers"] = handlers
    assert replies["port_handlers"] == replies["jax_handlers"]
    assert len(replies["port_handlers"]) == 15
    assert _plain(replies["port"]) == _plain(replies["jax"])
    for (pi, pr), (ji, jr) in zip(rows["port"], rows["jax"]):
        assert pi.tobytes() == ji.tobytes()
        assert np.asarray(pr).tobytes() == np.asarray(jr).tobytes()


@pytest.mark.parametrize("flag", [
    ["--profile_hz", "20"], ["--profile_window_secs", "10"],
    ["--master_addr", "localhost:1"], ["--metrics_report_secs", "15"],
])
def test_main_refuses_unported_flags(flag):
    with pytest.raises(NotImplementedError, match="item 8f"):
        rs.main(["--model_zoo", model_zoo_dir(), "--model_def",
                 "deepfm.deepfm_host.custom_model"] + flag)


def _tier_policy(svc):
    return svc._tables[deepfm_host.TABLE_NAME].tier_group.policy


def _cold_dir(svc):
    return os.path.dirname(
        svc._tables[deepfm_host.TABLE_NAME].tier_group.cold_dir)


# (the flag under test and the flags it needs, what the service must
# hold afterwards); every case also passes --checkpoint_dir <root>/ckpt.
_STORAGE_FLAGS = {
    "push_log_dir": (
        ["--push_log_dir", "{root}/wal"],
        lambda svc, root: (svc._push_log.log_dir == f"{root}/wal"
                           and svc._push_log.ack == "durable"
                           and svc._push_log._group_secs == 0.002)),
    "push_log_group_ms": (
        ["--push_log_dir", "{root}/wal", "--push_log_group_ms", "7"],
        lambda svc, root: svc._push_log._group_secs == 0.007),
    "push_log_ack": (
        ["--push_log_dir", "{root}/wal", "--push_log_ack", "applied"],
        lambda svc, root: svc._push_log.ack == "applied"),
    "push_durable_wait_secs": (
        ["--push_durable_wait_secs", "30"],
        lambda svc, root: (svc._push_durable_wait_secs == 30.0
                           and svc._push_log is None)),
    "hot_budget_rows": (
        ["--hot_budget_rows", "64"],
        lambda svc, root: (_tier_policy(svc).hot_budget_rows == 64
                           and _cold_dir(svc) == f"{root}/ckpt_cold"
                           and _tier_policy(svc).segment_max_bytes
                           == 8 << 20)),
    "cold_dir": (
        ["--hot_budget_rows", "64", "--cold_dir", "{root}/cold"],
        lambda svc, root: _cold_dir(svc) == f"{root}/cold"),
    "cold_segment_mb": (
        ["--hot_budget_rows", "64", "--cold_segment_mb", "3"],
        lambda svc, root: _tier_policy(svc).segment_max_bytes == 3 << 20),
    "cold_compact_live_fraction": (
        ["--hot_budget_rows", "64", "--cold_compact_live_fraction",
         "0.25"],
        lambda svc, root: _tier_policy(svc).compact_live_fraction == 0.25),
}


@pytest.mark.parametrize("flag", sorted(_STORAGE_FLAGS))
def test_main_takes_storage_flags(tmp_path, monkeypatch, flag):
    """main's parser takes each of the storage flags, and the service
    gets its configuration in the JAX main's order: tiering before the
    checkpoint, the push log after it, the durable-wait ceiling last."""
    import signal

    root = str(tmp_path)
    extra, holds = _STORAGE_FLAGS[flag]
    calls, started = [], []

    def recording(name):
        real = getattr(HostRowService, name)

        def wrapper(self, *args, **kwargs):
            calls.append(name)
            return real(self, *args, **kwargs)

        return wrapper

    for name in ("configure_tiering", "configure_checkpoint",
                 "configure_push_log", "configure_push_durable_wait"):
        monkeypatch.setattr(HostRowService, name, recording(name))
    monkeypatch.setattr(HostRowService, "start",
                        lambda self, *a, **k: started.append(self) or self)
    monkeypatch.setattr(HostRowService, "wait", lambda self: None)
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    rs.main(["--model_zoo", model_zoo_dir(), "--model_def",
             "deepfm.deepfm_host.custom_model", "--checkpoint_dir",
             f"{root}/ckpt"] + [f.format(root=root) for f in extra])
    (svc,) = started
    try:
        want = ["configure_checkpoint", "configure_push_durable_wait"]
        if "--hot_budget_rows" in extra:
            want.insert(0, "configure_tiering")
        if "--push_log_dir" in extra:
            want.insert(-1, "configure_push_log")
        assert calls == want
        assert f"--{flag}" in extra
        assert holds(svc, root)
    finally:
        svc.stop()
