"""The row service across packages over localhost gRPC, on the CPU.

- a port worker trains deepfm_host against a JAX row service, and a JAX
  worker against a port one, to the same rows as each package alone
  (synchronous runners: every push lands before the next pull);
- a port service restores a JAX service's checkpoint directory, and the
  reverse (rows, slots, the seq table, the push count and the shard
  map);
- a port client holding a stale map follows a JAX service's REDIRECT;
- ``python -m elasticdl_tpu_torch.embedding.row_service`` serves
  deepfm_host, ``worker.main --row_service_addr ... --device cpu``
  drains a job against it, and after SIGTERM the service's newest
  checkpoint version is its push count, which a relaunch restores.
"""

import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from elasticdl_tpu.embedding import row_service as jrs
from elasticdl_tpu.embedding.host_engine import (
    HostStepRunner as JaxHostStepRunner,
)
from elasticdl_tpu.embedding.optimizer import Adagrad as JaxAdagrad
from elasticdl_tpu.embedding.optimizer import HostOptimizerWrapper as JaxWrap
from elasticdl_tpu.embedding.shard_map import ShardMap as JaxShardMap
from elasticdl_tpu.embedding.table import EmbeddingTable as JaxTable
from elasticdl_tpu.testing import cluster as jcluster
from elasticdl_tpu.testing import data as jdata
from elasticdl_tpu_torch.checkpoint import CheckpointSaver
from elasticdl_tpu_torch.common.args import build_parser
from elasticdl_tpu_torch.embedding import row_service as rs
from elasticdl_tpu_torch.embedding.host_engine import HostStepRunner
from elasticdl_tpu_torch.embedding.optimizer import (
    Adagrad,
    HostOptimizerWrapper,
)
from elasticdl_tpu_torch.embedding.table import EmbeddingTable
from elasticdl_tpu_torch.master.main import Master
from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host
from elasticdl_tpu_torch.testing import data as tdata
from elasticdl_tpu_torch.testing.cluster import MiniCluster
from elasticdl_tpu_torch.worker.main import main as worker_main
from model_zoo.deepfm import deepfm_host as jax_deepfm_host

DIM = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = "deepfm.deepfm_host.custom_model"
ID_KEYS = {deepfm_host.TABLE_NAME: deepfm_host.FEATURE_KEY}


@pytest.fixture(scope="module")
def frappe(tmp_path_factory):
    root = tmp_path_factory.mktemp("rows")
    return tdata.create_frappe_record_file(
        str(root / "t.rec"), 64, seed=4, max_id=deepfm_host.MAX_ID)


def _service_rows(svc):
    return svc.host_tables[deepfm_host.TABLE_NAME].to_arrays()


def _port_run(records, svc):
    """One port worker, synchronous remote runner, against ``svc``."""
    addr = f"localhost:{svc.port}"
    cluster = MiniCluster(
        tdata.model_zoo_dir(), HOST, training_data=records,
        minibatch_size=16, num_minibatches_per_task=2,
        step_runner_factory=lambda: HostStepRunner(
            rs.make_remote_engine(addr, id_keys=ID_KEYS),
            async_apply=False),
        device="cpu")
    result = cluster.run()[0]
    assert cluster.finished and result["trained_batches"] == 4
    return _service_rows(svc)


def _jax_run(records, svc):
    """One JAX worker, synchronous remote runner, against ``svc``."""
    addr = f"localhost:{svc.port}"
    cluster = jcluster.MiniCluster(
        jdata.model_zoo_dir(), HOST, training_data=records,
        minibatch_size=16, num_minibatches_per_task=2,
        step_runner_factory=lambda: JaxHostStepRunner(
            jrs.make_remote_engine(addr, id_keys=ID_KEYS),
            async_apply=False))
    cluster.run()
    assert cluster.finished
    return _service_rows(svc)


@pytest.mark.parametrize("worker", ["port", "jax"])
def test_worker_trains_against_the_other_packages_service(frappe, worker):
    run = _port_run if worker == "port" else _jax_run
    rows = {}
    for name, factory in (("port", deepfm_host.make_row_service),
                          ("jax", jax_deepfm_host.make_row_service)):
        svc = factory().start()
        try:
            rows[name] = run(frappe, svc)
        finally:
            svc.stop(0)
    assert rows["port"][0].size > 0
    np.testing.assert_array_equal(rows["port"][0], rows["jax"][0])
    np.testing.assert_array_equal(rows["port"][1], rows["jax"][1])
    lazy = EmbeddingTable(deepfm_host.TABLE_NAME, deepfm_host.EMBEDDING_DIM)
    assert not np.array_equal(rows["port"][1], lazy.get(rows["port"][0]))


def _pushes(svc):
    rng = np.random.RandomState(7)
    for seq in range(1, 5):
        # Buckets [4096, 8192): shard 1 of the map below owns them.
        ids = np.unique(rng.randint(4096, 8192, 5)).astype(np.int64)
        svc._push_row_grads({
            "table": "items", "ids": ids, "client": "w0", "seq": seq,
            "grads": rng.standard_normal((ids.size, DIM)).astype(
                np.float32)})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_service_restores_the_other_packages_checkpoint(tmp_path, writer):
    ckpt = str(tmp_path / "ck")
    jax_make = lambda: jrs.HostRowService(  # noqa: E731
        {"items": JaxTable("items", DIM)}, JaxWrap(JaxAdagrad(lr=0.1)))
    port_make = lambda: rs.HostRowService(  # noqa: E731
        {"items": EmbeddingTable("items", DIM)},
        HostOptimizerWrapper(Adagrad(lr=0.1)))
    first, second = ((jax_make, port_make) if writer == "jax"
                     else (port_make, jax_make))
    svc = first()
    two = JaxShardMap.bootstrap(["a:1", "b:2"])
    svc._set_shard_map({"map": two.to_json(), "shard_id": 1})
    svc.configure_checkpoint(ckpt, 3, async_write=False)
    _pushes(svc)
    assert svc.checkpoint_now()
    back = second()
    back.configure_checkpoint(ckpt, 3)
    assert back._push_count == svc._push_count == 4
    assert back._get_shard_map({}) == {"map": two.to_json(),
                                       "shard_id": 1}
    want = {n: v.to_arrays() for n, v in svc.host_tables.items()}
    got = {n: v.to_arrays() for n, v in back.host_tables.items()}
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name][0], want[name][0])
        np.testing.assert_array_equal(got[name][1], want[name][1])
    # The restored seq table drops a retried push.
    ids = want["items"][0][:1]
    resp = back._push_row_grads({"table": "items", "ids": ids,
                                 "grads": np.ones((1, DIM), np.float32),
                                 "client": "w0", "seq": 4})
    assert resp == {"duplicate": True}
    back.stop()
    svc.stop()


def test_port_client_follows_a_jax_redirect():
    a = jrs.HostRowService({"items": JaxTable("items", DIM)},
                           JaxWrap(JaxAdagrad(lr=0.1))).start()
    b = jrs.HostRowService({"items": JaxTable("items", DIM)},
                           JaxWrap(JaxAdagrad(lr=0.1))).start()
    try:
        addr_a, addr_b = f"localhost:{a.port}", f"localhost:{b.port}"
        engine = rs.make_remote_engine(addr_a, id_keys={"items": "ids"})
        table = engine.tables["items"]
        ids = np.array([3, 4200, 8100], np.int64)
        before = table.get(ids)
        split = JaxShardMap.bootstrap([addr_a]).add_shard(
            addr_b).move_range(4096, 8192, 1)
        b.install_shard_map(split, 1)
        a.install_shard_map(split, 0)
        grads = np.ones((3, DIM), np.float32)
        engine.optimizer.apply_gradients(table, ids, grads)
        assert engine.shard_map.version == split.version
        assert engine.shard_map.get().shards == [addr_a, addr_b]
        ref = rs.HostRowService({"items": EmbeddingTable("items", DIM)},
                                HostOptimizerWrapper(Adagrad(lr=0.1)))
        ref._push_row_grads({"table": "items", "ids": ids, "grads": grads})
        want = ref._pull_rows({"table": "items", "ids": ids})["rows"]
        np.testing.assert_array_equal(table.get(ids), want)
        assert not np.array_equal(want, before)
        np.testing.assert_array_equal(a._tables["items"].to_arrays()[0],
                                      [3])
        np.testing.assert_array_equal(b._tables["items"].to_arrays()[0],
                                      [4200, 8100])
    finally:
        a.stop(0)
        b.stop(0)


def test_jax_clients_export_from_a_port_service():
    """A JAX client's range export (``_RemoteTable.export_dense``) and its
    map-routed one read a port service as they read a JAX one."""
    from elasticdl_tpu.comm.rpc import RpcStub as JaxStub

    svc = rs.HostRowService({"items": EmbeddingTable("items", DIM)},
                            HostOptimizerWrapper(Adagrad(lr=0.1))).start()
    try:
        addr = f"localhost:{svc.port}"
        _pushes(svc)
        want = rs.make_remote_engine(addr, {"items": "ids"}).tables[
            "items"].export_dense(9000, chunk=4096)
        jax_range = jrs._RemoteTable(JaxStub(addr, "RowService"), "items",
                                     DIM).export_dense(9000, chunk=4096)
        jax_routed = jrs.make_remote_engine(addr, {"items": "ids"}).tables[
            "items"].export_dense(9000, chunk=4096)
        np.testing.assert_array_equal(jax_range, want)
        np.testing.assert_array_equal(jax_routed, want)
        lazy = EmbeddingTable("items", DIM).get(np.arange(9000))
        assert not np.array_equal(want, lazy)
    finally:
        svc.stop(0)


def _spawn_service(log_path, ckpt):
    """The service's main in a subprocess; (process, port, log file)."""
    log = open(log_path, "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.embedding.row_service",
         "--model_zoo", tdata.model_zoo_dir(), "--model_def", HOST,
         "--addr", "localhost:0", "--checkpoint_dir", ckpt,
         "--checkpoint_steps", "4", "--shard_id", "0", "--num_shards", "1"],
        stdout=log, stderr=subprocess.STDOUT,
        cwd=os.path.dirname(log_path), env=dict(os.environ, PYTHONPATH=REPO))
    deadline = time.time() + 60
    while time.time() < deadline:
        log.seek(0)
        found = re.search(r"Row service on port (\d+)", log.read())
        if found:
            return proc, int(found.group(1)), log
        assert proc.poll() is None, "the row service exited"
        time.sleep(0.1)
    proc.kill()
    raise AssertionError("the row service did not report its port")


def _record_ids(records):
    """Every feature id of a frappe record file."""
    from elasticdl_tpu_torch.common import tensor_utils
    from elasticdl_tpu_torch.data.record_file import RecordFileScanner

    with RecordFileScanner(records) as scanner:
        return np.concatenate([
            np.asarray(tensor_utils.loads(p)["feature_ids"], np.int64)
            for p in scanner])


def test_worker_main_drains_a_job_against_the_service_main(tmp_path,
                                                          frappe):
    ckpt = str(tmp_path / "svc_ckpt")
    proc, port, log = _spawn_service(str(tmp_path / "first.log"),
                                     ckpt)
    try:
        flags = ["--model_zoo", tdata.model_zoo_dir(), "--model_def", HOST,
                 "--training_data", frappe, "--minibatch_size", "16",
                 "--num_minibatches_per_task", "2", "--num_epochs", "2"]
        master = Master(build_parser("master").parse_args(
            flags + ["--master_addr", "localhost:0"]))
        master.prepare()
        # worker.main installs a SIGTERM handler; give the test process
        # its own back afterwards.
        sigterm = signal.getsignal(signal.SIGTERM)
        try:
            assert worker_main(
                flags + ["--worker_id", "0", "--device", "cpu",
                         "--master_addr", f"localhost:{master.port}",
                         "--row_service_addr", f"localhost:{port}",
                         "--num_workers", "2"]) == 0
            assert master.task_dispatcher.finished()
        finally:
            signal.signal(signal.SIGTERM, sigterm)
            master.stop()
        engine = rs.make_remote_engine(f"localhost:{port}", ID_KEYS)
        versions = engine.tables[deepfm_host.TABLE_NAME].pull_version()
        assert versions == 8  # two epochs of 4 pushes
        touched = np.unique(_record_ids(frappe))
        live = engine.tables[deepfm_host.TABLE_NAME].get(touched)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert CheckpointSaver(ckpt).get_valid_latest_version() == 8
        log.close()
        proc, port, log = _spawn_service(
            str(tmp_path / "relaunch.log"), ckpt)
        log.seek(0)
        assert "Row service restored version 8" in log.read()
        again = rs.make_remote_engine(f"localhost:{port}", ID_KEYS)
        np.testing.assert_array_equal(
            again.tables[deepfm_host.TABLE_NAME].get(touched), live)
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        log.close()
