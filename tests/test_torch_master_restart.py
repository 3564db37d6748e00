"""The port's master restarted mid-job from its journal
(``testing/cluster.MiniCluster(journal_dir=...)`` and ``restart_master``,
``master/main.py``'s ``--journal_dir``) on the CPU.

A small recsys twin (1024 x 16 Adagrad table, kernels pinned, their
plain versions on the CPU) trains through the in-process cluster with
its master restarted twice mid-job: once while a training task is leased
(its late report lands on the recovered master) and once while an eval
round is open with a fold in. In process (the clients rebound) and over
gRPC (the server rebinds its port and the worker's channel finds it),
every training record is counted exactly once, the generation counts the
restarts, and the final tables, slots and MLP and the eval results are
bit-equal to an unkilled twin's. Then the master's ``--row_reshard``
under ``--journal_dir`` keeps its state in ``<journal_dir>/shard_map.json``
and journals each epoch as the JAX controller does, byte for byte.
"""

import json
import os
import textwrap

import pytest
import torch

from elasticdl_tpu_torch.common.constants import TaskType
from elasticdl_tpu_torch.master.journal import read_records
from elasticdl_tpu_torch.testing import data as tdata
from elasticdl_tpu_torch.testing.cluster import MiniCluster
from elasticdl_tpu_torch.tools.check_journal import check_journal

RECSYS_ZOO = '''
from elasticdl_tpu_torch.embedding.device_sparse import (
    DeviceSparseRunner, TableSpec)
from elasticdl_tpu_torch.embedding.optimizer import Adagrad
from elasticdl_tpu_torch.model_zoo.recsys import recsys_sparse as twin
from elasticdl_tpu_torch.model_zoo.recsys.recsys_sparse import (  # noqa
    dataset_fn, eval_metrics_fn, loss, optimizer)

SPECS = (TableSpec(twin.TABLE_NAME, vocab=1024, dim=16,
                   feature_key=twin.FEATURE_KEY),)


def custom_model(device=None):
    return twin.RecsysRanker(emb_dim=16).to(device)


def make_sparse_runner():
    return DeviceSparseRunner(SPECS, Adagrad(lr=0.05), use_pallas="always")
'''
RECORDS, BATCH, EVAL_RECORDS = 128, 16, 48


@pytest.fixture(scope="module")
def recsys(tmp_path_factory):
    root = tmp_path_factory.mktemp("restart")
    zoo = root / "zoo" / "small"
    zoo.mkdir(parents=True)
    (zoo / "rec.py").write_text(textwrap.dedent(RECSYS_ZOO))
    train = tdata.create_frappe_record_file(
        str(root / "train.rec"), RECORDS, seed=3, input_length=8,
        max_id=1024)
    evalf = tdata.create_frappe_record_file(
        str(root / "eval.rec"), EVAL_RECORDS, seed=4, input_length=8,
        max_id=1024)
    return str(root / "zoo"), train, evalf


def _cluster(recsys, **kwargs):
    zoo, train, evalf = recsys
    return MiniCluster(zoo, "small.rec.custom_model", training_data=train,
                       validation_data=evalf, minibatch_size=BATCH,
                       eval_steps=4, device="cpu", **kwargs)


def _state(worker):
    state = worker.state
    leaves = {f"dense.{k}": v.detach().clone()
              for k, v in state.model.state_dict().items()}
    for name, table in state.tables.items():
        leaves[f"table.{name}"] = table.clone()
        for slot, t in state.slot_tables[name].items():
            leaves[f"slot.{name}.{slot}"] = t.clone()
    return leaves


@pytest.fixture(scope="module")
def twin(recsys):
    cluster = _cluster(recsys)
    result = cluster.run()[0]
    return dict(result=result, state=_state(cluster.workers[0]),
                results=dict(cluster.eval_service.completed_results))


class Restarts:
    """Restarts the cluster's master from a worker-side hook: before the
    second training report (its task leased) and before the first eval
    task's report (the round open, the task's fold in)."""

    def __init__(self):
        self.cluster = None
        self.train_reports = 0
        self.stats = []
        self.eval_task = None

    def restart(self):
        self.stats.append(self.cluster.restart_master())

    def before_report(self, task_id):
        doing = self.cluster.dispatcher.export_state()["doing"]
        kind = {tid: t["type"] for tid, t, _w in doing}.get(task_id)
        assert kind is not None, f"task {task_id} is not leased"
        if kind == TaskType.TRAINING:
            self.train_reports += 1
            if self.train_reports == 2:
                self.restart()
        elif kind == TaskType.EVALUATION and self.eval_task is None:
            self.eval_task = task_id
            job = self.cluster.eval_service._eval_job
            assert job is not None and task_id in job._folded_tasks
            self.restart()


def _check_job(cluster, restarts, twin):
    dispatcher = cluster.dispatcher
    assert cluster.finished
    assert len(restarts.stats) == 2
    assert [s["generation"] for s in restarts.stats] == [1, 2]
    assert dispatcher.counters.total_records[TaskType.TRAINING] == RECORDS
    assert not dispatcher.counters.failed_records
    resolved = dispatcher.export_state()["resolved"]
    ids = [row[0] for row in resolved]
    assert len(ids) == len(set(ids))
    train_spans = sorted((t["start"], t["end"]) for _i, t, _w, _r in resolved
                         if t and t["type"] == TaskType.TRAINING)
    assert train_spans == [(s, s + 2 * BATCH)
                           for s in range(0, RECORDS, 2 * BATCH)]
    got = _state(cluster.workers[0])
    assert sorted(got) == sorted(twin["state"])
    for name, want in twin["state"].items():
        assert got[name].dtype == want.dtype, name
        assert torch.equal(got[name], want), name
    assert cluster.eval_service.completed_results == twin["results"]
    assert check_journal(cluster.journal_dir) == []
    cluster.stop()


def test_restart_master_in_process_is_bit_equal_to_twin(recsys, twin,
                                                         tmp_path):
    restarts = Restarts()

    def on_report(request):
        restarts.before_report(int(request["task_id"]))

    cluster = _cluster(recsys, journal_dir=str(tmp_path / "journal"),
                       worker_callbacks={"report_task_result": on_report})
    restarts.cluster = cluster
    extra_client = cluster.make_inprocess_client(7)
    result = cluster.run()[0]
    assert extra_client._servicer is cluster.servicer  # rebound too
    assert result["trained_batches"] == twin["result"]["trained_batches"]
    assert result["final_loss"] == twin["result"]["final_loss"]
    assert cluster.workers[0]._master.last_generation == 2
    _check_job(cluster, restarts, twin)


def test_restart_master_over_grpc_is_bit_equal_to_twin(recsys, twin,
                                                       tmp_path):
    restarts = Restarts()
    cluster = _cluster(recsys, journal_dir=str(tmp_path / "journal"),
                       use_rpc=True)
    restarts.cluster = cluster
    port = cluster._server.port
    client = cluster.workers[0]._master
    report = client.report_task_result

    def report_task_result(task_id, *args, **kwargs):
        restarts.before_report(int(task_id))
        return report(task_id, *args, **kwargs)

    # The worker-side hook stands in for the kill: the report goes out
    # after the master died and came back on the same port.
    client.report_task_result = report_task_result
    result = cluster.run()[0]
    assert result["trained_batches"] == twin["result"]["trained_batches"]
    assert result["final_loss"] == twin["result"]["final_loss"]
    assert client.last_generation == 2
    assert client.current_addr == f"localhost:{port}"
    _check_job(cluster, restarts, twin)


# ---- --row_reshard under --journal_dir ----------------------------------


class FakeShardTransport:
    def __init__(self):
        self.map = None

    def call(self, method, **fields):
        if method == "set_shard_map":
            self.map = fields["map"]
        return {}


def test_row_reshard_journals_its_epochs_as_jax_does(tmp_path):
    """``--row_reshard`` with ``--journal_dir`` and no state file: the
    authority's state lands in ``<journal_dir>/shard_map.json`` and its
    bootstrap epoch in a ``shard_map`` record, byte-equal to the record
    the JAX controller journals for the same fleet."""
    from elasticdl_tpu.master import journal as jj
    from elasticdl_tpu.master import row_reshard as jrr
    from elasticdl_tpu_torch.common.args import parse_master_args
    from elasticdl_tpu_torch.embedding.optimizer import (
        SGD,
        HostOptimizerWrapper,
    )
    from elasticdl_tpu_torch.embedding.row_service import HostRowService
    from elasticdl_tpu_torch.embedding.table import EmbeddingTable
    from elasticdl_tpu_torch.master.main import Master

    svcs = [HostRowService({"items": EmbeddingTable("items", 4)},
                           HostOptimizerWrapper(SGD(lr=0.5))).start()
            for _ in range(2)]
    addrs = [f"localhost:{s.port}" for s in svcs]
    rec = tdata.create_frappe_record_file(str(tmp_path / "t.rec"), 64,
                                          seed=0, input_length=10,
                                          max_id=5500)
    journal_dir = str(tmp_path / "journal")
    master = Master(parse_master_args([
        "--model_zoo", tdata.model_zoo_dir(), "--model_def",
        "deepfm.deepfm_host.custom_model", "--training_data", rec,
        "--minibatch_size", "16", "--master_addr", "localhost:0",
        "--row_service_addr", ",".join(addrs), "--row_reshard",
        "--journal_dir", journal_dir]))
    try:
        master.prepare()
        assert master.row_reshard.state_path == os.path.join(
            journal_dir, "shard_map.json")
        assert [s._shard_map.version for s in svcs] == [1, 1]
    finally:
        master.stop()
        for s in svcs:
            s.stop(0)
    port_maps = [r for _o, _e, r in read_records(
        os.path.join(journal_dir, "journal.log")) if r["t"] == "shard_map"]
    assert [r["version"] for r in port_maps] == [1]
    with open(os.path.join(journal_dir, "shard_map.json")) as fh:
        assert json.load(fh)["map"] == port_maps[0]["map"]

    jax_dir = str(tmp_path / "jax")
    journal = jj.MasterJournal(jax_dir)
    journal.open_generation()
    fakes = {a: FakeShardTransport() for a in addrs}
    ctrl = jrr.ShardMapController(
        os.path.join(jax_dir, "shard_map.json"), journal=journal,
        transport_factory=lambda a: fakes[a])
    ctrl.bootstrap(addrs)
    journal.close()
    jax_maps = [r for _o, _e, r in read_records(
        os.path.join(jax_dir, "journal.log")) if r["t"] == "shard_map"]
    from elasticdl_tpu_torch.common import tensor_utils

    assert ([tensor_utils.dumps(r) for r in port_maps]
            == [tensor_utils.dumps(r) for r in jax_maps])
    assert check_journal(journal_dir) == [] == check_journal(jax_dir)
