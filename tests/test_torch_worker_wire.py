"""The port's master and worker over localhost gRPC: the entry points
(``master.main.Master`` and ``worker.main.build_worker``) drain a job
with ``--device cpu``; a port worker drains a job served by the JAX
package's master (its TaskDispatcher + MasterServicer + RpcServer), and
a JAX worker one served by the port's master, each master counting
every record; and ``worker.main`` asks for the card unless the CPU is
asked for.
"""

import threading

import pytest
import torch

from elasticdl_tpu.comm.rpc import RpcServer as JaxRpcServer
from elasticdl_tpu.common.args import parse_worker_args as jax_worker_args
from elasticdl_tpu.master.evaluation_service import (
    EvaluationService as JaxEvaluationService,
)
from elasticdl_tpu.master.servicer import MasterServicer as JaxServicer
from elasticdl_tpu.master.task_dispatcher import (
    TaskDispatcher as JaxDispatcher,
)
from elasticdl_tpu.testing import data as jdata
from elasticdl_tpu.worker.main import build_worker as jax_build_worker
from elasticdl_tpu_torch.common.args import build_parser, parse_worker_args
from elasticdl_tpu_torch.common.constants import TaskType
from elasticdl_tpu_torch.master.main import Master
from elasticdl_tpu_torch.testing import data as tdata
from elasticdl_tpu_torch.worker.main import build_worker
from elasticdl_tpu_torch.worker.main import main as worker_main

MNIST = "mnist.mnist_functional.custom_model"


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = tmp_path_factory.mktemp("wire")
    return (tdata.create_mnist_record_file(str(root / "t.rec"), 96, seed=1),
            tdata.create_mnist_record_file(str(root / "e.rec"), 32, seed=2))


def _job_flags(zoo, train, evalf):
    return ["--model_zoo", zoo, "--model_def", MNIST,
            "--training_data", train, "--validation_data", evalf,
            "--minibatch_size", "16", "--num_epochs", "1"]


def _run_worker(worker):
    result = {}
    thread = threading.Thread(
        target=lambda: result.update(worker.run()), daemon=True)
    thread.start()
    thread.join(timeout=180)
    assert not thread.is_alive()
    return result


def test_port_master_and_worker_mains_over_grpc(records):
    train, evalf = records
    flags = _job_flags(tdata.model_zoo_dir(), train, evalf)
    master = Master(build_parser("master").parse_args(
        flags + ["--evaluation_steps", "3", "--master_addr", "localhost:0",
                 "--device", "cpu"]))
    master.prepare()
    assert master.port
    try:
        worker = build_worker(parse_worker_args(
            flags + ["--worker_id", "0", "--device", "cpu",
                     "--master_addr", f"localhost:{master.port}"]))
        result = _run_worker(worker)
        assert master.task_dispatcher.finished()
        assert result["trained_batches"] == 6
        assert master.task_dispatcher.counters.total_records[
            TaskType.TRAINING] == 96
        # Rounds at versions 3 and 6, computed on the master.
        assert sorted(master.evaluation_service.completed_results) == [3, 6]
        for metrics in master.evaluation_service.completed_results.values():
            assert 0.0 <= metrics["accuracy"] <= 1.0
    finally:
        master.stop()


def test_port_worker_drains_the_jax_master(records):
    train, evalf = records
    dispatcher = JaxDispatcher(
        training_shards={train: (0, 96)}, evaluation_shards={evalf: (0, 32)},
        records_per_task=32, shuffle=False)
    from elasticdl_tpu.data.decoders import argmax_accuracy_metrics

    eval_service = JaxEvaluationService(
        dispatcher, argmax_accuracy_metrics(), eval_steps=3)
    servicer = JaxServicer(dispatcher, eval_service)
    server = JaxRpcServer("localhost:0",
                          {"elasticdl_tpu.Master": servicer.handlers()})
    server.start()
    try:
        worker = build_worker(parse_worker_args(
            _job_flags(tdata.model_zoo_dir(), train, evalf)
            + ["--worker_id", "0", "--device", "cpu",
               "--master_addr", f"localhost:{server.port}"]))
        result = _run_worker(worker)
    finally:
        server.stop(0)
    assert dispatcher.finished()
    assert result["trained_batches"] == 6
    assert dispatcher.counters.total_records == {
        TaskType.TRAINING: 96, TaskType.EVALUATION: 64}
    assert sorted(eval_service.completed_results) == [3, 6]


def test_jax_worker_drains_the_port_master(records):
    train, evalf = records
    master = Master(build_parser("master").parse_args(
        _job_flags(tdata.model_zoo_dir(), train, evalf)
        + ["--evaluation_steps", "3", "--master_addr", "localhost:0"]))
    master.prepare()
    try:
        worker = jax_build_worker(jax_worker_args(
            _job_flags(jdata.model_zoo_dir(), train, evalf)
            + ["--worker_id", "0",
               "--master_addr", f"localhost:{master.port}"]))
        result = _run_worker(worker)
        assert master.task_dispatcher.finished()
        assert result["trained_batches"] == 6
        # The train-end callback task ran too.
        assert master.task_dispatcher.counters.total_records == {
            TaskType.TRAINING: 96, TaskType.EVALUATION: 64,
            TaskType.TRAIN_END_CALLBACK: 0}
        assert sorted(master.evaluation_service.completed_results) == [3, 6]
    finally:
        master.stop()


def test_worker_main_needs_cuda_unless_cpu_is_asked_for(records):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    train, evalf = records
    argv = _job_flags(tdata.model_zoo_dir(), train, evalf) + [
        "--worker_id", "0", "--master_addr", "localhost:1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker_main(argv)
    # --row_service_addr is the host tier's; a dense model builds with it.
    worker = build_worker(parse_worker_args(
        argv + ["--device", "cpu", "--row_service_addr", "x:1"]),
        master_client=object())
    assert worker._step_runner is None
    for flag in (["--stream_dir", "/s"], ["--image_name", "img"]):
        with pytest.raises(NotImplementedError, match="item 8"):
            Master(build_parser("master").parse_args(
                _job_flags(tdata.model_zoo_dir(), train, evalf) + flag))
