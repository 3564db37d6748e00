"""The port's master servicer and evaluation service against the JAX
package's: the same request scripts, through each package's handler
table and its ``InProcessMaster``, give identical response dicts (the
generation stamp and the ``stale_master`` fence included) and the same
evaluation results for the same reported outputs.
"""

import ml_dtypes
import numpy as np
import pytest

from elasticdl_tpu.comm.rpc import RpcError as JaxRpcError
from elasticdl_tpu.master.evaluation_service import (
    EvaluationService as JaxEvaluationService,
)
from elasticdl_tpu.master.servicer import MasterServicer as JaxServicer
from elasticdl_tpu.master.task_dispatcher import (
    TaskDispatcher as JaxDispatcher,
)
from elasticdl_tpu.testing.in_process_master import (
    InProcessMaster as JaxInProcessMaster,
)
from elasticdl_tpu_torch.comm.rpc import RpcError
from elasticdl_tpu_torch.common import dtypes
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.testing.in_process_master import InProcessMaster

PACKAGES = {
    "port": (TaskDispatcher, EvaluationService, MasterServicer,
             InProcessMaster, RpcError),
    "jax": (JaxDispatcher, JaxEvaluationService, JaxServicer,
            JaxInProcessMaster, JaxRpcError),
}


def _metrics_fns():
    return {
        "accuracy": lambda labels, outputs: float(
            np.mean((np.asarray(outputs, np.float32) > 0) == labels)),
        "mean_output": lambda labels, outputs: float(
            np.mean(np.asarray(outputs, np.float32))),
    }


class _Journal:
    """The servicer's view of the master's journal: the fence and the
    version records."""

    def __init__(self):
        self.fenced = False
        self.generation = 3
        self.records = []

    def is_fenced(self):
        return self.fenced

    def fence_generation(self):
        return self.generation + 1

    def append(self, kind, **fields):
        self.records.append((kind, fields))


def _master(package, eval_steps=2, journal=None):
    disp_cls, eval_cls, serv_cls, _, _ = PACKAGES[package]
    dispatcher = disp_cls(
        training_shards={"t.rec": (0, 64)},
        evaluation_shards={"e.rec": (0, 24)},
        records_per_task=16, shuffle=False,
    )
    dispatcher.add_deferred_callback(
        dispatcher.create_train_end_callback_task)
    eval_service = eval_cls(dispatcher, _metrics_fns(), eval_steps=eval_steps)
    servicer = serv_cls(dispatcher, eval_service, journal=journal,
                        generation=3 if journal is not None else 0)
    return dispatcher, eval_service, servicer


def _outputs(task_id, bf16, n):
    rng = np.random.default_rng(task_id)
    values = rng.standard_normal(n).astype(np.float32)
    labels = (rng.random(n) > 0.5).astype(np.int32)
    return values, labels


def _as_sent(values, bf16, package):
    """The outputs as each package's worker sends them: bf16 as the
    port's bits or as an ml_dtypes array."""
    if not bf16:
        return values
    b = values.astype(ml_dtypes.bfloat16)
    return b.view(np.uint16).view(dtypes.BFLOAT16_BITS) \
        if package == "port" else b


def _script(package, bf16):
    """Handler-table requests of a whole job: pulls, a failure, version
    reports triggering eval rounds, eval reports (one duplicated),
    telemetry, and the train-end task."""
    _, eval_service, servicer = _master(package)
    handlers = servicer.handlers()
    out = []

    def call(name, request):
        resp = handlers[name](dict(request))
        out.append((name, resp))
        return resp

    call("ping", {})
    first = call("get_task", {"worker_id": 0, "generation": -1})["task"]
    call("report_task_result", {"task_id": first["task_id"],
                                "err_reason": "ValueError: boom",
                                "worker_id": 0})
    version = 0
    for _ in range(12):
        task = call("get_task", {"worker_id": 0, "generation": 0})["task"]
        if task is None or task["type"] == "wait":
            break
        if task["type"] == "training":
            version += 1
            call("report_version", {"model_version": version,
                                    "worker_id": 0})
        elif task["type"] == "evaluation":
            n = task["end"] - task["start"]
            values, labels = _outputs(task["task_id"], bf16, n)
            request = {"model_outputs": _as_sent(values, bf16, package),
                       "labels": labels, "task_id": task["task_id"]}
            call("report_evaluation_metrics", request)
            call("report_evaluation_metrics", request)  # a re-send
        call("report_task_result", {"task_id": task["task_id"],
                                    "err_reason": "", "worker_id": 0})
        call("report_task_result", {"task_id": task["task_id"],
                                    "err_reason": "", "worker_id": 0})
    call("report_task_result", {"task_id": 999, "worker_id": 0})
    call("report_metrics", {"component": "router", "component_id": 1,
                            "metrics": {"families": []}})
    call("report_metrics", {"component": "a/b"})
    call("report_resize", {"worker_id": 0, "resize_id": 1})
    call("submit_job", {"job": "other"})
    call("sched_status", {})
    return out, eval_service.completed_results


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_servicer_responses_and_eval_results_match(bf16):
    got, got_results = _script("port", bf16)
    want, want_results = _script("jax", bf16)
    assert got == want
    # Eval rounds at versions 2 and 4, each folded once per task.
    assert sorted(got_results) == [2, 4]
    for version in got_results:
        assert got_results[version] == pytest.approx(
            want_results[version], rel=0, abs=0)


def _fence_script(package):
    """Through each package's InProcessMaster: the generation stamp is
    tracked and echoed, and a fenced master's answers surface as a
    retryable error without touching the dispatcher."""
    _, _, _, client_cls, error_cls = PACKAGES[package]
    journal = _Journal()
    dispatcher, _, servicer = _master(package, journal=journal)
    seen = []
    client = client_cls(servicer, worker_id=4,
                        callbacks={"get_task": seen.append})
    task, finished = client.get_task()
    out = [(task.to_dict(), finished, client.last_generation)]
    out.append(client.report_version(1))
    out.append(client.report_task_result(task.task_id))
    out.append(servicer.get_task({"worker_id": 5, "generation": 1}))
    journal.fenced = True
    for call in (lambda: client.get_task(),
                 lambda: client.report_task_result(123),
                 lambda: client.report_version(2)):
        with pytest.raises(error_cls) as info:
            call()
        out.append(info.value.code)
    out.append(servicer.handlers()["report_task_result"](
        {"task_id": 2, "worker_id": 4}))
    out.append((dispatcher.queue_depths(), journal.records,
                [sorted(r) for r in seen]))
    return out


def test_generation_fence_matches():
    got = _fence_script("port")
    assert got == _fence_script("jax")
    assert got[-2]["stale_master"] and got[-2]["generation"] == 3
    assert got[4:7] == ["UNAVAILABLE"] * 3
