"""In-process master: servicer methods called directly, no network.

A copy of elasticdl_tpu/testing/in_process_master.py: the port keeps its own.

Counterpart of the reference's ``tests/in_process_master.py:5-33`` — the
worker's master client becomes direct calls into ``MasterServicer``, with
optional test callbacks interposed per RPC.

Transport parity with ``comm/rpc.RpcStub``: retryable ``RpcError``s
(UNAVAILABLE / DEADLINE_EXCEEDED — here only ever raised by chaos
callbacks) get the same bounded re-send the stub gives real transport
blips, minus the backoff sleeps (determinism); and the master's
``generation`` stamp is tracked/echoed exactly like ``MasterClient``
does, so the chaos master-restart drill exercises the same re-attach
protocol on both transports. ``rebind`` is the restart seam: the chaos
runner swaps in a recovered servicer mid-job, standing in for the
worker's channel reconnecting to the relaunched master pod.
"""

from typing import Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.common.task import Task

_MAX_RETRIES = 2  # mirrors RpcStub.call's default attempt cap


class InProcessMaster:
    def __init__(self, servicer, worker_id: int = 0, callbacks=None):
        """``callbacks``: dict rpc_name -> fn(request_dict) invoked before
        the real handler (used by tests to inject faults/asserts)."""
        self._servicer = servicer
        self._worker_id = worker_id
        self._callbacks = callbacks or {}
        self.last_generation = -1
        # Resize-directive passthrough, same contract as MasterClient.
        self.pending_resize = None
        # Job-scoped lease echo, same contract as MasterClient.
        self.last_job = ""

    def rebind(self, servicer):
        """Point at a recovered master (chaos master-kill restart seam
        — the in-process analogue of the gRPC channel reconnecting to
        the relaunched master on the same address)."""
        self._servicer = servicer

    def _call(self, name: str, request: dict) -> dict:
        from elasticdl_tpu_torch.comm.rpc import RETRYABLE_CODES, RpcError

        attempt = 0
        while True:
            try:
                if name in self._callbacks:
                    self._callbacks[name](request)
                resp = self._servicer.handlers()[name](request)
                break
            except RpcError as exc:
                if exc.code not in RETRYABLE_CODES or (
                    attempt >= _MAX_RETRIES
                ):
                    raise
                attempt += 1
        if isinstance(resp, dict) and resp.get("stale_master"):
            # Transport parity with MasterClient: a fenced zombie's
            # answer is surfaced as a retryable failure, never
            # trusted (the caller's ride-out/rebind takes over).
            raise RpcError(
                "master is fenced (superseded by a hot-standby "
                "takeover)", code="UNAVAILABLE",
            )
        gen = resp.get("generation") if isinstance(resp, dict) else None
        if gen is not None:
            self.last_generation = max(self.last_generation, int(gen))
        return resp

    def get_task(self, metrics=None) -> Tuple[Optional[Task], bool]:
        request = {
            "worker_id": self._worker_id,
            "generation": self.last_generation,
        }
        if metrics:
            request["metrics"] = metrics
        resp = self._call("get_task", request)
        self.pending_resize = resp.get("resize")
        task = Task.from_dict(resp["task"]) if resp.get("task") else None
        if task is not None:
            self.last_job = str(resp.get("job", "") or "")
        return task, bool(resp.get("finished"))

    def report_task_result(self, task_id: int, err_reason: str = "",
                           metrics=None, job=None) -> bool:
        request = {
            "task_id": task_id,
            "err_reason": err_reason,
            "worker_id": self._worker_id,
            "generation": self.last_generation,
            "job": self.last_job if job is None else str(job),
        }
        if metrics:
            request["metrics"] = metrics
        resp = self._call("report_task_result", request)
        return bool(resp.get("accepted"))

    def report_evaluation_metrics(self, model_outputs, labels,
                                  task_id: int = -1) -> bool:
        resp = self._call(
            "report_evaluation_metrics",
            {
                "model_outputs": np.asarray(model_outputs),
                "labels": np.asarray(labels),
                "task_id": int(task_id),
            },
        )
        return bool(resp.get("accepted"))

    def report_version(self, model_version: int, metrics=None) -> None:
        request = {
            "model_version": int(model_version),
            "worker_id": self._worker_id,
        }
        if metrics:
            request["metrics"] = metrics
        self._call("report_version", request)

    def report_resize(self, resize_id: int,
                      status: str = "applied") -> bool:
        resp = self._call(
            "report_resize",
            {
                "worker_id": self._worker_id,
                "resize_id": int(resize_id),
                "status": str(status),
                "generation": self.last_generation,
            },
        )
        self.pending_resize = None
        return bool(resp.get("accepted"))

    def close(self):
        pass
