"""Worker-side client for the Master service.

A copy of elasticdl_tpu/worker/master_client.py: the port keeps its own.

One interface, two transports: gRPC (`MasterClient`) for real jobs and
direct method calls (`testing.in_process_master.InProcessMaster`) for the
in-process test harness — the same trick the reference uses
(tests/in_process_master.py:5-33) so every distributed path is drivable
in one process.
"""

from typing import Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.common.task import Task
from elasticdl_tpu_torch.comm.rpc import RpcStub, wait_for_channel_ready
from elasticdl_tpu_torch.master.servicer import SERVICE_NAME


class MasterClient:
    def __init__(self, addr: str, worker_id: int,
                 connect_timeout: float = 300.0, retries: int = 3):
        # ``addr`` may be a comma-separated re-resolve list: the
        # primary master's advertised address plus its hot standbys
        # (docs/fault_tolerance.md "Hot standby & failover"). The
        # multi-target rotation lives in RpcStub (ONE implementation);
        # this constructor only blocks until some master is reachable
        # and hands the stub the list reordered to start there.
        # max_retries=0: every caller of this client already has its
        # own (longer) ride-out loop (task_data_service /
        # Worker._master_call) that reconnects AND rotates the address
        # list between attempts — in-stub retries would only hammer a
        # dead target before the rotation gets a chance (the
        # comm/rpc.py layering rule, and a measured chunk of failover
        # downtime).
        addrs = [a.strip() for a in addr.split(",") if a.strip()]
        if not addrs:
            raise ValueError(f"empty master address {addr!r}")
        reachable = self._wait_any_ready(addrs, connect_timeout,
                                         retries)
        self._stub = RpcStub(
            ",".join(addrs[reachable:] + addrs[:reachable]),
            SERVICE_NAME, max_retries=0,
        )
        self._worker_id = worker_id
        # Master incarnation fence (master/journal.py): responses stamp
        # the master's generation; requests echo the last one seen so a
        # recovered master can tell re-attaching survivors from fresh
        # workers, and so reports are resolvable against the
        # incarnation that dispatched their task. -1 = never attached.
        # Survives reconnect() — the fence outlives any one channel.
        self.last_generation = -1
        # Live-resize directive piggybacked on get_task responses
        # (master/servicer.py resize barrier): the worker applies it at
        # the next task boundary and acks via report_resize. Tracks the
        # LATEST offer; absent from a response = none pending for us.
        self.pending_resize = None
        # Job-scoped lease (master/scheduler.py): in multi-job mode the
        # lease carries the job id and the report must echo it, so it
        # routes to the dispatcher that issued it even after this
        # worker is rebound to another gang. "" = single-job plane.
        self.last_job = ""

    @staticmethod
    def _wait_any_ready(addrs, connect_timeout: float,
                        retries: int) -> int:
        """Block until SOME address answers (a worker may start while
        the primary is mid-failover); returns its index. The probe
        channel is discarded — the stub owns its own."""
        last_exc = None
        for _attempt in range(max(1, retries)):
            for idx, addr in enumerate(addrs):
                try:
                    channel = wait_for_channel_ready(
                        addr,
                        timeout=max(
                            1.0, connect_timeout / max(1, retries)
                            / len(addrs),
                        ),
                        retries=1,
                    )
                    channel.close()
                    return idx
                except Exception as exc:
                    last_exc = exc
        raise TimeoutError(
            f"no master reachable at {addrs}: {last_exc}"
        )

    def reconnect(self):
        """Drop the channel and build a fresh one (non-blocking: the
        next call fails fast if the master is still down), rotating to
        the next address of the re-resolve list (RpcStub.reconnect).
        Needed to re-attach to a RELAUNCHED or failed-over master: a
        gRPC channel whose reconnect attempts were refused for a few
        seconds can wedge its subchannel permanently, while a fresh
        channel to the restarted server connects immediately — the
        worker's outage ride-out loops call this between retries."""
        self._stub.reconnect()

    @property
    def current_addr(self) -> str:
        return self._stub.target

    def _note_generation(self, resp: dict):
        from elasticdl_tpu_torch.comm.rpc import RpcError

        if resp.get("stale_master"):
            # A fenced zombie answered: its state is no longer the
            # job's truth. Surface as a retryable failure so the
            # ride-out loops reconnect (rotating to the promoted
            # standby) instead of trusting the response.
            raise RpcError(
                f"master at {self.current_addr} is fenced "
                "(superseded by a hot-standby takeover)",
                code="UNAVAILABLE",
            )
        gen = resp.get("generation")
        if gen is not None:
            self.last_generation = max(self.last_generation, int(gen))

    def get_task(self, metrics: Optional[dict] = None,
                 ) -> Tuple[Optional[Task], bool]:
        fields = {
            "worker_id": self._worker_id,
            "generation": self.last_generation,
        }
        if metrics:
            fields["metrics"] = metrics
        resp = self._stub.call("get_task", **fields)
        self._note_generation(resp)
        self.pending_resize = resp.get("resize")
        task = Task.from_dict(resp["task"]) if resp.get("task") else None
        if task is not None:
            self.last_job = str(resp.get("job", "") or "")
        return task, bool(resp.get("finished"))

    def report_task_result(self, task_id: int, err_reason: str = "",
                           metrics: Optional[dict] = None,
                           job: Optional[str] = None) -> bool:
        fields = {
            "task_id": task_id,
            "err_reason": err_reason,
            "worker_id": self._worker_id,
            "generation": self.last_generation,
            "job": self.last_job if job is None else str(job),
        }
        if metrics:
            # Piggybacked registry snapshot (observability/): the master
            # merges it into the cluster view keyed by worker id.
            fields["metrics"] = metrics
        resp = self._stub.call("report_task_result", **fields)
        self._note_generation(resp)
        return bool(resp.get("accepted"))

    def report_evaluation_metrics(self, model_outputs, labels,
                                  task_id: int = -1) -> bool:
        resp = self._stub.call(
            "report_evaluation_metrics",
            model_outputs=np.asarray(model_outputs),
            labels=np.asarray(labels),
            task_id=int(task_id),
        )
        self._note_generation(resp)
        return bool(resp.get("accepted"))

    def report_version(self, model_version: int,
                       metrics: Optional[dict] = None) -> None:
        fields = {
            "model_version": int(model_version),
            "worker_id": self._worker_id,
        }
        if metrics:
            fields["metrics"] = metrics
        resp = self._stub.call("report_version", **fields)
        self._note_generation(resp)

    def report_resize(self, resize_id: int,
                      status: str = "applied") -> bool:
        """Ack a resize directive (the barrier's worker side)."""
        resp = self._stub.call(
            "report_resize",
            worker_id=self._worker_id,
            resize_id=int(resize_id),
            status=str(status),
            generation=self.last_generation,
        )
        self._note_generation(resp)
        self.pending_resize = None
        return bool(resp.get("accepted"))

    def close(self):
        self._stub.close()
