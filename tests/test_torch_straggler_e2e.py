"""The straggler path end to end on the port (``tests/test_straggler_e2e.py``
on ``elasticdl_tpu_torch``'s ``Master`` and ``Worker``), on the CPU.

``Master.run`` whole — ``find_timeout_tasks`` → the instance manager's
``kill_worker`` → the watch event's recovery → the task re-queued — with
the port's dispatcher and servicer, a fake k8s client that echoes the
DELETED event back (the watch stream's role), and two port ``Worker``
threads: worker 0 hangs at its first report, worker 1 finishes the job.
Worker 0's pod is deleted, a replacement pod comes up under the fresh id
2, and every record is trained once.
"""

import threading

from elasticdl_tpu_torch.common.args import build_parser
from elasticdl_tpu_torch.core.model_spec import get_model_spec
from elasticdl_tpu_torch.data.factory import create_data_reader
from elasticdl_tpu_torch.master.main import Master
from elasticdl_tpu_torch.testing.data import (
    create_mnist_record_file,
    model_zoo_dir,
)
from elasticdl_tpu_torch.testing.in_process_master import InProcessMaster
from elasticdl_tpu_torch.worker.worker import Worker

MODEL_DEF = "mnist.mnist_functional.custom_model"


class EventEchoK8sClient:
    """Records the pod lifecycle; a delete feeds the DELETED watch event
    back to the instance manager, as a real watch stream would."""

    def __init__(self):
        self.created = []
        self.deleted = []
        self.manager = None  # wired after Master.prepare()

    def create_pod(self, manifest):
        self.created.append(manifest)

    def create_service(self, manifest):
        self.created.append(manifest)

    def get_pod(self, name):
        return None

    def delete_pod(self, name, **kw):
        self.deleted.append(name)
        manifest = next(
            (m for m in self.created
             if m.get("metadata", {}).get("name") == name), None,
        )
        if self.manager is not None and manifest is not None:
            event = {
                "type": "DELETED",
                "object": {
                    "metadata": {
                        "name": name,
                        "labels": manifest["metadata"]["labels"],
                    },
                    "status": {"phase": "Failed", "exit_code": 137},
                },
            }
            threading.Thread(
                target=self.manager._event_cb, args=(event,),
                daemon=True,
            ).start()
        return True

    def watch_job_pods(self, *a, **kw):
        pass


def worker_pods(fake):
    return [m["metadata"]["name"] for m in fake.created
            if m["metadata"]["labels"].get(
                "elasticdl-tpu-replica-type") == "worker"]


def test_port_straggler_is_killed_relaunched_and_drained(tmp_path):
    train = create_mnist_record_file(str(tmp_path / "t.rec"), 96, seed=7)
    fake = EventEchoK8sClient()
    args = build_parser("master").parse_args([
        "--model_zoo", model_zoo_dir(),
        "--model_def", MODEL_DEF,
        "--training_data", train,
        "--minibatch_size", "16",
        "--num_minibatches_per_task", "1",
        "--num_workers", "2",
        "--num_epochs", "1",
        "--task_timeout_secs", "10.0",
        "--image_name", "img:test",
        "--job_name", "straggler-e2e",
        "--master_addr", "localhost:0",
    ])
    master = Master(args, k8s_client=fake)
    master.prepare()
    fake.manager = master.instance_manager
    assert worker_pods(fake) == ["elasticdl-tpu-straggler-e2e-worker-0",
                                 "elasticdl-tpu-straggler-e2e-worker-1"]

    release = threading.Event()

    def hang_on_first_report(request):
        # Worker 0 trained its first task but never reports: the task
        # sits in `doing`, a stuck-but-alive pod.
        release.wait(timeout=60)

    def make_worker(wid, callbacks=None):
        # Each worker trains its own model (a spec of its own).
        spec = get_model_spec(model_zoo_dir(), MODEL_DEF, device="cpu")
        return Worker(
            worker_id=wid,
            master_client=InProcessMaster(
                master.servicer, worker_id=wid, callbacks=callbacks,
            ),
            model_spec=spec,
            data_reader=create_data_reader(data_origin=train),
            minibatch_size=16,
            master_reattach_grace=2.0,
        )

    workers = [make_worker(0, {"report_task_result": hang_on_first_report}),
               make_worker(1)]
    threads = [threading.Thread(target=w.run, daemon=True)
               for w in workers]
    done = {}
    try:
        for t in threads:
            t.start()

        def run_master():
            done["rc"] = master.run(poll_secs=0.25)

        mt = threading.Thread(target=run_master, daemon=True)
        mt.start()
        mt.join(timeout=120)
        assert not mt.is_alive(), "master.run did not drain the job"
        assert done["rc"] == 0
        assert master.task_dispatcher.finished()
        # The hung worker's pod was killed by the timeout path...
        assert "elasticdl-tpu-straggler-e2e-worker-0" in fake.deleted
        # ...a replacement came up under a FRESH id (2, not 0)...
        assert "elasticdl-tpu-straggler-e2e-worker-2" in worker_pods(fake)
        # ...and every record was trained once: the peer retrained the
        # re-queued task.
        counters = master.task_dispatcher.counters
        assert counters.total_records.get("training") == 96
        # The straggler counter saw it.
        assert master.servicer._m_straggler.labels().value >= 1
    finally:
        release.set()
        master.stop()
        for t in threads:
            t.join(timeout=30)
