"""Autoscale chaos drill (port of elasticdl_tpu/chaos/autoscale_drill.py):
grow + shrink + a worker kill mid-barrier.

``python -m elasticdl_tpu_torch.chaos.autoscale_drill [--workdir DIR]
[--report PATH] [--device cpu]`` (exit 0 only if every invariant holds;
the report defaults to ``<workdir>/AUTOSCALE_DRILL.json``). The dp4 and
dp2 meshes are the port's meshes of 4 and 2 entries on one device
(``make_mesh(shape, ("dp",), [device] * n)``, CUDA unless cpu is
given): the same mesh schedule, reshards and step programs as on 4 and
2 devices.

The adversarial proof behind the closed-loop autoscaler
(master/autoscaler.py + the live-reshard barrier in
master/servicer.py / parallel/reshard.py): a job that scales DOWN
mid-training (dp4 → dp2, checkpointless live reshard), scales back UP
(dp2 → dp4), and loses its worker to a hard kill while the grow
barrier is pending — adjudicated against a **checkpoint-restart
control twin** that walks the IDENTICAL mesh schedule (same shrink
point, same trained-but-unreported kill, same restore version) through
the old save → teardown → restore path:

- **loss-trajectory equivalence vs the control**: final version,
  final loss, and every dense leaf (params, optimizer state,
  batch_stats) match. Both runs execute the same step programs on the
  same meshes in the same order, so this is a near-bit comparison —
  live reshard must leave exactly the trace checkpoint-restart leaves,
  minus the disk. (A never-resized twin is NOT the control: the
  live reshard is held to the mechanism it replaces, on the same mesh
  schedule.)
- **exactly-once accounting**: every record counted complete exactly
  once — the killed worker's in-flight task re-queues once, the
  resharded state neither loses nor repeats a step;
- **barrier liveness**: both resize barriers complete; the one the
  kill interrupted completes through the replacement worker (which
  sees the still-pending directive on its FIRST get_task, applies it
  pre-init, and acks under its own id while the drill's tick drops the
  dead worker from the membership — exactly what the master run-loop
  tick does in production).

The kill lands where it hurts: AFTER the grow directive is issued,
BEFORE the worker can see or ack it, with a trained-but-unreported
task in `doing` and the newest checkpoint deliberately one task
boundary behind (checkpoint cadence = 2 tasks), so recovery must
combine checkpoint restore + task re-queue + barrier re-offer.

Deterministic by construction (single worker, sync checkpoint writes,
in-process master, fixed kill/resize report counts); wall-clock
timings are excluded from the default report. Fast lane:
tests/test_torch_chaos_obs_drills.py.
"""

import json
import os
from typing import List

import numpy as np

from elasticdl_tpu_torch.chaos.interceptors import ChaosKill
from elasticdl_tpu_torch.common.constants import TaskType
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("autoscale_drill")

REPORT_VERSION = 1
DEFAULT_REPORT = "AUTOSCALE_DRILL.json"
MODEL_DEF = "mnist.mnist_functional.custom_model"

# The JAX drill's tolerance (dp4 and dp2 reduce gradients in different
# orders there; the port's ZeRO split makes dp4 bit-equal to dp2).
RTOL = 1e-4
ATOL = 1e-5


class DrillError(RuntimeError):
    pass


def _final_summary(worker) -> dict:
    from elasticdl_tpu_torch.checkpoint.state_io import (
        named_leaves_from_state,
    )

    leaves = {}
    if worker.state is not None:
        leaves = named_leaves_from_state(worker.state)
    return {
        "final_version": (
            int(worker.state.step) if worker.state is not None else 0
        ),
        "final_loss": (
            float(worker.last_metrics["loss"])
            if worker.last_metrics is not None else None
        ),
        "leaves": leaves,
    }


def _equivalence_verdict(control: dict, run: dict) -> dict:
    problems: List[str] = []
    if run["final_version"] != control["final_version"]:
        problems.append(
            f"final version {run['final_version']} != control "
            f"{control['final_version']} (training lost or repeated)"
        )
    t_loss, r_loss = control.get("final_loss"), run.get("final_loss")
    if (t_loss is None) != (r_loss is None):
        problems.append(
            f"final loss presence differs (control={t_loss}, "
            f"run={r_loss})"
        )
    elif t_loss is not None and not np.isclose(
        r_loss, t_loss, rtol=RTOL, atol=ATOL
    ):
        problems.append(f"final loss {r_loss!r} != control {t_loss!r}")
    t_leaves = control.get("leaves", {})
    r_leaves = run.get("leaves", {})
    if set(t_leaves) != set(r_leaves):
        problems.append("dense leaf sets differ")
    else:
        for name, arr in t_leaves.items():
            if not np.allclose(
                np.asarray(r_leaves[name], np.float64),
                np.asarray(arr, np.float64),
                rtol=RTOL, atol=ATOL,
            ):
                problems.append(f"dense leaves diverged at {name!r}")
                break
    return {
        "name": "loss_trajectory_equivalence",
        "passed": not problems,
        "details": (
            "; ".join(problems) if problems else
            f"version {run['final_version']} and {len(r_leaves)} dense "
            "leaves match the checkpoint-restart control"
        ),
    }


def run_drill(
    workdir: str,
    records: int = 256,
    minibatch_size: int = 8,
    num_minibatches_per_task: int = 2,
    shrink_at_report: int = 2,
    grow_kill_at_report: int = 5,
    join_timeout: float = 300.0,
    device=None,
) -> dict:
    """Twin run, then the autoscaled run with a kill mid-barrier."""
    import torch

    from elasticdl_tpu_torch.common.device import resolve_device
    from elasticdl_tpu_torch.chaos.invariants import ExactlyOnceTaskAccounting
    from elasticdl_tpu_torch.checkpoint import CheckpointHook
    from elasticdl_tpu_torch.core.model_spec import get_model_spec
    from elasticdl_tpu_torch.parallel import reshard
    from elasticdl_tpu_torch.parallel.mesh import make_mesh
    from elasticdl_tpu_torch.parallel.mesh_runner import make_runner_for_spec
    from elasticdl_tpu_torch.testing.cluster import MiniCluster
    from elasticdl_tpu_torch.testing.data import (
        create_mnist_record_file,
        model_zoo_dir,
    )
    from elasticdl_tpu_torch.worker.worker import Worker

    device = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    train = create_mnist_record_file(
        os.path.join(workdir, "train.rec"), records, seed=11
    )
    mesh4 = lambda: make_mesh((4,), ("dp",), [device] * 4)  # noqa: E731
    mesh2 = lambda: make_mesh((2,), ("dp",), [device] * 2)  # noqa: E731
    # Checkpoint every SECOND task on purpose: the kill must land with
    # the newest checkpoint strictly behind the killed worker's state,
    # so recovery genuinely re-trains the re-queued task instead of
    # resuming past it.
    checkpoint_steps = 2 * num_minibatches_per_task

    def build_cluster(subdir: str, callbacks=None,
                      with_checkpoint: bool = False) -> MiniCluster:
        return MiniCluster(
            model_zoo=model_zoo_dir(),
            model_def=MODEL_DEF,
            training_data=train,
            minibatch_size=minibatch_size,
            num_minibatches_per_task=num_minibatches_per_task,
            mesh=mesh4(),
            worker_callbacks=callbacks,
            checkpoint_dir=(
                os.path.join(workdir, subdir, "ckpt")
                if with_checkpoint else ""
            ),
            checkpoint_steps=checkpoint_steps if with_checkpoint else 0,
            checkpoint_async=False,
            device=device,
        )

    def mesh_spec(mesh):
        """A spec whose model is built for ``mesh`` from the cluster's
        seed (the checkpoint restore then fills it)."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            spec = get_model_spec(model_zoo_dir(), MODEL_DEF,
                                  device=device)
            spec.model = spec.make_model(mesh)
        return spec

    # ---- control: checkpoint-restart over the SAME mesh schedule -------
    # The proven old path: shrink = kill at a task boundary + fresh
    # dp2 worker restoring the v(2·mb/task) checkpoint; grow = the same
    # trained-but-unreported kill at report #grow_kill, fresh dp4
    # worker restoring the stale checkpoint and re-training the
    # re-queued task. Step programs, meshes, and data order match the
    # live run exactly — only the transition mechanism differs.
    logger.info("autoscale drill: checkpoint-restart control run")

    def make_phase_worker(cluster, worker_id, mesh, ckpt_dir,
                          callbacks=None):
        spec = mesh_spec(mesh)
        return Worker(
            worker_id=worker_id,
            master_client=cluster.make_inprocess_client(
                worker_id, callbacks=callbacks
            ),
            model_spec=spec,
            data_reader=cluster.train_reader,
            minibatch_size=minibatch_size,
            step_runner=make_runner_for_spec(spec, mesh),
            checkpoint_hook=CheckpointHook(
                checkpoint_dir=ckpt_dir,
                checkpoint_steps=checkpoint_steps,
                async_save=False,
            ),
            checkpoint_dir_for_init=ckpt_dir,
            metrics_report_secs=0.0,
        )

    ctrl_counts = {"reports": 0}

    def ctrl_on_report(request):
        ctrl_counts["reports"] += 1
        if ctrl_counts["reports"] == grow_kill_at_report:
            # Same trained-but-unreported shape as the live run's kill.
            raise ChaosKill(1, event_index=ctrl_counts["reports"])

    def ctrl_on_get_task(request):
        # Shrink point: a clean task-boundary kill (nothing leased) —
        # the counterpart of the live run applying the shrink directive
        # between tasks without losing state.
        if ctrl_counts["reports"] >= shrink_at_report:
            raise ChaosKill(0, event_index=ctrl_counts["reports"])

    ctrl_cluster = build_cluster(
        "control",
        callbacks={"report_task_result": ctrl_on_report,
                   "get_task": ctrl_on_get_task},
        with_checkpoint=True,
    )
    ctrl_ckpt = os.path.join(workdir, "control", "ckpt")
    ctrl_cluster.own_models()
    try:
        ctrl_cluster.workers[0].run()
        raise DrillError("control worker A was never killed")
    except ChaosKill:
        pass
    ctrl_cluster.dispatcher.recover_tasks(0)
    worker_b = make_phase_worker(
        ctrl_cluster, 1, mesh2(), ctrl_ckpt,
        callbacks={"report_task_result": ctrl_on_report},
    )
    try:
        worker_b.run()
        raise DrillError("control worker B was never killed")
    except ChaosKill:
        pass
    ctrl_cluster.dispatcher.recover_tasks(1)
    worker_c = make_phase_worker(ctrl_cluster, 2, mesh4(), ctrl_ckpt)
    worker_c.run()
    if not ctrl_cluster.finished:
        raise DrillError("control run did not drain")
    control = _final_summary(worker_c)
    ctrl_cluster.stop()

    # ---- autoscaled run ------------------------------------------------
    logger.info("autoscale drill: autoscaled run (shrink @%d, "
                "grow+kill @%d)", shrink_at_report, grow_kill_at_report)
    state = {"reports": 0, "killed": False, "worker_id": 0}
    box = {}
    resize_log: List[dict] = []

    def on_report(request):
        state["reports"] += 1
        cluster = box["cluster"]
        n = state["reports"]
        if n == shrink_at_report:
            rid = cluster.servicer.begin_resize(
                reshard.mesh_spec(mesh2()), direction="shrink"
            )
            resize_log.append({"resize_id": rid, "direction": "shrink",
                               "at_report": n})
        elif n == grow_kill_at_report and not state["killed"]:
            rid = cluster.servicer.begin_resize(
                reshard.mesh_spec(mesh4()), direction="grow"
            )
            resize_log.append({"resize_id": rid, "direction": "grow",
                               "at_report": n, "kill": True})
            state["killed"] = True
            # The callback runs BEFORE the servicer records the
            # report: this task dies trained-but-unreported, in
            # `doing` — and the grow directive dies unseen with us.
            raise ChaosKill(state["worker_id"], event_index=n)
        # The production master run-loop tick: refresh barrier
        # membership from the live fleet so a dead worker can't wedge
        # the barrier.
        cluster.servicer.maybe_complete_resize([state["worker_id"]])

    cluster = build_cluster(
        "autoscaled", callbacks={"report_task_result": on_report},
        with_checkpoint=True,
    )
    box["cluster"] = cluster
    ckpt_dir = os.path.join(workdir, "autoscaled", "ckpt")
    kills = 0
    cluster.own_models()
    worker = cluster.workers[0]
    while True:
        try:
            worker.run()
            break
        except ChaosKill:
            kills += 1
            if kills > 2:
                raise DrillError("kill budget exceeded")
            dead_id = state["worker_id"]
            cluster.dispatcher.recover_tasks(dead_id)
            cluster.servicer.remove_worker_metrics(dead_id)
            new_id = dead_id + 1
            state["worker_id"] = new_id
            logger.info(
                "drill: worker %d killed mid-barrier; relaunching as "
                "worker %d on the pre-grow mesh", dead_id, new_id,
            )
            # The relaunch comes up configured for the CURRENT (shrunk)
            # mesh — exactly what a pod relaunch would do — and meets
            # the still-pending grow directive on its first get_task.
            spec = mesh_spec(mesh2())
            worker = Worker(
                worker_id=new_id,
                master_client=cluster.make_inprocess_client(
                    new_id,
                    callbacks={"report_task_result": on_report},
                ),
                model_spec=spec,
                data_reader=cluster.train_reader,
                minibatch_size=minibatch_size,
                step_runner=make_runner_for_spec(spec, mesh2()),
                checkpoint_hook=CheckpointHook(
                    checkpoint_dir=ckpt_dir,
                    checkpoint_steps=checkpoint_steps,
                    async_save=False,
                ),
                checkpoint_dir_for_init=ckpt_dir,
                metrics_report_secs=0.0,
            )

    # ---- verdicts -------------------------------------------------------
    verdicts = []
    drained = cluster.finished
    accounting = ExactlyOnceTaskAccounting(
        cluster.dispatcher, {TaskType.TRAINING: records}
    ).check()
    verdicts.append(accounting.to_dict())
    verdicts.append(
        _equivalence_verdict(control, _final_summary(worker))
    )

    barrier_problems = []
    if not drained:
        barrier_problems.append("job did not drain")
    if cluster.servicer.resize_status() is not None:
        barrier_problems.append(
            "a resize barrier is still pending after the job drained"
        )
    if len(resize_log) != 2:
        barrier_problems.append(
            f"expected 2 resizes (shrink, grow), saw {resize_log}"
        )
    if kills != 1:
        barrier_problems.append(f"expected exactly 1 kill, saw {kills}")
    final_mesh = None
    if worker.state is not None:
        final_mesh = dict(worker._step_runner.mesh.shape)
        if final_mesh != {"dp": 4}:
            barrier_problems.append(
                f"final state not on the regrown dp4 mesh: {final_mesh}"
            )
    verdicts.append({
        "name": "resize_barrier_liveness",
        "passed": not barrier_problems,
        "details": (
            "; ".join(barrier_problems) if barrier_problems else
            f"shrink + grow barriers completed across {kills} "
            f"mid-barrier kill; final mesh {final_mesh}"
        ),
    })
    cluster.stop()

    passed = all(v["passed"] for v in verdicts)
    return {
        "autoscale_drill_version": REPORT_VERSION,
        "config": {
            "model_def": MODEL_DEF,
            "records": records,
            "minibatch_size": minibatch_size,
            "num_minibatches_per_task": num_minibatches_per_task,
            "checkpoint_steps": checkpoint_steps,
            "shrink_at_report": shrink_at_report,
            "grow_kill_at_report": grow_kill_at_report,
        },
        "resizes": resize_log,
        "kills": kills,
        "job": {
            "final_version": _final_summary(worker)["final_version"],
            "final_loss": (
                None if control["final_loss"] is None else round(
                    float(_final_summary(worker)["final_loss"]), 6
                )
            ),
            "final_mesh": final_mesh,
        },
        "invariants": verdicts,
        "passed": bool(passed),
    }


def main(argv=None) -> int:
    import argparse
    import shutil
    import tempfile

    parser = argparse.ArgumentParser("elasticdl_tpu_torch-autoscale-drill")
    parser.add_argument("--report", default="",
                        help=f"default: <workdir>/{DEFAULT_REPORT}, or "
                             "./autoscale_drill.json with no --workdir")
    parser.add_argument("--records", type=int, default=256)
    parser.add_argument("--workdir", default="",
                        help="Scratch dir (default: fresh tempdir, "
                             "removed afterwards)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    args.report = args.report or (
        os.path.join(args.workdir, DEFAULT_REPORT) if args.workdir
        else "autoscale_drill.json")

    workdir = args.workdir
    cleanup = False
    if not workdir:
        workdir = tempfile.mkdtemp(prefix="edl_autoscale_")
        cleanup = True
    try:
        report = run_drill(workdir, records=args.records,
                           device=args.device)
        with open(args.report, "w") as fh:
            fh.write(json.dumps(report, sort_keys=True, indent=2) + "\n")
        print(f"autoscale drill passed={report['passed']} "
              f"resizes={len(report['resizes'])} "
              f"kills={report['kills']}")
        for verdict in report["invariants"]:
            mark = "PASS" if verdict["passed"] else "FAIL"
            print(f"  [{mark}] {verdict['name']}: {verdict['details']}")
        return 0 if report["passed"] else 1
    finally:
        if cleanup:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    import sys

    sys.exit(main())
