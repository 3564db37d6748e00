"""Chaos harness (port of elasticdl_tpu/chaos/runner.py): run a fault
plan against the in-process cluster.

``ChaosRunner`` assembles the same job twice:

1. a **fault-free twin** — no injector installed — whose final
   version/loss/parameters become the loss-equivalence baseline;
2. the **faulted run** — the ``FaultInjector`` installed into the RPC,
   checkpoint, and instance-manager seams — where worker deaths are
   handled the way ``master/instance_manager.py`` handles a pod
   DELETED event: re-queue the dead worker's tasks, relaunch under a
   NEW worker id, restore from the rolling checkpoint. Plans with
   ``master_kill`` events additionally run the MASTER over a
   write-ahead journal (master/journal.py): each kill discards the
   live master and recovers an equivalent one by journal replay
   (``MiniCluster.restart_master``), audited by the
   master-restart-equivalence invariant.

Everything is sequential (one live worker at a time, synchronous row
applies, synchronous checkpoint writes), so a plan replays the exact
same schedule every run: ``chaos run --seed 7`` twice writes
byte-identical reports. Wall-clock measurements (recovery latency)
are therefore kept OUT of the default report; pass ``--timings`` to
include them.

Job flavors:

- ``sparse`` (default): the host-tier DeepFM from the model zoo with
  its table served by N in-process ``HostRowService`` shards — the
  deployment shape where shard stalls and row conservation mean
  something;
- ``dense``: the MNIST functional model, no row tier — kill /
  rpc-fault / checkpoint-corruption plans only.

Soak mode generates a ``randomized_plan`` per round from the seed and
stops at the first failed invariant, printing the seed that reproduces
it.

The job trains on ``device`` (CUDA unless "cpu" is given; the CLI's
``--device``). Every worker, a replacement too, trains its own copy of
the spec's model: a replacement starts from a fresh copy of the
template and restores the newest valid checkpoint from disk, so
nothing reads a tensor the killed worker may still have been stepping.
The twin and the faulted run train on the same device, so the
loss-equivalence tolerance compares like with like.
"""

import copy
import dataclasses
import json
import os
import threading
from typing import Dict, List, Optional

import numpy as np

from elasticdl_tpu_torch.chaos.faults import (
    MASTER_KILL,
    FaultPlan,
    default_plan,
    describe,
    master_kill_plan,
    randomized_plan,
)
from elasticdl_tpu_torch.chaos.interceptors import ChaosKill, FaultInjector
from elasticdl_tpu_torch.chaos.invariants import (
    CheckpointMonotonicity,
    ExactlyOnceTaskAccounting,
    LossTrajectoryEquivalence,
    MasterRestartEquivalence,
    RowConservation,
)
from elasticdl_tpu_torch.common.constants import TaskType
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("chaos_runner")

REPORT_VERSION = 1
# Relative to --workdir when that is given, else to the working
# directory: a run never writes the repo root's committed reports.
DEFAULT_REPORT = "chaos_report.json"

SPARSE_MODEL_DEF = "deepfm.deepfm_host.custom_model"
DENSE_MODEL_DEF = "mnist.mnist_functional.custom_model"


class ChaosRunError(RuntimeError):
    """The harness itself failed (kill budget blown, worker crashed on
    a non-injected error) — distinct from a failed invariant, which is
    a report verdict, not an exception."""


class ChaosRunner:
    def __init__(
        self,
        plan: FaultPlan,
        workdir: str,
        model: str = "sparse",
        records: int = 64,
        minibatch_size: int = 8,
        num_minibatches_per_task: int = 2,
        num_row_service_shards: int = 1,
        use_rpc: bool = True,
        twin: bool = True,
        max_kills: int = 8,
        join_timeout: float = 120.0,
        include_timings: bool = False,
        debug_disable_recovery: bool = False,
        flight_recorder_spans: int = 512,
        row_delta_chain: int = 2,
        row_checkpoint_steps: int = 1,
        device=None,
    ):
        if model not in ("sparse", "dense"):
            raise ValueError(f"unknown chaos model flavor {model!r}")
        from elasticdl_tpu_torch.common.device import resolve_device

        self.device = resolve_device(device)
        self.plan = plan
        self.workdir = workdir
        self.model = model
        self.records = int(records)
        self.minibatch_size = int(minibatch_size)
        self.num_minibatches_per_task = int(num_minibatches_per_task)
        # Checkpoint every task (= num_minibatches_per_task versions):
        # kills land at task boundaries (get_task), so the newest valid
        # checkpoint always covers exactly the completed tasks — the
        # alignment loss-trajectory equivalence needs.
        self.checkpoint_steps = self.num_minibatches_per_task
        # Row services checkpoint every push with a SHORT delta chain
        # (full, delta, delta, compaction, ...): the plan's worker
        # kills land between a delta save and the next base compaction
        # — the kill-mid-chain case — and the end-of-run shard
        # relaunch restores across a base+delta chain. Writes are
        # synchronous (async_write=False below) so the save schedule
        # replays byte-identically per seed.
        self.row_delta_chain = max(0, int(row_delta_chain))
        self.row_checkpoint_steps = max(1, int(row_checkpoint_steps))
        self.num_row_service_shards = max(1, int(num_row_service_shards))
        self.use_rpc = bool(use_rpc)
        self.twin = bool(twin)
        self.max_kills = int(max_kills)
        self.join_timeout = float(join_timeout)
        self.include_timings = bool(include_timings)
        # Test-only regression hook: skip recover_tasks on a kill so
        # the exactly-once checker demonstrably catches the lost task
        # (tests/test_torch_chaos.py).
        self.debug_disable_recovery = bool(debug_disable_recovery)
        # Last-N-spans ring attached to FAILED reports (observability/
        # tracing.py) — every red chaos run carries its own timeline.
        self.flight_recorder_spans = max(1, int(flight_recorder_spans))
        # master_kill plans need the write-ahead journal (the restart
        # seam recovers from it) and the restart-equivalence checker.
        self.master_kills_planned = sum(
            1 for e in plan.events if e.kind == MASTER_KILL
        )
        os.makedirs(workdir, exist_ok=True)

    # ---- data / model assembly -----------------------------------------

    def _data_file(self) -> str:
        from elasticdl_tpu_torch.testing.data import (
            create_frappe_record_file,
            create_mnist_record_file,
        )

        path = os.path.join(self.workdir, "train.rec")
        if not os.path.exists(path):
            if self.model == "sparse":
                create_frappe_record_file(path, self.records, seed=11)
            else:
                create_mnist_record_file(path, self.records, seed=11)
        return path

    def _start_row_services(self, subdir: str,
                            with_checkpoint: bool) -> List:
        if self.model != "sparse":
            return []
        from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host

        services = []
        for shard in range(self.num_row_service_shards):
            svc = deepfm_host.make_row_service()
            if with_checkpoint:
                svc.configure_checkpoint(
                    os.path.join(self.workdir, subdir, "rows",
                                 f"s{shard}"),
                    checkpoint_steps=self.row_checkpoint_steps,
                    delta_chain_max=self.row_delta_chain,
                    async_write=False,
                )
            svc.start(tag=f"rowservice/{shard}")
            services.append(svc)
        return services

    def _make_runner(self, services):
        if self.model != "sparse":
            return None
        from elasticdl_tpu_torch.embedding.host_engine import HostStepRunner
        from elasticdl_tpu_torch.embedding.row_service import (
            make_remote_engine,
        )
        from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host

        addr = ",".join(f"localhost:{svc.port}" for svc in services)
        # Synchronous applies (no pull-ahead, no applier thread): chaos
        # replay and the loss-equivalence twin comparison both need a
        # deterministic push order.
        return HostStepRunner(
            make_remote_engine(
                addr,
                id_keys={deepfm_host.TABLE_NAME: deepfm_host.FEATURE_KEY},
            ),
            async_apply=False,
        )

    def _build_cluster(self, subdir: str, injector, services):
        from elasticdl_tpu_torch.testing.cluster import MiniCluster
        from elasticdl_tpu_torch.testing.data import model_zoo_dir

        runner_factory = None
        if self.model == "sparse":
            runner_factory = lambda: self._make_runner(services)  # noqa: E731
        return MiniCluster(
            model_zoo=model_zoo_dir(),
            model_def=(
                SPARSE_MODEL_DEF if self.model == "sparse"
                else DENSE_MODEL_DEF
            ),
            training_data=self._data_file(),
            minibatch_size=self.minibatch_size,
            num_minibatches_per_task=self.num_minibatches_per_task,
            use_rpc=self.use_rpc,
            step_runner_factory=runner_factory,
            checkpoint_dir=os.path.join(self.workdir, subdir, "state"),
            checkpoint_steps=self.checkpoint_steps,
            checkpoint_async=False,
            fault_injector=injector,
            # Journal only on faulted runs with master kills planned:
            # the twin must model the never-crashed job, and journal
            # writes never influence training either way.
            journal_dir=(
                os.path.join(self.workdir, subdir, "journal")
                if injector is not None and self.master_kills_planned
                else ""
            ),
            device=self.device,
        )

    def _make_replacement(self, cluster, new_id: int, subdir: str,
                          injector, services):
        from elasticdl_tpu_torch.checkpoint import CheckpointHook
        from elasticdl_tpu_torch.worker.master_client import MasterClient
        from elasticdl_tpu_torch.worker.worker import Worker

        if self.use_rpc:
            client = MasterClient(
                f"localhost:{cluster._server.port}", worker_id=new_id,
                connect_timeout=10, retries=1,
            )
        else:
            # Registered with the cluster so a later master_kill
            # restart rebinds this replacement too.
            client = cluster.make_inprocess_client(
                new_id,
                callbacks=(
                    injector.in_process_callbacks()
                    if injector is not None else None
                ),
            )
        runner = self._make_runner(services)
        ckpt_dir = os.path.join(self.workdir, subdir, "state")
        hook = CheckpointHook(
            checkpoint_dir=ckpt_dir,
            checkpoint_steps=self.checkpoint_steps,
            host_tables=getattr(runner, "host_tables", None),
            async_save=False,
        )
        # A spec and a model of its own, copied from the template that no
        # worker trains: the checkpoint restore fills it from disk.
        spec = dataclasses.replace(
            cluster.spec, model=copy.deepcopy(cluster.spec.model))
        return Worker(
            worker_id=new_id,
            master_client=client,
            model_spec=spec,
            data_reader=cluster.train_reader,
            minibatch_size=self.minibatch_size,
            step_runner=runner,
            checkpoint_hook=hook,
            checkpoint_dir_for_init=ckpt_dir,
            # Elastic-relaunch semantics: no valid checkpoint yet (the
            # job died before the first save) means start fresh, not
            # crash-loop the replacement.
            checkpoint_init_required=False,
            metrics_report_secs=0.0,
        )

    # ---- worker driving -------------------------------------------------

    @staticmethod
    def _run_worker(worker, timeout: float) -> dict:
        """Run one worker to completion on a watchdog thread. A hang
        past ``timeout`` (e.g. the lost-task regression: the job never
        drains) gets a graceful stop so the harness returns a verdict
        instead of wedging."""
        box: dict = {}

        def target():
            try:
                box["result"] = worker.run()
            except BaseException as exc:  # ChaosKill rides through here
                box["error"] = exc

        thread = threading.Thread(
            target=target, daemon=True, name="chaos-worker"
        )
        thread.start()
        thread.join(timeout)
        if thread.is_alive():
            box["timed_out"] = True
            worker.request_stop()
            thread.join(30.0)
            if thread.is_alive():
                raise ChaosRunError(
                    "worker did not stop within grace after timeout"
                )
        return box

    def _drive_job(self, cluster, subdir: str, injector, services,
                   row_conservation: Optional[RowConservation]) -> dict:
        """The instance-manager role, in-process: run a worker; on a
        ChaosKill, re-queue its tasks and relaunch under a new id."""
        cluster.own_models()
        worker = cluster.workers[0]
        worker_id = 0
        next_id = 1
        kills = 0
        timed_out = False
        while True:
            box = self._run_worker(worker, self.join_timeout)
            error = box.get("error")
            if isinstance(error, ChaosKill):
                kills += 1
                if kills > self.max_kills:
                    raise ChaosRunError(
                        f"kill budget ({self.max_kills}) exceeded"
                    )
                if row_conservation is not None and services:
                    row_conservation.snapshot(
                        f"kill-{kills}", self._row_tables(services)
                    )
                if self.debug_disable_recovery:
                    logger.warning(
                        "chaos debug: SKIPPING task recovery for dead "
                        "worker %d (regression hook)", worker_id,
                    )
                else:
                    cluster.dispatcher.recover_tasks(worker_id)
                    cluster.servicer.remove_worker_metrics(worker_id)
                new_id = next_id
                next_id += 1
                logger.info(
                    "chaos: worker %d killed; relaunching as worker %d",
                    worker_id, new_id,
                )
                worker = self._make_replacement(
                    cluster, new_id, subdir, injector, services
                )
                if injector is not None:
                    injector.note_recovered(worker_id, new_id)
                worker_id = new_id
                continue
            if error is not None:
                raise error
            if box.get("timed_out"):
                timed_out = True
            result = box.get("result") or {}
            break
        leaves = {}
        if worker.state is not None:
            from elasticdl_tpu_torch.checkpoint.state_io import (
                named_leaves_from_state,
            )

            leaves = named_leaves_from_state(worker.state)
        return {
            "final_version": int(result.get("final_version", 0)),
            "final_loss": result.get("final_loss"),
            "trained_batches": int(result.get("trained_batches", 0)),
            "kills": kills,
            "timed_out": timed_out,
            "leaves": leaves,
        }

    # ---- row-service helpers -------------------------------------------

    @staticmethod
    def _row_tables(services) -> Dict:
        """Union view over all shards' checkpoint tables, keyed
        ``shard<i>/<table>`` so conservation tracks each shard."""
        out = {}
        for i, svc in enumerate(services):
            for name, table in svc.host_tables.items():
                out[f"shard{i}/{name}"] = table
        return out

    def _relaunch_row_services(self, services, subdir: str) -> List:
        """Shard-relaunch drill: graceful-drain checkpoint, stop every
        shard, start FRESH services restored from their checkpoints —
        row conservation must survive the full cycle (the reference's
        PS-pod relaunch + restore semantics)."""
        from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host

        relaunched = []
        for shard, svc in enumerate(services):
            svc.checkpoint_now()
            svc.stop(0)
            fresh = deepfm_host.make_row_service()
            # Restore path: configure_checkpoint replays the newest
            # base + delta chain the dead service left behind.
            fresh.configure_checkpoint(
                os.path.join(self.workdir, subdir, "rows", f"s{shard}"),
                checkpoint_steps=self.row_checkpoint_steps,
                delta_chain_max=self.row_delta_chain,
                async_write=False,
            )
            relaunched.append(fresh)
        return relaunched

    # ---- one full job ---------------------------------------------------

    def _run_job(self, subdir: str, injector,
                 checkers: Optional[dict] = None) -> dict:
        services = self._start_row_services(
            subdir, with_checkpoint=injector is not None
        )
        cluster = None
        try:
            cluster = self._build_cluster(subdir, injector, services)
            if injector is not None and self.master_kills_planned:
                restart_checker = (
                    checkers.get("master_restart") if checkers else None
                )

                def _restart_master(cluster=cluster,
                                    checker=restart_checker):
                    # The dead master's in-memory truth, captured for
                    # the equivalence audit only — recovery itself
                    # sees nothing but the journal.
                    dead_state = cluster.dispatcher.export_state()
                    old_generation = cluster.servicer.generation
                    stats = cluster.restart_master()
                    if checker is not None:
                        checker.observe(
                            dead_state,
                            cluster.dispatcher.export_state(),
                            old_generation,
                            stats["generation"],
                            stats["replayed"],
                        )

                injector.set_master_restart(_restart_master)
            row_conservation = (
                checkers.get("rows") if checkers else None
            )
            summary = self._drive_job(
                cluster, subdir, injector, services, row_conservation
            )
            if checkers:
                accounting = checkers.get("accounting")
                if accounting is not None:
                    accounting.bind(cluster.dispatcher)
                if row_conservation is not None and services:
                    row_conservation.snapshot(
                        "pre-relaunch", self._row_tables(services)
                    )
                    relaunched = self._relaunch_row_services(
                        services, subdir
                    )
                    services = relaunched
                    checkers["final_row_tables"] = self._row_tables(
                        services
                    )
            return summary
        finally:
            if cluster is not None:
                if cluster._server is not None:
                    cluster._server.stop(0)
                cluster.stop()
            for svc in services:
                try:
                    svc.stop(0)
                except Exception:
                    pass

    # ---- public API ------------------------------------------------------

    def run(self) -> dict:
        """Twin run (optional) then faulted run; returns the report
        dict (deterministic by construction — see module docstring)."""
        baseline = None
        if self.twin:
            logger.info("chaos: fault-free twin run")
            baseline = self._run_job("twin", injector=None)
        injector = FaultInjector(self.plan)
        monotonic = CheckpointMonotonicity()
        injector.add_checkpoint_listener(
            on_save=monotonic.on_save, on_restore=monotonic.on_restore
        )
        rows = RowConservation() if self.model == "sparse" else None
        accounting = _LateBoundAccounting(
            expected_records={TaskType.TRAINING: self.records},
        )
        equivalence = LossTrajectoryEquivalence(baseline)
        master_restart = (
            MasterRestartEquivalence(self.master_kills_planned)
            if self.master_kills_planned else None
        )
        checkers = {
            "accounting": accounting, "rows": rows,
            "master_restart": master_restart,
        }
        logger.info(
            "chaos: faulted run, %d event(s):\n%s",
            len(self.plan.events), describe(self.plan),
        )
        harness_error = None
        summary = None
        # Flight recorder for the faulted run: every red run ships its
        # own timeline. Installing it cannot perturb determinism (span
        # ids are urandom, never wall-clock, and the injector ignores
        # the _trace_ctx field), and the dump is attached ONLY to
        # failed reports — green same-seed runs stay byte-identical.
        from elasticdl_tpu_torch.observability import tracing

        recorder = tracing.FlightRecorder(
            capacity=self.flight_recorder_spans
        )
        injector.install()
        tracing.install_recorder(recorder)
        try:
            summary = self._run_job("faulted", injector, checkers)
        except ChaosRunError as exc:
            harness_error = str(exc)
        finally:
            tracing.uninstall_recorder()
            injector.uninstall()
        verdicts = []
        if summary is not None:
            equivalence.observe(summary)
        verdicts.append(accounting.check())
        if rows is not None:
            verdicts.append(
                rows.check(checkers.get("final_row_tables") or {})
            )
        verdicts.append(monotonic.check())
        verdicts.append(equivalence.check())
        if master_restart is not None:
            verdicts.append(master_restart.check())
        passed = harness_error is None and all(v.passed for v in verdicts)
        report = {
            "chaos_report_version": REPORT_VERSION,
            "seed": int(self.plan.seed),
            "config": {
                "model": self.model,
                "records": self.records,
                "minibatch_size": self.minibatch_size,
                "num_minibatches_per_task": self.num_minibatches_per_task,
                "checkpoint_steps": self.checkpoint_steps,
                "row_checkpoint_steps": self.row_checkpoint_steps,
                "row_delta_chain": self.row_delta_chain,
                "num_row_service_shards": self.num_row_service_shards,
                "use_rpc": self.use_rpc,
                "twin": self.twin,
            },
            "plan": self.plan.to_dict(),
            "schedule": injector.injected,
            "fault_counts": injector.fault_counts(),
            "job": _round_summary(summary),
            "invariants": [v.to_dict() for v in verdicts],
            "metrics": injector.metric_families(),
            "passed": bool(passed),
        }
        if harness_error is not None:
            report["harness_error"] = harness_error
        if not passed:
            # Dump the last-N-spans ring into the red report: the
            # failed invariant arrives with the timeline that led to it
            # (which task stalled, which RPC retried, which checkpoint
            # write preceded the kill). Green reports never carry it,
            # so same-seed byte-identity is untouched.
            report["flight_recorder"] = {
                "capacity": recorder.capacity,
                "spans": [_round_span(s) for s in recorder.snapshot()],
            }
        if self.include_timings:
            # Wall-clock section: excluded by default so same-seed runs
            # are byte-identical.
            report["timings"] = {
                "recoveries": [
                    {**r, "latency_secs": round(r["latency_secs"], 4)}
                    for r in injector.recoveries
                ],
                "master_restarts": [
                    {**r, "latency_secs": round(r["latency_secs"], 4)}
                    for r in injector.master_restarts
                ],
            }
        return report


class _LateBoundAccounting:
    """ExactlyOnceTaskAccounting whose dispatcher arrives after the
    cluster is built (the checker set is created before the job)."""

    def __init__(self, expected_records, num_epochs: int = 1):
        self._expected = expected_records
        self._epochs = num_epochs
        self._inner = None

    def bind(self, dispatcher):
        self._inner = ExactlyOnceTaskAccounting(
            dispatcher, self._expected, self._epochs
        )

    def check(self):
        from elasticdl_tpu_torch.chaos.invariants import CheckResult

        if self._inner is None:
            return CheckResult(
                ExactlyOnceTaskAccounting.name, False,
                "job never produced a dispatcher to audit",
            )
        return self._inner.check()


def _round_span(span: dict) -> dict:
    """Flight-recorder span for the (red) report: timestamps rebased
    nowhere (monotonic, process-relative) but rounded for readability;
    ids kept so the tree is reconstructable with critical_path.py."""
    out = dict(span)
    out["t0"] = round(float(span.get("t0", 0.0)), 6)
    out["dur"] = round(float(span.get("dur", 0.0)), 6)
    return out


def _round_summary(summary: Optional[dict]) -> Optional[dict]:
    """Job summary for the report: floats rounded (stable text), the
    (large) leaves dict reduced to a per-leaf shape listing."""
    if summary is None:
        return None
    leaves = summary.get("leaves") or {}
    loss = summary.get("final_loss")
    return {
        "final_version": summary["final_version"],
        "final_loss": None if loss is None else round(float(loss), 6),
        "trained_batches": summary["trained_batches"],
        "kills": summary["kills"],
        "timed_out": bool(summary.get("timed_out")),
        "dense_leaves": {
            name: [int(d) for d in np.shape(arr)]
            for name, arr in sorted(leaves.items())
        },
    }


def render_report(report: dict) -> str:
    return json.dumps(report, sort_keys=True, indent=2) + "\n"


def write_report(report: dict, path: str):
    with open(path, "w") as fh:
        fh.write(render_report(report))
    logger.info("chaos report written to %s", path)


# ---- CLI ----------------------------------------------------------------


def main(argv=None) -> int:
    """``python -m elasticdl_tpu_torch chaos {run|soak} <flags>``."""
    import argparse
    import shutil
    import tempfile

    parser = argparse.ArgumentParser("elasticdl_tpu_torch-chaos")
    parser.add_argument("command", choices=["run", "soak"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--plan", default="",
                        help="JSON fault-plan file; default: the "
                             "canonical seed-derived plan")
    parser.add_argument("--master_kill", action="store_true",
                        help="run: use the master-crash acceptance "
                             "plan (two master kills recovered by "
                             "journal replay) instead of the canonical "
                             "worker-fault plan")
    parser.add_argument("--report", default="",
                        help="Report path (default: "
                             f"<workdir>/{DEFAULT_REPORT}, or "
                             f"./{DEFAULT_REPORT} with no --workdir)")
    parser.add_argument("--workdir", default="",
                        help="Scratch dir (default: a fresh tempdir, "
                             "removed afterwards)")
    parser.add_argument("--model", choices=["sparse", "dense"],
                        default="sparse")
    parser.add_argument("--records", type=int, default=64)
    parser.add_argument("--minibatch_size", type=int, default=8)
    parser.add_argument("--num_minibatches_per_task", type=int, default=2)
    parser.add_argument("--num_row_service_shards", type=int, default=1)
    parser.add_argument("--in_process", action="store_true",
                        help="Drive the master via direct calls "
                             "instead of localhost gRPC")
    parser.add_argument("--no_twin", action="store_true",
                        help="Skip the fault-free twin (disables the "
                             "loss-equivalence invariant)")
    parser.add_argument("--timings", action="store_true",
                        help="Include wall-clock recovery latencies "
                             "(makes the report non-byte-reproducible)")
    parser.add_argument("--max_kills", type=int, default=8)
    parser.add_argument("--join_timeout", type=float, default=120.0)
    parser.add_argument("--rounds", type=int, default=3,
                        help="soak: randomized plans per invocation")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from elasticdl_tpu_torch.common.device import resolve_device

    device = resolve_device(args.device)
    workdir = args.workdir
    cleanup = False
    if not args.report:
        args.report = os.path.join(workdir, DEFAULT_REPORT)
    if not workdir:
        workdir = tempfile.mkdtemp(prefix="edl_chaos_")
        cleanup = True

    def runner_for(plan: FaultPlan, subdir: str) -> ChaosRunner:
        return ChaosRunner(
            plan,
            workdir=os.path.join(workdir, subdir),
            model=args.model,
            records=args.records,
            minibatch_size=args.minibatch_size,
            num_minibatches_per_task=args.num_minibatches_per_task,
            num_row_service_shards=args.num_row_service_shards,
            use_rpc=not args.in_process,
            twin=not args.no_twin,
            max_kills=args.max_kills,
            join_timeout=args.join_timeout,
            include_timings=args.timings,
            device=device,
        )

    try:
        if args.command == "run":
            if args.plan:
                plan = FaultPlan.load(args.plan)
            elif args.master_kill:
                plan = master_kill_plan(
                    args.seed,
                    num_row_service_shards=args.num_row_service_shards,
                )
            else:
                plan = default_plan(
                    args.seed,
                    num_row_service_shards=args.num_row_service_shards,
                )
            report = runner_for(plan, "r0").run()
            write_report(report, args.report)
            print(f"chaos run seed={plan.seed} "
                  f"passed={report['passed']} "
                  f"faults={report['fault_counts']}")
            for verdict in report["invariants"]:
                mark = "PASS" if verdict["passed"] else "FAIL"
                print(f"  [{mark}] {verdict['name']}: "
                      f"{verdict['details']}")
            return 0 if report["passed"] else 1

        # soak: randomized plans; first failure wins and prints the
        # seed that replays it.
        rounds = []
        failed_seed = None
        for i in range(args.rounds):
            round_seed = args.seed * 1000 + i
            plan = randomized_plan(
                round_seed,
                num_row_service_shards=args.num_row_service_shards,
            )
            print(f"chaos soak round {i} seed={round_seed}: "
                  f"{len(plan.events)} event(s)")
            report = runner_for(plan, f"soak{i}").run()
            rounds.append({
                "seed": round_seed,
                "passed": report["passed"],
                "fault_counts": report["fault_counts"],
                "invariants": report["invariants"],
            })
            if not report["passed"]:
                failed_seed = round_seed
                break
        soak_report = {
            "chaos_report_version": REPORT_VERSION,
            "mode": "soak",
            "seed": int(args.seed),
            "rounds": rounds,
            "passed": failed_seed is None,
        }
        write_report(soak_report, args.report)
        if failed_seed is not None:
            # The failing plan is fully determined by its seed — dump
            # it so the failure replays with one command.
            plan_path = args.report.replace(
                ".json", ""
            ) + f"_failed_plan_seed{failed_seed}.json"
            randomized_plan(
                failed_seed,
                num_row_service_shards=args.num_row_service_shards,
            ).save(plan_path)
            print(
                f"chaos soak FAILED at seed {failed_seed}; reproduce "
                f"with:\n  python -m elasticdl_tpu_torch chaos run "
                f"--plan {plan_path}"
            )
            return 1
        print(f"chaos soak passed ({len(rounds)} round(s))")
        return 0
    finally:
        if cleanup:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    import sys

    sys.exit(main())
