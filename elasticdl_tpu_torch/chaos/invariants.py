"""Recovery invariants (port of elasticdl_tpu/chaos/invariants.py, a
jax-free copy): what must hold after any fault schedule.

The paper's elasticity story (task re-queue + pod relaunch, no
checkpoint-restart of the job) makes four concrete promises that these
checkers turn into pass/fail verdicts:

1. **Exactly-once task accounting** — every record of every shard is
   counted complete exactly once per epoch: a kill must not lose a
   task (records short) and a requeue must not double-run one
   (records over). This is the dispatcher's core contract.
2. **Row conservation** — embedding rows materialized on the host/row
   tier survive worker death and shard relaunch: a row that existed at
   any kill still exists at the end (and after a checkpoint→restore
   relaunch cycle of the row service).
3. **Checkpoint version monotonicity** — saved versions strictly
   increase per directory, and every restore lands on a version no
   newer than the last save (a restore from the "future" means torn
   GC or clock-free version reuse).
4. **Loss-trajectory equivalence** — at equal data order, a faulted
   run ends bit-close to its fault-free twin: same final version,
   same final loss, same dense parameters. This is the end-to-end
   proof that recovery neither lost nor double-applied training.

Checkers return ``CheckResult`` (never raise) so a report can carry
every verdict; a failed invariant is a *finding*, not a crash.
"""

import dataclasses
import threading
from typing import Dict, List, Optional

import numpy as np

from elasticdl_tpu_torch.common.constants import TaskType


@dataclasses.dataclass
class CheckResult:
    name: str
    passed: bool
    details: str = ""

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "passed": bool(self.passed),
            "details": self.details,
        }


class ExactlyOnceTaskAccounting:
    """No lost and no double-counted shards in the dispatcher.

    ``expected_records`` maps task type -> records per epoch;
    training expectations scale by ``num_epochs``. ``check`` reads the
    dispatcher's public counters plus its queue state, so a job that
    wedged (task stuck in ``doing`` because recovery was skipped)
    fails with the stuck task named rather than hanging the harness.
    """

    name = "exactly_once_task_accounting"

    def __init__(self, dispatcher, expected_records: Dict[str, int],
                 num_epochs: int = 1):
        self._d = dispatcher
        self._expected = dict(expected_records)
        self._epochs = int(num_epochs)

    def check(self) -> CheckResult:
        problems: List[str] = []
        if not self._d.finished():
            with self._d._lock:
                todo = len(self._d._todo)
                doing = sorted(
                    (tid, wid)
                    for tid, (_t, wid, _s) in self._d._doing.items()
                )
            problems.append(
                f"job did not drain: todo={todo} doing={doing} "
                "(lost task: leased but never reported or recovered?)"
            )
        completed = self._d.counters.total_records
        for task_type, per_epoch in sorted(self._expected.items()):
            want = per_epoch * (
                self._epochs if task_type == TaskType.TRAINING else 1
            )
            got = completed.get(task_type, 0)
            if got < want:
                problems.append(
                    f"{task_type}: {want - got} record(s) LOST "
                    f"(completed {got}, expected {want})"
                )
            elif got > want:
                problems.append(
                    f"{task_type}: {got - want} record(s) DOUBLE-"
                    f"counted (completed {got}, expected {want})"
                )
        failed = {
            k: v for k, v in self._d.counters.failed_records.items() if v
        }
        if failed:
            problems.append(f"records failed permanently: {failed}")
        if problems:
            return CheckResult(self.name, False, "; ".join(problems))
        return CheckResult(
            self.name, True,
            f"all records counted exactly once: "
            f"{dict(sorted(completed.items()))}",
        )


class RowConservation:
    """Embedding rows survive worker death and shard relaunch.

    The runner calls ``snapshot(label)`` at every kill (and before a
    row-service relaunch drill); ``check(final_tables)`` verifies every
    snapshotted row id still exists in the final tables and that the
    optimizer's slot tables carry the same id set as their base table
    (an orphaned or missing slot row means the optimizer state for
    that row silently reset)."""

    name = "embedding_row_conservation"

    def __init__(self):
        self._snapshots: List[dict] = []
        self._lock = threading.Lock()

    @staticmethod
    def _ids_of(tables) -> Dict[str, np.ndarray]:
        out = {}
        for name, table in (tables or {}).items():
            ids, _rows = table.to_arrays()
            out[name] = np.sort(np.asarray(ids, np.int64))
        return out

    def snapshot(self, label: str, tables):
        with self._lock:
            self._snapshots.append(
                {"label": label, "ids": self._ids_of(tables)}
            )

    def check(self, final_tables) -> CheckResult:
        final_ids = self._ids_of(final_tables)
        problems: List[str] = []
        for snap in self._snapshots:
            for tname, ids in snap["ids"].items():
                have = final_ids.get(tname)
                if have is None:
                    problems.append(
                        f"table {tname!r} (snapshot {snap['label']!r}) "
                        "missing from final tables"
                    )
                    continue
                lost = np.setdiff1d(ids, have)
                if lost.size:
                    problems.append(
                        f"table {tname!r}: {lost.size} row(s) lost "
                        f"since snapshot {snap['label']!r} "
                        f"(e.g. ids {lost[:5].tolist()})"
                    )
        if problems:
            return CheckResult(self.name, False, "; ".join(problems))
        rows = {t: int(ids.size) for t, ids in sorted(final_ids.items())}
        return CheckResult(
            self.name, True,
            f"{len(self._snapshots)} snapshot(s) conserved; "
            f"final rows {rows}",
        )


class CheckpointMonotonicity:
    """Saved versions strictly increase per checkpoint dir; every
    restore version is <= the newest save seen for that dir at restore
    time. Feed it through ``FaultInjector.add_checkpoint_listener``
    (the saver hooks report both sides)."""

    name = "checkpoint_version_monotonicity"

    def __init__(self):
        self._lock = threading.Lock()
        self._saves: Dict[str, List[int]] = {}
        self._restores: Dict[str, List[int]] = {}
        self._problems: List[str] = []

    def on_save(self, checkpoint_dir: str, version: int):
        with self._lock:
            log = self._saves.setdefault(checkpoint_dir, [])
            # Equal is allowed: a graceful-drain checkpoint_now() may
            # re-publish the version the interval already wrote (an
            # idempotent overwrite); only going BACKWARDS is torn.
            if log and version < log[-1]:
                self._problems.append(
                    f"{checkpoint_dir}: save version went backwards "
                    f"({log[-1]} -> {version})"
                )
            log.append(int(version))

    def on_restore(self, checkpoint_dir: str, version: int):
        with self._lock:
            saves = self._saves.get(checkpoint_dir, [])
            if saves and version > saves[-1]:
                self._problems.append(
                    f"{checkpoint_dir}: restored version {version} "
                    f"newer than last save {saves[-1]}"
                )
            self._restores.setdefault(checkpoint_dir, []).append(
                int(version)
            )

    def check(self) -> CheckResult:
        with self._lock:
            if self._problems:
                return CheckResult(
                    self.name, False, "; ".join(self._problems)
                )
            saves = sum(len(v) for v in self._saves.values())
            restores = sum(len(v) for v in self._restores.values())
        return CheckResult(
            self.name, True,
            f"{saves} save(s) monotone across "
            f"{len(self._saves)} dir(s); {restores} restore(s) sane",
        )


class MasterRestartEquivalence:
    """Journal replay reconstructs the dead master's dispatcher state.

    The restart seam calls ``observe`` with the crashing master's
    exported dispatcher state (its in-memory truth at the moment of
    death — the harness can see it; a real crash couldn't) and the
    recovered dispatcher's state after snapshot+tail replay. The two
    must be equivalent field for field: todo order, leases, task-id
    counter, retry budgets, record counters, the idempotence ledger,
    even the epoch-shuffle RNG. The generation fence must strictly
    increase per restart. ``worker_version`` is excluded: it is
    advisory (SSP observation only) and deliberately not journaled.

    Loss-trajectory equivalence and exactly-once accounting then prove
    the *end-to-end* consequence; this checker localizes a replay bug
    to the restart where state first diverged.
    """

    name = "master_restart_equivalence"

    _VOLATILE = ("worker_version",)

    def __init__(self, expected_restarts: int = 0):
        self._expected = int(expected_restarts)
        self._lock = threading.Lock()
        self._problems: List[str] = []
        self._restarts: List[dict] = []

    @classmethod
    def _normalize(cls, state: dict) -> dict:
        return {
            k: v for k, v in state.items() if k not in cls._VOLATILE
        }

    def observe(self, dead_state: dict, recovered_state: dict,
                old_generation: int, new_generation: int,
                replayed: int):
        with self._lock:
            index = len(self._restarts)
            self._restarts.append({
                "replayed": int(replayed),
                "generation": int(new_generation),
            })
            if new_generation <= old_generation:
                self._problems.append(
                    f"restart {index}: generation did not advance "
                    f"({old_generation} -> {new_generation})"
                )
            dead = self._normalize(dead_state)
            recovered = self._normalize(recovered_state)
            if dead != recovered:
                diverged = sorted(
                    k for k in set(dead) | set(recovered)
                    if dead.get(k) != recovered.get(k)
                )
                self._problems.append(
                    f"restart {index}: replay diverged from the dead "
                    f"master's state in field(s) {diverged}"
                )

    def check(self) -> CheckResult:
        with self._lock:
            if self._problems:
                return CheckResult(
                    self.name, False, "; ".join(self._problems)
                )
            if len(self._restarts) < self._expected:
                return CheckResult(
                    self.name, False,
                    f"only {len(self._restarts)} of {self._expected} "
                    "planned master kill(s) restarted — the seam "
                    "never fired",
                )
            detail = ", ".join(
                f"#{i}: gen {r['generation']} after {r['replayed']} "
                "record(s)"
                for i, r in enumerate(self._restarts)
            )
        return CheckResult(
            self.name, True,
            f"{len(self._restarts)} restart(s) recovered equivalent "
            f"dispatcher state ({detail})" if self._restarts
            else "no master restarts in this plan",
        )


class LossTrajectoryEquivalence:
    """Faulted run == fault-free twin at equal data order.

    ``baseline``/``observe`` take the job summary the runner builds:
    ``{"final_version": int, "final_loss": float,
    "leaves": {name: ndarray}}``. Comparison is allclose with a small
    tolerance — recovery replays the same ops in the same order, so on
    one host the trajectories should be bit-equal; the tolerance only
    absorbs reduction-order noise if a backend reorders."""

    name = "loss_trajectory_equivalence"

    def __init__(self, baseline: Optional[dict], atol: float = 1e-5):
        self._baseline = baseline
        self._faulted: Optional[dict] = None
        self._atol = float(atol)

    def observe(self, faulted: dict):
        self._faulted = faulted

    def check(self) -> CheckResult:
        if self._baseline is None:
            return CheckResult(
                self.name, True, "skipped: no fault-free twin run"
            )
        if self._faulted is None:
            return CheckResult(
                self.name, False, "faulted run produced no summary"
            )
        base, run = self._baseline, self._faulted
        problems: List[str] = []
        if run["final_version"] != base["final_version"]:
            problems.append(
                f"final version {run['final_version']} != twin "
                f"{base['final_version']} (training lost or repeated)"
            )
        b_loss, r_loss = base.get("final_loss"), run.get("final_loss")
        if (b_loss is None) != (r_loss is None):
            problems.append(
                f"final loss presence differs (twin={b_loss}, "
                f"faulted={r_loss})"
            )
        elif b_loss is not None and not np.isclose(
            r_loss, b_loss, atol=self._atol, rtol=0.0
        ):
            problems.append(
                f"final loss {r_loss:.8f} != twin {b_loss:.8f}"
            )
        base_leaves = base.get("leaves") or {}
        run_leaves = run.get("leaves") or {}
        if set(base_leaves) != set(run_leaves):
            problems.append("dense leaf sets differ")
        else:
            worst, worst_name = 0.0, ""
            for name, arr in base_leaves.items():
                diff = float(np.max(np.abs(
                    np.asarray(run_leaves[name], np.float64)
                    - np.asarray(arr, np.float64)
                ))) if np.asarray(arr).size else 0.0
                if diff > worst:
                    worst, worst_name = diff, name
            if worst > self._atol:
                problems.append(
                    f"dense params diverged: max |delta| {worst:.3e} "
                    f"at {worst_name!r}"
                )
        if problems:
            return CheckResult(self.name, False, "; ".join(problems))
        return CheckResult(
            self.name, True,
            f"version {run['final_version']} and "
            f"{len(run_leaves)} dense leaves match the twin",
        )
