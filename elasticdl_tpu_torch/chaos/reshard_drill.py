"""Live-reshard chaos drill (port of elasticdl_tpu/chaos/reshard_drill.py):
kills mid-migration and mid-cutover must converge to one consistent
shard map with no row lost or homed twice.

``python -m elasticdl_tpu_torch.chaos.reshard_drill --workdir DIR
[--seed 7] [--report RESHARD_DRILL.json]`` (exit 0 only if every bar
holds):

1. **Kill the source shard mid-migration.** A 2-shard fleet under a
   seeded push schedule splits live onto a third shard; the source dies
   (its server torn down, the object dropped) from the migration's chunk
   hook after the first chunks landed on the target. The relaunch
   restores the source from its checkpoint (rows, Adam slots and the
   shard map in the checkpoint's meta) and the surviving authority
   ``resume()``s the persisted migration record (a whole, idempotent
   re-copy), then finishes the cutover.
2. **Kill the authority mid-cutover.** The next split's controller dies
   between persisting the flipped map and distributing it (the world's
   truth moved and nobody was told). A fresh controller built from the
   state file ``resume()``s: it distributes the persisted epoch and
   releases the target.

After each scenario the drill pushes the rest of the schedule (these
services run without the write-ahead push log, so a trainer re-drives
the work the dead shard never durably acked), and the final state must
be byte-equal to a fault-free twin run through the same schedule and
the same splits: rows and optimizer slots across every shard. Every id
lives on exactly one home shard, and every hot-row replica copy equals
its home's bytes. The authority's state file is checked by
``tools/check_reshard.py`` at each kill (a half-moved range must be
found and resumable) and at the end (converged, no migration in
flight).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("reshard_drill")

TABLE = "drill_rows"
DIM = 8
PUSHES = 30
PUSH_IDS = 48
ID_SPACE = 1_000_000
HOT_IDS = 6
SPLIT_AT = (10, 20)  # push index before each split


class DrillKill(RuntimeError):
    """Simulated process death raised from a chaos hook."""


def _schedule(seed: int):
    """Seeded (ids, grads) per push — ids spread across the bucket
    space (uniform over a large id space) plus a pinned hot set so
    replica designation has a signal. Identical for twin and faulted
    runs."""
    rng = np.random.RandomState(seed)
    hot = rng.choice(ID_SPACE, HOT_IDS, replace=False).astype(np.int64)
    out = []
    for _ in range(PUSHES):
        ids = np.unique(np.concatenate([
            rng.randint(0, ID_SPACE, PUSH_IDS).astype(np.int64), hot,
        ]))
        grads = rng.rand(ids.size, DIM).astype(np.float32)
        out.append((ids, grads))
    return hot, out


def _build_shard(workdir: str, run: str, idx: int, port: int = 0):
    from elasticdl_tpu_torch.embedding.optimizer import (
        Adam,
        HostOptimizerWrapper,
    )
    from elasticdl_tpu_torch.embedding.row_service import HostRowService
    from elasticdl_tpu_torch.embedding.table import EmbeddingTable

    svc = HostRowService(
        {TABLE: EmbeddingTable(TABLE, DIM)},
        HostOptimizerWrapper(Adam(lr=0.01)),
    )
    # Sync writes + every push: a kill loses at most the in-flight
    # push (none, in this single-threaded drill) and restores are
    # deterministic — the tiered drill's discipline.
    svc.configure_checkpoint(
        os.path.join(workdir, run, f"shard{idx}_ckpt"),
        checkpoint_steps=1, delta_chain_max=3, async_write=False,
    )
    return svc.start(f"localhost:{port}")


class _Fleet:
    """One run's shards + authority + client, with relaunch support."""

    def __init__(self, workdir: str, run: str, seed: int):
        from elasticdl_tpu_torch.master.row_reshard import (
            ReshardPolicy,
            ShardMapController,
        )

        self.workdir = workdir
        self.run = run
        self.shards = [
            _build_shard(workdir, run, i) for i in range(2)
        ]
        self.state_path = os.path.join(workdir, run, "shard_map.json")
        self.controller = ShardMapController(
            self.state_path,
            policy=ReshardPolicy(replica_min_pulls=2,
                                 replica_top_k=HOT_IDS,
                                 replica_count=1),
        )
        self.controller.bootstrap(self.addrs)
        self.engine = None

    @property
    def addrs(self):
        return [f"localhost:{s.port}" for s in self.shards]

    def client(self):
        from elasticdl_tpu_torch.embedding.row_service import (
            make_remote_engine,
        )

        if self.engine is None:
            self.engine = make_remote_engine(
                ",".join(self.addrs), id_keys={TABLE: "ids"},
                retries=6, backoff_secs=0.1,
            )
        return self.engine

    def push(self, ids, grads):
        engine = self.client()
        engine.optimizer.apply_gradients(
            engine.tables[TABLE], ids, grads
        )

    def pull(self, ids):
        return self.client().tables[TABLE].get(ids)

    def add_shard(self) -> str:
        svc = _build_shard(self.workdir, self.run, len(self.shards))
        self.shards.append(svc)
        return f"localhost:{svc.port}"

    def kill_shard(self, idx: int):
        """Simulated SIGKILL: tear the server down without any drain;
        the object is discarded (in-memory state dies)."""
        self.shards[idx]._server.stop(None)

    def relaunch_shard(self, idx: int, port: int):
        """Replacement process: same checkpoint dir, same port."""
        for _ in range(40):
            try:
                self.shards[idx] = _build_shard(
                    self.workdir, self.run, idx, port=port
                )
                return
            except Exception:
                time.sleep(0.25)
        raise RuntimeError(f"could not rebind shard {idx} on {port}")

    def rebuild_controller(self):
        from elasticdl_tpu_torch.master.row_reshard import (
            ReshardPolicy,
            ShardMapController,
        )

        self.controller.close()
        self.controller = ShardMapController(
            self.state_path,
            policy=ReshardPolicy(replica_min_pulls=2,
                                 replica_top_k=HOT_IDS,
                                 replica_count=1),
        )

    def stop(self):
        self.controller.close()
        if self.engine is not None:
            self.engine.close()
        for svc in self.shards:
            try:
                svc.stop(0)
            except Exception:
                pass


def _row_views(svc):
    return {
        name: view for name, view in svc.host_tables.items()
        if name not in ("__row_service_seqs__",
                        "__row_optimizer_steps__")
    }


def _capture_fleet(fleet: _Fleet):
    """Union of every row view across shards, merged + sorted: the
    cross-shard state the twin comparison runs over. Also returns the
    per-shard id sets for the single-homing check."""
    merged = {}
    homes = {}
    for s, svc in enumerate(fleet.shards):
        for name, view in _row_views(svc).items():
            ids, rows = view.to_arrays()
            merged.setdefault(name, []).append(
                (np.asarray(ids, np.int64), np.asarray(rows))
            )
            if name == TABLE:
                homes[s] = set(np.asarray(ids, np.int64).tolist())
    out = {}
    for name, parts in merged.items():
        ids = np.concatenate([p[0] for p in parts])
        rows = np.concatenate([p[1] for p in parts])
        order = np.argsort(ids, kind="stable")
        out[name] = (ids[order], rows[order])
    return out, homes


def _tables_equal(a, b):
    problems = []
    for name in sorted(set(a) | set(b)):
        if name not in a or name not in b:
            problems.append(f"{name}: present in only one run")
            continue
        ids_a, rows_a = a[name]
        ids_b, rows_b = b[name]
        if not np.array_equal(ids_a, ids_b):
            problems.append(
                f"{name}: id sets differ ({ids_a.size} vs {ids_b.size})"
            )
        elif not np.array_equal(
            np.asarray(rows_a, np.float32),
            np.asarray(rows_b, np.float32),
        ):
            problems.append(f"{name}: row bytes differ")
    return problems


def _conservation_problems(fleet: _Fleet, homes):
    """No id double-homed; replica copies byte-equal their homes."""
    problems = []
    seen = {}
    for s, ids in homes.items():
        for i in ids:
            if i in seen:
                problems.append(
                    f"id {i} homed on shards {seen[i]} AND {s}"
                )
            seen[i] = s
    m = fleet.controller.map
    for s, svc in enumerate(fleet.shards):
        store = svc._replica_store.get(TABLE, {})
        for i, entry in store.items():
            home = int(m.home_of_ids([i])[0])
            if home == s:
                problems.append(f"replica copy of {i} on its own home")
                continue
            want = fleet.shards[home]._tables[TABLE].get([i])[0]
            if not np.array_equal(entry[0], np.asarray(want,
                                                      np.float32)):
                problems.append(
                    f"replica copy of {i} on shard {s} diverged from "
                    f"home {home}"
                )
    return problems


def _fsck(state_path: str, expect_migration: bool):
    from elasticdl_tpu_torch.tools.check_reshard import check_reshard

    errors, report = check_reshard(state_path)
    if expect_migration and not report.get("migration_in_flight"):
        errors = errors + [
            "expected a resumable in-flight migration record"
        ]
    if not expect_migration and report.get("migration_in_flight"):
        errors = errors + ["migration record not cleared"]
    return errors, report


def _drive(fleet: _Fleet, schedule, lo: int, hi: int):
    for seq in range(lo, hi):
        ids, grads = schedule[seq]
        fleet.push(ids, grads)


def _run_twin(workdir, seed, hot, schedule):
    """Fault-free oracle: same schedule, same split points."""
    fleet = _Fleet(workdir, "twin", seed)
    try:
        _drive(fleet, schedule, 0, SPLIT_AT[0])
        for _ in range(4):
            fleet.pull(hot)  # hot signal for replica designation
        fleet.controller.update_replicas()
        fleet.controller.split(0, new_addr=fleet.add_shard())
        _drive(fleet, schedule, SPLIT_AT[0], SPLIT_AT[1])
        fleet.controller.split(1, new_addr=fleet.add_shard())
        _drive(fleet, schedule, SPLIT_AT[1], PUSHES)
        state, homes = _capture_fleet(fleet)
        problems = _conservation_problems(fleet, homes)
        return state, fleet.controller.map.to_json(), problems
    finally:
        fleet.stop()


def _run_faulted(workdir, seed, hot, schedule, twin_state, twin_map):
    from elasticdl_tpu_torch.embedding import row_service
    from elasticdl_tpu_torch.master import row_reshard

    result = {"scenarios": [], "passed": False, "problems": []}
    fleet = _Fleet(workdir, "faulted", seed)
    try:
        _drive(fleet, schedule, 0, SPLIT_AT[0])
        for _ in range(4):
            fleet.pull(hot)
        fleet.controller.update_replicas()

        # ---- scenario 1: source dies mid-migration ----
        fired = {"n": 0}

        def _kill_mid_migrate(_svc, _mig, _view, _chunk):
            fired["n"] += 1
            if fired["n"] == 2:
                raise DrillKill("source killed mid-migration")

        src_port = fleet.shards[0].port
        new_addr = fleet.add_shard()
        row_service.set_reshard_chaos_hooks(
            mid_migrate=_kill_mid_migrate
        )
        killed = False
        try:
            fleet.controller.split(0, new_addr=new_addr)
        except Exception:
            killed = True
        finally:
            row_service.set_reshard_chaos_hooks(mid_migrate=None)
        if not killed:
            result["problems"].append(
                "mid-migrate hook never fired (range too small?)"
            )
            return result
        fleet.kill_shard(0)
        errors, _ = _fsck(fleet.state_path, expect_migration=True)
        result["scenarios"].append({
            "scenario": "kill_source_mid_migration",
            "fsck_at_kill": errors,
        })
        result["problems"].extend(errors)
        fleet.relaunch_shard(0, src_port)
        fleet.controller.resume()
        _drive(fleet, schedule, SPLIT_AT[0], SPLIT_AT[1])

        # ---- scenario 2: authority dies mid-cutover ----
        def _kill_mid_cutover(_ctrl, _record):
            raise DrillKill("authority killed mid-cutover")

        new_addr = fleet.add_shard()
        row_reshard.set_reshard_chaos_hooks(
            mid_cutover=_kill_mid_cutover
        )
        killed = False
        try:
            fleet.controller.split(1, new_addr=new_addr)
        except DrillKill:
            killed = True
        finally:
            row_reshard.set_reshard_chaos_hooks(mid_cutover=None)
        if not killed:
            result["problems"].append("mid-cutover hook never fired")
            return result
        errors, _ = _fsck(fleet.state_path, expect_migration=True)
        result["scenarios"].append({
            "scenario": "kill_authority_mid_cutover",
            "fsck_at_kill": errors,
        })
        result["problems"].extend(errors)
        fleet.rebuild_controller()
        fleet.controller.resume()
        _drive(fleet, schedule, SPLIT_AT[1], PUSHES)

        # ---- convergence + conservation + byte equality ----
        state, homes = _capture_fleet(fleet)
        result["problems"].extend(_tables_equal(twin_state, state))
        result["problems"].extend(
            _conservation_problems(fleet, homes)
        )
        final_map = fleet.controller.map.to_json()
        if final_map["ranges"] != twin_map["ranges"]:
            result["problems"].append(
                "faulted run's final ranges differ from the twin's"
            )
        versions = set()
        for svc in fleet.shards:
            versions.add(svc._shard_map.version
                         if svc._shard_map else 0)
        if versions != {fleet.controller.map.version}:
            result["problems"].append(
                f"shards did not converge to one epoch: {versions}"
            )
        errors, _ = _fsck(fleet.state_path, expect_migration=False)
        result["problems"].extend(errors)
        result["final_map_version"] = fleet.controller.map.version
        result["passed"] = not result["problems"]
        return result
    finally:
        fleet.stop()


def run_drill(workdir: str, seed: int) -> dict:
    hot, schedule = _schedule(seed)
    twin_state, twin_map, twin_problems = _run_twin(
        workdir, seed, hot, schedule
    )
    report = {
        "drill": "live_reshard",
        "seed": seed,
        "config": {
            "table": TABLE, "dim": DIM, "pushes": PUSHES,
            "push_ids": PUSH_IDS, "id_space": ID_SPACE,
            "split_at": list(SPLIT_AT), "hot_ids": HOT_IDS,
        },
        "twin_problems": twin_problems,
    }
    faulted = _run_faulted(
        workdir, seed, hot, schedule, twin_state, twin_map
    )
    report.update(faulted)
    report["problems"] = twin_problems + faulted["problems"]
    report["passed"] = faulted["passed"] and not twin_problems
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("elasticdl_tpu_torch-reshard-drill")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--report", default="",
                        help="default: <workdir>/RESHARD_DRILL.json")
    args = parser.parse_args(argv)
    args.report = args.report or os.path.join(args.workdir,
                                              "RESHARD_DRILL.json")

    report = run_drill(args.workdir, args.seed)
    with open(args.report, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True, default=str)
        fh.write("\n")
    logger.info(
        "reshard drill: %s (%d scenario(s))%s; report %s",
        "PASS" if report["passed"] else "FAIL",
        len(report.get("scenarios", [])),
        "" if report["passed"]
        else f" problems: {'; '.join(map(str, report['problems']))}",
        args.report,
    )
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
