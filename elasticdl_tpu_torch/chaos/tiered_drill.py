"""Tiered-storage chaos drill (port of
elasticdl_tpu/chaos/tiered_drill.py): kills mid-eviction and
mid-compaction must restore to a consistent table.

``python -m elasticdl_tpu_torch.chaos.tiered_drill --workdir DIR
[--report PATH]`` (exit 0 only if every scenario holds; the report
defaults to ``DIR/TIERED_DRILL.json``). Host only: the rows live in
host RAM and on disk, no device is touched.

1. **Kill mid-eviction** — a tiered ``HostRowService`` (hot budget a
   fraction of the driven id space, slots tiering in lockstep via the
   native optimizer) is killed by ``ChaosKill`` raised from the tier's
   pre-erase chaos hook: demoted rows' bytes are already appended to
   the cold store but the hot arena still holds them — the duplicate-
   record window. The relaunch restores from the checkpoint chain into
   a FRESH cold dir (the cold tier is a spill cache; a dead
   incarnation's spill is never resurrected), the *runner* re-pushes
   the schedule suffix past the restored version, and the end state
   must land **byte-equal** to a fault-free twin driven by the same
   seeded schedule — rows, optimizer slots, and Adam step counters
   included.

   Contract note: this drill's service runs checkpoints WITHOUT the
   write-ahead push log, so the kill legitimately loses applied
   pushes back to the restored version and the runner models a
   trainer retrying the *unacked* suffix. Once ``--push_log_dir`` is
   configured, that external re-drive is FORBIDDEN — acked pushes
   survive kills on their own (restore-chain → WAL-tail replay), and
   ``chaos/quake_drill.py`` pins exactly that: byte-equality with no
   re-driven pushes.
2. **Kill mid-compaction** — same service shape, killed from the cold
   store's mid-compact hook: the victim segment's live rows are
   re-appended to the tail but the victim file still exists. Same
   relaunch + replay + byte-equality bar.
3. **Store-level crash recovery** — a raw ``ColdRowStore`` crashed
   mid-compaction is reopened with ``fresh=False``: the rebuilt
   later-record-wins index must serve every row byte-equal to the
   pre-crash oracle, proving segments are self-describing.

Every dead incarnation's cold dir is left in the workdir and audited
by the port's ``tools/check_store.py`` (in process). The row-
conservation invariant (chaos/invariants.py) snapshots at each kill
over ``to_arrays`` — which spans BOTH tiers, so a row demoted to disk
counts exactly like a hot one. Exits nonzero unless every scenario
holds. Fast lane: ``tests/test_torch_chaos_row_drills.py``.
"""

import argparse
import json
import os
import sys

import numpy as np

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("tiered_drill")

TABLE = "drill_rows"
DIM = 8
VOCAB = 480
HOT_BUDGET = 48
PUSHES = 60
CHECKPOINT_STEPS = 10
SEGMENT_BYTES = 4096


def _schedule(seed: int):
    """The seeded push schedule: (ids, grads) per seq, identical for
    twin, faulted, and replay runs."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(PUSHES):
        ids = np.unique(rng.randint(0, VOCAB, 96)).astype(np.int64)
        grads = rng.rand(ids.size, DIM).astype(np.float32)
        out.append((ids, grads))
    return out


def _build_service(ckpt_dir, cold_dir=None):
    from elasticdl_tpu_torch.embedding.optimizer import Adam
    from elasticdl_tpu_torch.embedding.row_service import HostRowService
    from elasticdl_tpu_torch.native.row_store import (
        make_host_optimizer,
        make_host_table,
    )

    svc = HostRowService(
        {TABLE: make_host_table(TABLE, DIM)},
        make_host_optimizer(Adam(lr=0.01)),
    )
    if cold_dir is not None:
        svc.configure_tiering(
            cold_dir, HOT_BUDGET, segment_max_bytes=SEGMENT_BYTES,
            compact_live_fraction=0.6, background_compact=False,
        )
    svc.configure_checkpoint(
        ckpt_dir, checkpoint_steps=CHECKPOINT_STEPS,
        delta_chain_max=3, async_write=False,
    )
    return svc


def _drive(svc, schedule, start_seq: int, client: str):
    """Push seqs ``start_seq..len(schedule)`` through the real
    handler; a ChaosKill propagates to the caller (the simulated pod
    death)."""
    for seq in range(start_seq, len(schedule) + 1):
        ids, grads = schedule[seq - 1]
        svc._push_row_grads({
            "table": TABLE, "ids": ids, "grads": grads,
            "client": client, "seq": seq,
        })


def _row_views(svc):
    """The checkpoint views that hold ROWS (tables + slots + step
    counters) — the push-dedup seq map is client-id bookkeeping, keyed
    by which incarnation pushed, so equality/conservation over it
    would compare client ids, not state."""
    return {
        name: view for name, view in svc.host_tables.items()
        if name != "__row_service_seqs__"
    }


def _capture(svc):
    """Every row view's (ids, rows), across both tiers."""
    return {
        name: view.to_arrays() for name, view in _row_views(svc).items()
    }


def _tables_equal(a, b):
    problems = []
    for name in sorted(a):
        ids_a, rows_a = a[name]
        ids_b, rows_b = b[name]
        if not np.array_equal(np.asarray(ids_a), np.asarray(ids_b)):
            problems.append(f"{name}: id sets differ "
                            f"({len(ids_a)} vs {len(ids_b)})")
        elif not np.array_equal(
            np.asarray(rows_a, np.float32), np.asarray(rows_b, np.float32)
        ):
            problems.append(f"{name}: row bytes differ")
    return problems


def _kill_drill(workdir, schedule, twin_state, scenario: str, seed: int):
    """One service-level kill scenario: fault hook raises ChaosKill,
    relaunch restores + replays, final state must equal the twin's."""
    from elasticdl_tpu_torch.chaos.interceptors import ChaosKill
    from elasticdl_tpu_torch.chaos.invariants import RowConservation
    from elasticdl_tpu_torch.storage import cold_store, tiered

    ckpt_dir = os.path.join(workdir, scenario, "ckpt")
    cold_a = os.path.join(workdir, "cold", f"{scenario}_dead")
    cold_b = os.path.join(workdir, "cold", f"{scenario}_relaunch")
    result = {"scenario": scenario, "passed": False, "problems": []}
    conservation = RowConservation()

    svc = _build_service(ckpt_dir, cold_a)
    fired = {"n": 0}

    def _boom(*_args):
        # Arm on the SECOND event so the first eviction/compaction
        # exercises the healthy path in the same run.
        fired["n"] += 1
        if fired["n"] == 2:
            raise ChaosKill(worker_id=0, event_index=fired["n"])

    if scenario == "kill_mid_eviction":
        tiered.set_chaos_hooks(pre_erase=_boom)
    else:
        cold_store.set_chaos_hooks(mid_compact=_boom)
    killed_at = None
    try:
        _drive(svc, schedule, 1, f"drill-{scenario}")
    except ChaosKill:
        killed_at = svc._push_count
        conservation.snapshot(f"{scenario}@push{killed_at}",
                              _row_views(svc))
    finally:
        tiered.set_chaos_hooks(pre_erase=None)
        cold_store.set_chaos_hooks(mid_compact=None)
    if killed_at is None:
        result["problems"].append(
            "fault hook never fired (no eviction/compaction happened "
            "— workload too small for the budget?)"
        )
        return result
    result["killed_at_push"] = int(killed_at)

    # Relaunch: fresh cold dir (spill is not durable state), restore
    # from the chain, replay the pushes the kill lost. The dead
    # incarnation's cold dir stays on disk for fsck.
    svc2 = _build_service(ckpt_dir, cold_b)
    restored = svc2._push_count
    result["restored_version"] = int(restored)
    _drive(svc2, schedule, restored + 1, f"drill-{scenario}-relaunch")
    assert svc2.checkpoint_now()

    check = conservation.check(_row_views(svc2))
    result["row_conservation"] = check.to_dict()
    if not check.passed:
        result["problems"].append(check.details)
    result["problems"].extend(
        _tables_equal(twin_state, _capture(svc2))
    )
    stats = svc2.tier_stats()[TABLE]
    result["tier_stats"] = {
        "hot_rows": stats["hot_rows"], "cold_rows": stats["cold_rows"],
        "budget": stats["budget"],
    }
    if stats["hot_rows"] > HOT_BUDGET:
        result["problems"].append(
            f"hot tier over budget after relaunch: "
            f"{stats['hot_rows']} > {HOT_BUDGET}"
        )
    svc2.stop()
    result["passed"] = not result["problems"]
    return result


def _store_recovery_drill(workdir, seed: int):
    """Raw ColdRowStore crashed mid-compaction, reopened fresh=False:
    the rebuilt index must serve pre-crash bytes exactly."""
    from elasticdl_tpu_torch.chaos.interceptors import ChaosKill
    from elasticdl_tpu_torch.storage import ColdRowStore, cold_store

    path = os.path.join(workdir, "cold", "store_recovery")
    result = {"scenario": "store_crash_recovery", "passed": False,
              "problems": []}
    rng = np.random.RandomState(seed)
    store = ColdRowStore(path, dim=DIM, segment_max_bytes=2048,
                         compact_live_fraction=0.6,
                         background_compact=False)
    ids = np.arange(128, dtype=np.int64)
    oracle = {}

    def _boom(_seg):
        raise ChaosKill(worker_id=0, event_index=1)

    try:
        rows = rng.rand(ids.size, DIM).astype(np.float32)
        store.put_rows(ids, rows)
        for i, row in zip(ids.tolist(), rows):
            oracle[i] = row
        cold_store.set_chaos_hooks(mid_compact=_boom)
        # Overwrites drop segment live fractions below threshold; the
        # inline compactor then dies between re-append and delete.
        # rows2 go into the oracle FIRST: put_rows commits them to the
        # index before _maybe_compact runs, so the kill lands after
        # they are durable.
        rows2 = rng.rand(64, DIM).astype(np.float32)
        for i, row in zip(ids[:64].tolist(), rows2):
            oracle[i] = row
        store.put_rows(ids[:64], rows2)
        result["problems"].append("mid-compact hook never fired")
    except ChaosKill:
        pass
    finally:
        cold_store.set_chaos_hooks(mid_compact=None)
    if result["problems"]:
        return result

    reopened = ColdRowStore(path, fresh=False, background_compact=False)
    want_ids = np.array(sorted(oracle), np.int64)
    have_ids = reopened.live_ids()
    if not np.array_equal(want_ids, have_ids):
        result["problems"].append(
            f"recovered id set differs: {want_ids.size} expected, "
            f"{have_ids.size} recovered"
        )
    else:
        got = reopened.get_rows(want_ids)
        want = np.stack([oracle[i] for i in want_ids.tolist()])
        if not np.array_equal(got, want):
            result["problems"].append(
                "recovered rows differ from pre-crash bytes"
            )
    result["recovered_rows"] = int(have_ids.size)
    reopened.close()
    result["passed"] = not result["problems"]
    return result


def run_drill(workdir: str, seed: int) -> dict:
    schedule = _schedule(seed)

    # Fault-free twin: same schedule, no tiering — the byte-equality
    # oracle (tiering must be invisible to training semantics).
    twin = _build_service(os.path.join(workdir, "twin", "ckpt"))
    _drive(twin, schedule, 1, "drill-twin")
    assert twin.checkpoint_now()
    twin_state = _capture(twin)
    twin.stop()

    scenarios = [
        _kill_drill(workdir, schedule, twin_state,
                    "kill_mid_eviction", seed),
        _kill_drill(workdir, schedule, twin_state,
                    "kill_mid_compaction", seed),
        _store_recovery_drill(workdir, seed),
    ]

    # Fsck every cold dir the drill left behind — dead incarnations
    # included (their crash states must still parse clean).
    from elasticdl_tpu_torch.tools.check_store import check_store

    fsck_errors, fsck_report = check_store(os.path.join(workdir, "cold"))
    return {
        "drill": "tiered_storage",
        "seed": seed,
        "config": {
            "table": TABLE, "dim": DIM, "vocab": VOCAB,
            "hot_budget_rows": HOT_BUDGET, "pushes": PUSHES,
            "checkpoint_steps": CHECKPOINT_STEPS,
            "segment_max_bytes": SEGMENT_BYTES,
        },
        "scenarios": scenarios,
        "fsck": {
            "errors": fsck_errors,
            "stores": len(fsck_report["stores"]),
            "live_rows": fsck_report["live_rows"],
            "garbage_bytes": fsck_report["garbage_bytes"],
        },
        "passed": (
            all(s["passed"] for s in scenarios) and not fsck_errors
        ),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("elasticdl_tpu_torch-tiered-drill")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--workdir", required=True,
                        help="Scratch dir; cold dirs (dead incarnations "
                             "included) are left here for fsck")
    parser.add_argument("--report", default="",
                        help="default: <workdir>/TIERED_DRILL.json")
    args = parser.parse_args(argv)
    args.report = args.report or os.path.join(args.workdir,
                                              "TIERED_DRILL.json")

    report = run_drill(args.workdir, args.seed)
    with open(args.report, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True, default=str)
        fh.write("\n")
    for scenario in report["scenarios"]:
        logger.info(
            "tiered drill %s: %s%s", scenario["scenario"],
            "PASS" if scenario["passed"] else "FAIL",
            "" if scenario["passed"]
            else f" ({'; '.join(scenario['problems'])})",
        )
    logger.info(
        "tiered drill: %s (fsck %d store(s), %d error(s)); report %s",
        "PASS" if report["passed"] else "FAIL",
        report["fsck"]["stores"], len(report["fsck"]["errors"]),
        args.report,
    )
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
