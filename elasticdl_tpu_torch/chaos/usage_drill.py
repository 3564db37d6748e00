"""Workload-attribution drill (port of
elasticdl_tpu/chaos/usage_drill.py): principal tags must survive a
live reshard, and metering must stay effectively free.

``python -m elasticdl_tpu_torch.chaos.usage_drill --workdir DIR
[--report PATH]`` (exit 0 only if every gate holds; the report defaults
to ``DIR/USAGE_DRILL.json``). Host only: the rows live in host RAM.

Two byte-identical runs of the same seeded push schedule against a
2-shard row fleet that splits live onto a third shard mid-run (with
hot-row replica designation, so pushes fan out replica refreshes):

1. **Baseline** — attribution disabled via the
   ``principal.set_enabled(False)`` kill-switch: no ``_principal``
   piggyback on the wire, no usage metering server-side. Every push
   is timed.
2. **Attributed** — attribution on, the runner process tagged via
   ``principal.set_process_principal(job="drill",
   component="worker", purpose="training")`` (the remote engine
   fans pushes out on worker threads, so the process default — not
   a thread-local push — is what reaches the wire, exactly as in
   ``worker/main.py``). Same pushes, same pulls, same split.

Gates (all three must hold, else exit nonzero):

- **Purity** — internal fan-outs re-tag themselves, so in the
  process-wide registry every ``usage_bytes_total`` series for the
  ``ingest_rows`` method carries ``purpose="migration"`` and every
  ``replica_refresh`` series carries ``purpose="replica_refresh"``
  — training traffic NEVER pays for migration or replica bytes.
  Both purposes must also actually appear with nonzero bytes (the
  drill really exercised a split and refreshes).
- **Coverage** — ``summarize_usage`` reports at least
  ``SHARE_GATE`` (95%) of handler wall-time attributed to a
  non-``unknown`` purpose.
- **Overhead** — p99 push latency with attribution on is at most
  ``P99_GATE`` (1.05x) the attribution-off baseline. The pair of
  runs is re-measured once before failing, damping scheduler noise
  the way ``profile_drill.measure_overhead`` does with best-of-3.

The drill's shards share one process registry, so the purity and
coverage gates are process-wide; per-shard top-K attribution (the
``/usage`` endpoint's ``shards`` block) is covered by unit tests
over ``MetricsPlane`` ingest. Report is validated by
``elasticdl_tpu_torch/tools/check_usage.py``. The overhead gate reads
wall time; the CPU tests hold the deterministic gates
(``tests/test_torch_chaos_row_drills.py``).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("usage_drill")

TABLE = "drill_rows"
DIM = 8
PUSHES = 240
PUSH_IDS = 48
ID_SPACE = 1_000_000
HOT_IDS = 6
SPLIT_AT = 120        # push index before the 2 -> 3 split
WARMUP = 20           # pushes excluded from latency samples
P99_GATE = 1.05       # attributed p99 <= 1.05x baseline p99
SHARE_GATE = 0.95     # >= 95% of handler time non-unknown
LATENCY_ATTEMPTS = 2  # re-measure the pair once before failing


def _schedule(seed: int):
    """Seeded (ids, grads) per push — uniform ids plus a pinned hot
    set so replica designation has a signal. Identical across the
    baseline and attributed runs."""
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


def _build_shard(port: int = 0):
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
    # No checkpoint/WAL: this drill measures attribution overhead on
    # the pure push path; durability planes have their own drills.
    return svc.start(f"localhost:{port}")


class _Fleet:
    """One run's shards + reshard authority + client."""

    def __init__(self, workdir: str, run: str):
        from elasticdl_tpu_torch.master.row_reshard import (
            ReshardPolicy,
            ShardMapController,
        )

        self.shards = [_build_shard() for _ in range(2)]
        self.state_path = os.path.join(workdir, run, "shard_map.json")
        os.makedirs(os.path.dirname(self.state_path), exist_ok=True)
        self.controller = ShardMapController(
            self.state_path,
            policy=ReshardPolicy(replica_min_pulls=2,
                                 replica_top_k=HOT_IDS,
                                 replica_count=1),
        )
        self.controller.bootstrap(
            [f"localhost:{s.port}" for s in self.shards]
        )
        self.engine = None

    def client(self):
        from elasticdl_tpu_torch.embedding.row_service import (
            make_remote_engine,
        )

        if self.engine is None:
            self.engine = make_remote_engine(
                ",".join(f"localhost:{s.port}" for s in self.shards),
                id_keys={TABLE: "ids"}, retries=6, backoff_secs=0.1,
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
        svc = _build_shard()
        self.shards.append(svc)
        return f"localhost:{svc.port}"

    def stop(self):
        self.controller.close()
        if self.engine is not None:
            self.engine.close()
        for svc in self.shards:
            try:
                svc.stop(0)
            except Exception:
                pass


def _run_once(workdir: str, run: str, hot, schedule):
    """Drive the full scripted run (pushes, hot pulls, replica
    designation, live 2 -> 3 split, more pushes) and return per-push
    latencies past the warmup."""
    fleet = _Fleet(workdir, run)
    samples = []
    try:
        for seq in range(SPLIT_AT):
            ids, grads = schedule[seq]
            t0 = time.monotonic()
            fleet.push(ids, grads)
            if seq >= WARMUP:
                samples.append(time.monotonic() - t0)
        for _ in range(4):
            fleet.pull(hot)  # hot signal for replica designation
        fleet.controller.update_replicas()
        fleet.controller.split(0, new_addr=fleet.add_shard())
        for seq in range(SPLIT_AT, PUSHES):
            ids, grads = schedule[seq]
            t0 = time.monotonic()
            fleet.push(ids, grads)
            samples.append(time.monotonic() - t0)
    finally:
        fleet.stop()
    return samples


def _measure_pair(workdir: str, attempt: int, hot, schedule):
    """One baseline run (attribution off) + one attributed run, same
    schedule. Returns (p99_off, p99_on, usage snapshot gates' raw
    registry snapshot is taken by the caller)."""
    from elasticdl_tpu_torch.observability import principal

    prev = principal.set_enabled(False)
    try:
        off = _run_once(workdir, f"baseline{attempt}", hot, schedule)
    finally:
        principal.set_enabled(prev)

    principal.set_enabled(True)
    # Process-wide default, not a thread-local push: the remote
    # engine fans pushes out on worker threads, and only the process
    # default reaches them — the same mechanism real workers use
    # (ELASTICDL_JOB_NAME in worker/main.py).
    principal.set_process_principal(job="drill", component="worker",
                                    purpose="training")
    try:
        on = _run_once(workdir, f"attributed{attempt}", hot, schedule)
    finally:
        principal.set_process_principal()
    return (float(np.percentile(off, 99)),
            float(np.percentile(on, 99)))


def _series_by_method(snapshot: dict, family: str):
    """{method: sorted purposes seen}, plus total value per method."""
    purposes = {}
    totals = {}
    for fam in snapshot.get("families", []):
        if fam.get("name") != family:
            continue
        names = fam.get("labelnames", [])
        for series in fam.get("series", []):
            labels = dict(zip(names, series.get("labels", [])))
            method = labels.get("method", "")
            purposes.setdefault(method, set()).add(
                labels.get("purpose", "")
            )
            totals[method] = totals.get(method, 0.0) + float(
                series.get("value", 0.0)
            )
    return (
        {m: sorted(v) for m, v in purposes.items()},
        totals,
    )


def _purity_gate(snapshot: dict) -> dict:
    """Migration and replica-refresh bytes live ONLY under their own
    purposes — and both actually flowed."""
    purposes, totals = _series_by_method(
        snapshot, "edl_tpu_usage_bytes_total"
    )
    problems = []
    for method, want in (("ingest_rows", "migration"),
                         ("replica_refresh", "replica_refresh")):
        seen = purposes.get(method, [])
        if seen != [want]:
            problems.append(
                f"{method} bytes metered under purposes {seen}, "
                f"want only ['{want}']"
            )
        if totals.get(method, 0.0) <= 0:
            problems.append(f"no {method} bytes flowed — the drill "
                            "did not exercise that path")
    return {
        "purposes_by_method": purposes,
        "bytes_by_method": totals,
        "problems": problems,
        "ok": not problems,
    }


def run_drill(workdir: str, seed: int) -> dict:
    from elasticdl_tpu_torch.observability.registry import default_registry
    from elasticdl_tpu_torch.observability.usage import summarize_usage

    hot, schedule = _schedule(seed)
    report = {
        "drill": "workload_attribution",
        "seed": seed,
        "config": {
            "table": TABLE, "dim": DIM, "pushes": PUSHES,
            "push_ids": PUSH_IDS, "id_space": ID_SPACE,
            "split_at": SPLIT_AT, "hot_ids": HOT_IDS,
            "warmup": WARMUP,
        },
        "problems": [],
    }

    # Latency gate: re-measure the whole pair once before failing —
    # a single noisy p99 on a shared box must not flunk the drill.
    attempts = []
    ok = False
    for attempt in range(LATENCY_ATTEMPTS):
        p99_off, p99_on = _measure_pair(workdir, attempt, hot,
                                        schedule)
        ratio = p99_on / p99_off if p99_off > 0 else float("inf")
        attempts.append({
            "p99_baseline_s": p99_off,
            "p99_attributed_s": p99_on,
            "ratio": ratio,
        })
        logger.info(
            "attempt %d: p99 off %.3fms on %.3fms ratio %.3f "
            "(gate %.2f)", attempt, 1e3 * p99_off, 1e3 * p99_on,
            ratio, P99_GATE,
        )
        if ratio <= P99_GATE:
            ok = True
            break
    report["latency"] = {
        "attempts": attempts, "gate": P99_GATE, "ok": ok,
    }
    if not ok:
        report["problems"].append(
            f"attributed p99 exceeded {P99_GATE}x baseline in all "
            f"{LATENCY_ATTEMPTS} attempts: "
            f"{[round(a['ratio'], 3) for a in attempts]}"
        )

    # Purity + coverage gates over the process-wide registry (all
    # this drill's shards share it; counters are cumulative across
    # attempts, which only adds more of the same traffic).
    snapshot = default_registry().snapshot()
    purity = _purity_gate(snapshot)
    report["purity"] = purity
    report["problems"].extend(purity["problems"])

    usage = summarize_usage({"proc": snapshot}, top_k=5)
    share = float(usage.get("attributed_handler_share", 0.0))
    report["attribution"] = {
        "attributed_handler_share": share,
        "gate": SHARE_GATE,
        "ok": share >= SHARE_GATE,
    }
    if share < SHARE_GATE:
        report["problems"].append(
            f"only {share:.3f} of handler time attributed "
            f"(gate {SHARE_GATE})"
        )
    report["usage"] = usage
    report["passed"] = not report["problems"]
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("elasticdl_tpu_torch-usage-drill")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--report", default="",
                        help="default: <workdir>/USAGE_DRILL.json")
    args = parser.parse_args(argv)
    args.report = args.report or os.path.join(args.workdir,
                                              "USAGE_DRILL.json")

    report = run_drill(args.workdir, args.seed)
    with open(args.report, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True, default=str)
        fh.write("\n")
    logger.info(
        "usage drill: %s (share %.3f, p99 ratio %.3f); report %s",
        "PASS" if report["passed"] else "FAIL",
        report["attribution"]["attributed_handler_share"],
        report["latency"]["attempts"][-1]["ratio"],
        args.report,
    )
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
