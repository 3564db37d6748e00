"""Continuous-profiling drill (port of
elasticdl_tpu/chaos/profile_drill.py): an injected hot function must
dominate the flame table and appear in the alert-triggered incident
bundle.

``python -m elasticdl_tpu_torch.chaos.profile_drill [--workdir DIR]
[--report PATH]`` (exit 0 only if every gate holds; the report defaults
to ``<workdir>/PROFILE_DRILL.json``) — a REAL two-process run, host
only (the row service's rows live in host RAM):

1. **Overhead pin** — the sampling profiler's per-pass cost × the
   default rate must stay ≤ 1% of one core (a wall-clock gate; the
   CPU tests hold the deterministic gates,
   tests/test_torch_chaos_obs_drills.py).
2. **Two-process flame capture** — a real
   ``python -m elasticdl_tpu_torch.embedding.row_service`` subprocess runs a
   drill model-zoo module whose optimizer calls a named busy-spin
   (``_drill_hot_spin``) on every push, with ``--profile_hz 67``,
   ``--flight_recorder`` and ``--master_addr`` pointing at this
   process's master-servicer stand-in. The drill pushes gradients over
   real gRPC; the shard's flame windows, spans, and exemplar-stamped
   push histogram piggyback back on ``report_metrics``. Gates:

   - the hot function DOMINATES the shard's flame table (heaviest
     handler-class leaf, ≥ ``DOMINANCE_GATE`` of handler samples);
   - a threshold SLO rule over ``edl_tpu_row_service_push_seconds``
     fires, and its incident bundle passes the port's
     ``tools/check_incident.py --require-profile --require-exemplars``:
     a valid profile snapshot (``tools/check_profile.py`` accepts it)
     carrying the hot
     function, plus ≥ 1 exemplar trace id that resolves to a span in
     the bundle's ``trace.json``.

Exits nonzero unless every gate holds.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("profile_drill")

OVERHEAD_GATE = 0.01        # profiler <= 1% of a busy loop at 67 Hz
DOMINANCE_GATE = 0.30       # hot fn share of handler-class samples
HOT_FN = "_drill_hot_spin"
PUSH_LATENCY_GATE = 0.005   # rule: p99 push > 5ms (hot spin is ~25ms)

ZOO_MODULE = '''\
"""Drill-owned model zoo: a row service whose optimizer burns a named
hot function on every push (written by chaos/profile_drill.py)."""

import time

from elasticdl_tpu_torch.embedding.optimizer import SGD, HostOptimizerWrapper
from elasticdl_tpu_torch.embedding.row_service import HostRowService
from elasticdl_tpu_torch.embedding.table import EmbeddingTable

HOT_MS = 25.0


def _drill_hot_spin(budget_ms=HOT_MS):
    deadline = time.perf_counter() + budget_ms / 1e3
    acc = 0
    while time.perf_counter() < deadline:
        acc += 1
    return acc


class _HotOptimizer(HostOptimizerWrapper):
    def apply_gradients(self, table, ids, grads):
        _drill_hot_spin()
        return super().apply_gradients(table, ids, grads)


def make_row_service():
    table = EmbeddingTable("drill", 8)
    return HostRowService({"drill": table}, _HotOptimizer(SGD(0.1)))
'''


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def measure_overhead(passes: int = 300,
                     resident_threads: int = 6) -> dict:
    """Phase 1: per-pass sampling cost, projected to the default rate.

    Measured against RESIDENT threads parked in waits (deep stacks to
    walk, no GIL contention): a pass's true cost is its walk time —
    time a sampler spends waiting for a busy worker thread to release
    the GIL is time the worker spends doing its own work, not profiler
    overhead. Best-of-3 rounds damp scheduler noise."""
    from elasticdl_tpu_torch.observability.profiler import (
        DEFAULT_HZ,
        SamplingProfiler,
    )

    stop = threading.Event()

    def parked(depth=12):
        if depth:
            return parked(depth - 1)
        stop.wait()

    threads = [
        threading.Thread(target=parked, daemon=True)
        for _ in range(resident_threads)
    ]
    for t in threads:
        t.start()
    prof = SamplingProfiler(hz=DEFAULT_HZ, window_secs=3600.0)
    try:
        for _ in range(20):  # warm the frame-name cache
            prof.sample()
        per_pass = float("inf")
        for _round in range(3):
            t0 = time.perf_counter()
            for _ in range(passes):
                prof.sample()
            per_pass = min(
                per_pass, (time.perf_counter() - t0) / passes
            )
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=2.0)
    return {
        "passes": passes,
        "resident_threads": resident_threads,
        "per_pass_secs": per_pass,
        "hz": DEFAULT_HZ,
        "overhead_fraction": per_pass * DEFAULT_HZ,
        "gate": OVERHEAD_GATE,
        "ok": per_pass * DEFAULT_HZ <= OVERHEAD_GATE,
    }


def drill_rule():
    from elasticdl_tpu_torch.observability.slo import SLORule

    return SLORule(
        name="row-push-slow",
        kind="threshold",
        series="edl_tpu_row_service_push_seconds",
        source="rowservice-0",
        aggregation="p99",
        op=">",
        value=PUSH_LATENCY_GATE,
        window_secs=60.0,
        min_count=5,
        description="push handler p99 above 5ms — the injected hot "
                    "function must trip this",
    )


def _hot_share(samples: dict) -> dict:
    """Hot-function dominance over the handler (pool) thread class:
    share of pool samples whose stack contains the hot function, and
    whether it is the heaviest pool leaf."""
    pool_total = 0
    hot_total = 0
    leaf_counts = {}
    for stack, count in samples.items():
        if not stack.startswith("pool;"):
            continue
        pool_total += count
        if HOT_FN in stack:
            hot_total += count
        leaf = stack.rsplit(";", 1)[-1]
        leaf_counts[leaf] = leaf_counts.get(leaf, 0) + count
    heaviest_leaf = max(
        leaf_counts.items(), key=lambda kv: kv[1]
    )[0] if leaf_counts else ""
    share = hot_total / pool_total if pool_total else 0.0
    return {
        "pool_samples": pool_total,
        "hot_samples": hot_total,
        "share": round(share, 4),
        "heaviest_pool_leaf": heaviest_leaf,
        "gate": DOMINANCE_GATE,
        "ok": bool(
            share >= DOMINANCE_GATE and HOT_FN in heaviest_leaf
        ),
    }


def run_two_process(workdir: str, timeout_secs: float = 120.0) -> dict:
    """Phase 2: the real two-process capture + alert loop."""
    from elasticdl_tpu_torch.comm.rpc import (
        RpcServer,
        RpcStub,
        wait_for_channel_ready,
    )
    from elasticdl_tpu_torch.observability import MetricsPlane
    from elasticdl_tpu_torch.observability.slo import IncidentRecorder

    from elasticdl_tpu_torch.tools.check_incident import check_incident

    zoo_dir = os.path.join(workdir, "zoo")
    os.makedirs(zoo_dir, exist_ok=True)
    with open(
        os.path.join(zoo_dir, "profile_drill_zoo.py"), "w"
    ) as fh:
        fh.write(ZOO_MODULE)
    incidents_dir = os.path.join(workdir, "incidents")

    # The master-servicer stand-in: exactly the report_metrics fold-in
    # a real master does (servicer.py), minus the job plumbing the
    # drill doesn't need.
    plane = MetricsPlane(ttl_secs=120.0)
    plane.enable_timeseries(cadence_secs=0.5)

    def report_metrics(request: dict) -> dict:
        component = str(request.get("component", "") or "component")
        component_id = int(request.get("component_id", 0))
        snapshot = request.get("metrics")
        if snapshot:
            plane.ingest(f"{component}-{component_id}", snapshot)
        return {"accepted": True}

    master = RpcServer(
        "localhost:0",
        {"elasticdl_tpu.Master": {"report_metrics": report_metrics}},
    ).start()

    row_port = _free_port()
    row_addr = f"localhost:{row_port}"
    child = subprocess.Popen(
        [
            sys.executable, "-m", "elasticdl_tpu_torch.embedding.row_service",
            "--model_zoo", zoo_dir,
            "--model_def", "profile_drill_zoo.make_row_service",
            "--addr", row_addr,
            "--profile_hz", "67",
            "--profile_window_secs", "2",
            "--flight_recorder", "8192",
            "--master_addr", f"localhost:{master.port}",
            "--metrics_report_secs", "1",
        ],
        # The package root: the drill runs from anywhere.
        cwd=os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
    )
    verdict = {
        "row_addr": row_addr,
        "pushes": 0,
        "fired": False,
        "bundle": None,
        "bundle_errors": None,
        "dominance": None,
        "exemplar_resolved": False,
        "hot_in_bundle_profile": False,
        "ok": False,
    }
    stub = None
    try:
        channel = wait_for_channel_ready(row_addr, timeout=90.0)
        stub = RpcStub(channel, "RowService")
        ids = np.arange(16, dtype=np.int64)
        grads = np.full((16, 8), 0.01, np.float32)
        deadline = time.monotonic() + timeout_secs
        seq = 0

        def push():
            nonlocal seq
            stub.call(
                "push_row_grads", table="drill", ids=ids,
                grads=grads, client="profile-drill", seq=seq,
                timeout=30.0,
            )
            seq += 1

        # Warm-up: pump pushes until the shard's profile windows,
        # spans, AND exemplar-carrying histogram snapshot have all
        # ridden report_metrics back — only then arm the SLO engine,
        # so the bundle captured at the firing transition is complete
        # (a real master is armed from minute zero and simply fires
        # later; the drill compresses that timeline).
        def shard_telemetry_ready() -> bool:
            merged = plane.profiles.merged(
                "rowservice-0", window_secs=300.0
            )
            if merged is None or merged["sample_count"] < 100:
                return False
            # The windows that arrived must already SHOW the hot work
            # (the shard's first window closes during idle startup —
            # gating on mere sample counts would arm the rule against
            # a pre-push flame table).
            hot = sum(
                count for stack, count in merged["samples"].items()
                if HOT_FN in stack
            )
            if hot < 50:
                return False
            if len(plane.traces) == 0:
                return False
            for snap in plane.cluster.snapshots().values():
                for family in snap.get("families", []):
                    if family.get(
                        "name"
                    ) == "edl_tpu_row_service_push_seconds" and any(
                        s.get("exemplars")
                        for s in family.get("series", [])
                    ):
                        return True
            return False

        while time.monotonic() < deadline:
            push()
            plane.slo_tick()
            if shard_telemetry_ready():
                break
        else:
            raise RuntimeError(
                "shard telemetry (profiles/spans/exemplars) never "
                "reached the master stand-in"
            )
        verdict["pushes"] = seq

        recorder = IncidentRecorder(
            incidents_dir,
            metrics_plane=plane,
            store=plane.timeseries,
            background=False,
        )
        plane.enable_slo(
            rules=[drill_rule()], incident_recorder=recorder
        )
        while time.monotonic() < deadline:
            push()
            plane.slo_tick()
            if plane.slo.firing():
                break
        verdict["pushes"] = seq
        verdict["fired"] = bool(plane.slo and plane.slo.firing())
        if not verdict["fired"]:
            raise RuntimeError("SLO rule never fired")
        if not recorder.bundles:
            raise RuntimeError("rule fired but no bundle captured")
        bundle = recorder.bundles[-1]
        verdict["bundle"] = bundle

        # Gate: the bundle is the full black box — valid profile
        # snapshot AND >=1 exemplar trace id resolving in trace.json.
        errors = check_incident(
            bundle, require_profile=True, require_exemplars=True
        )
        verdict["bundle_errors"] = errors

        # Gate: the hot function dominates the shard's flame table.
        body = plane.profiles.render(
            "rowservice-0", window_secs=300.0
        )
        samples = (body.get("window") or {}).get("samples") or {}
        verdict["dominance"] = _hot_share(samples)

        # And appears in the bundle's captured profile too.
        with open(os.path.join(bundle, "profile.json")) as fh:
            bundle_profile = json.load(fh)
        shard_entry = (
            bundle_profile.get("components", {}).get("rowservice-0")
        )
        verdict["hot_in_bundle_profile"] = bool(
            shard_entry and HOT_FN in shard_entry.get("folded", "")
        )
        with open(os.path.join(bundle, "exemplars.json")) as fh:
            verdict["exemplar_count"] = len(
                json.load(fh).get("exemplars", [])
            )
        verdict["exemplar_resolved"] = not any(
            "exemplars.json" in e for e in errors
        )
        verdict["ok"] = bool(
            not errors
            and verdict["dominance"]["ok"]
            and verdict["hot_in_bundle_profile"]
        )
        return verdict
    finally:
        if stub is not None:
            try:
                stub.close()
            except Exception:
                pass
        child.terminate()
        try:
            child.wait(timeout=15.0)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait(timeout=15.0)
        master.stop(0)
        plane.stop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("elasticdl_tpu_torch-profile-drill")
    parser.add_argument("--workdir", default="",
                        help="Scratch dir (default: a tempdir)")
    parser.add_argument("--report", default="",
                        help="default: <workdir>/PROFILE_DRILL.json")
    parser.add_argument("--timeout", type=float, default=120.0)
    args = parser.parse_args(argv)

    workdir = args.workdir
    if not workdir:
        import tempfile

        workdir = tempfile.mkdtemp(prefix="edl_profile_drill_")
    args.report = args.report or os.path.join(workdir,
                                              "PROFILE_DRILL.json")

    logger.info("phase 1: profiler overhead pin")
    overhead = measure_overhead()
    logger.info(
        "profiler overhead: %.3f%% of one core at %g Hz (gate %.0f%%)",
        100.0 * overhead["overhead_fraction"], overhead["hz"],
        100.0 * OVERHEAD_GATE,
    )

    logger.info("phase 2: two-process hot-function capture")
    try:
        capture = run_two_process(workdir, timeout_secs=args.timeout)
    except Exception as exc:
        logger.exception("two-process capture failed")
        capture = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}

    report = {
        "overhead": overhead,
        "capture": capture,
        "ok": bool(overhead["ok"] and capture.get("ok")),
    }
    with open(args.report, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True, default=str)
        fh.write("\n")
    if report["ok"]:
        dom = capture.get("dominance") or {}
        logger.info(
            "PROFILE DRILL PASS: hot fn %.0f%% of handler samples "
            "(heaviest leaf %s), bundle %s valid with %d exemplars",
            100.0 * dom.get("share", 0.0),
            dom.get("heaviest_pool_leaf"),
            capture.get("bundle"), capture.get("exemplar_count", 0),
        )
        return 0
    logger.error("PROFILE DRILL FAIL: %s",
                 json.dumps(report, indent=2, default=str))
    return 1


if __name__ == "__main__":
    sys.exit(main())
