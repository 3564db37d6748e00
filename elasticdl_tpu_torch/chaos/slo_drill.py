"""SLO-engine drill (port of elasticdl_tpu/chaos/slo_drill.py): an
injected row-RPC stall must page, a healthy run must not.

``python -m elasticdl_tpu_torch.chaos.slo_drill [--workdir DIR]
[--report PATH] [--device cpu]`` (exit 0 only if both halves hold; the
report defaults to ``<workdir>/SLO_DRILL.json``). The job's dense step
runs on the device (CUDA unless cpu is given), its rows in host RAM.

1. **Faulted run** — a MiniCluster deepfm-host job over a real
   localhost ``HostRowService`` with a chaos ``rpc_delay`` injected
   into every ``pull_rows`` handler (the slow-row-plane regime, server
   site so the client-observed ``edl_tpu_rpc_client_seconds`` attempt
   latency actually contains the stall). A burn-rate rule over that
   family must fire, and the ``IncidentRecorder`` must leave a
   black-box bundle that the port's ``tools/check_incident.py`` accepts
   (Perfetto-loadable trace, non-empty series window around the
   breach, critical-path attribution, journal tail).
2. **Healthy twin** — the identical job without the fault: ZERO rules
   may fire (an alert that pages on a healthy system is as broken as
   one that misses a stall — no flapping).

The drill runs ``MetricsPlane.slo_tick`` from its own thread exactly
the way the master run loop does, just on a faster cadence so the
whole loop fits in a smoke-test budget. Exits nonzero unless both
halves hold.
"""

import argparse
import json
import os
import sys
import threading
import time

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("slo_drill")

ROW_DELAY_SECS = 0.12
LATENCY_THRESHOLD = 0.05  # pull_rows bucket boundary: fast < 50ms < stalled


def drill_rule():
    """The burn-rate rule under test: 95% of row pulls must finish
    under LATENCY_THRESHOLD; windows shrunk so the smoke run breaches
    (and would clear) within seconds instead of SRE-scale minutes."""
    from elasticdl_tpu_torch.observability.slo import SLORule

    return SLORule(
        name="row-pull-latency-burn",
        kind="burn_rate",
        series="edl_tpu_rpc_client_seconds",
        labels={"service": "RowService", "method": "pull_rows"},
        latency_threshold=LATENCY_THRESHOLD,
        objective=0.95,
        long_window_secs=15.0,
        short_window_secs=3.0,
        burn_rate_threshold=3.0,
        min_count=5,
        description="row pulls slower than 50ms burning >3x the 5% "
                    "budget (injected stall must trip this)",
    )


def run_half(workdir: str, faulted: bool, records: int = 96,
             tick_secs: float = 0.1, cadence_secs: float = 0.25,
             device=None) -> dict:
    """One drill half; returns its verdict dict."""
    from elasticdl_tpu_torch.embedding.host_engine import HostStepRunner
    from elasticdl_tpu_torch.embedding.row_service import make_remote_engine
    from elasticdl_tpu_torch.observability import default_registry, tracing
    from elasticdl_tpu_torch.observability.slo import IncidentRecorder
    from elasticdl_tpu_torch.testing.cluster import MiniCluster
    from elasticdl_tpu_torch.testing.data import (
        create_frappe_record_file,
        model_zoo_dir,
    )
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host

    label = "faulted" if faulted else "healthy"
    half_dir = os.path.join(workdir, label)
    os.makedirs(half_dir, exist_ok=True)
    data_path = os.path.join(half_dir, "train.rec")
    create_frappe_record_file(data_path, records, seed=11)

    # Process-global state must start clean per half: the two halves
    # share one python process, and the faulted half's counters leaking
    # into the healthy twin would fake a breach.
    default_registry().reset()
    recorder = tracing.FlightRecorder(capacity=8192)
    tracing.install_recorder(recorder)

    injector = None
    if faulted:
        from elasticdl_tpu_torch.chaos.faults import FaultEvent, FaultPlan
        from elasticdl_tpu_torch.chaos.interceptors import FaultInjector

        plan = FaultPlan(events=[FaultEvent(
            kind="rpc_delay", target="RowService", method="pull_rows",
            site="server", at_call=0, probability=1.0, max_fires=0,
            delay_secs=ROW_DELAY_SECS,
        )], seed=7)
        injector = FaultInjector(plan).install()

    svc = None
    cluster = None
    ticker_stop = threading.Event()
    try:
        svc = deepfm_host.make_row_service()
        svc.start(tag="rowservice/0")
        addr = f"localhost:{svc.port}"

        def runner_factory():
            # Synchronous applies: pulls stay on the worker thread, so
            # every stalled pull is a step-path stall (the regime the
            # alert exists for).
            return HostStepRunner(
                make_remote_engine(addr, id_keys={
                    deepfm_host.TABLE_NAME: deepfm_host.FEATURE_KEY,
                }),
                async_apply=False,
            )

        cluster = MiniCluster(
            model_zoo=model_zoo_dir(),
            model_def="deepfm.deepfm_host.custom_model",
            training_data=data_path,
            minibatch_size=8,
            num_minibatches_per_task=2,
            num_workers=1,
            step_runner_factory=runner_factory,
            metrics_report_secs=0.0,
            journal_dir=os.path.join(half_dir, "journal"),
            device=device,
        )
        plane = cluster.metrics_plane
        plane.enable_timeseries(cadence_secs=cadence_secs)
        incident_dir = os.path.join(workdir, "incidents")
        engine = plane.enable_slo(
            rules=[drill_rule()],
            incident_recorder=IncidentRecorder(
                incident_dir,
                metrics_plane=plane,
                store=plane.timeseries,
                journal_tail_fn=cluster._journal.tail,
                window_secs=60.0,
            ),
        )

        # The master run-loop tick, sped up for the smoke budget.
        def tick_loop():
            while not ticker_stop.wait(tick_secs):
                try:
                    plane.slo_tick()
                except Exception:
                    logger.exception("slo tick failed")

        ticker = threading.Thread(
            target=tick_loop, daemon=True, name="slo-drill-tick"
        )
        ticker.start()
        t0 = time.monotonic()
        cluster.run()
        ticker_stop.set()
        ticker.join(timeout=5)
        # One final evaluation on the drained run's window.
        plane.timeseries.sample({
            "": (default_registry().snapshot(), None)
        })
        states = engine.evaluate()
        elapsed = time.monotonic() - t0

        rule_state = engine.alert_state("row-pull-latency-burn")
        bundles = []
        if engine.incident_recorder is not None:
            # Captures write on a background thread; barrier before
            # the schema check reads the bundle.
            engine.incident_recorder.flush()
            bundles = engine.incident_recorder.bundles
        return {
            "label": label,
            "finished": cluster.finished,
            "elapsed_secs": round(elapsed, 3),
            "fired_count": rule_state["fired_count"],
            "final_states": states,
            "bundles": bundles,
            "samples": plane.timeseries.sample_count,
            "injected": len(injector.injected) if injector else 0,
        }
    finally:
        ticker_stop.set()
        tracing.uninstall_recorder()
        if injector is not None:
            injector.uninstall()
        if cluster is not None:
            if cluster._server is not None:
                cluster._server.stop(0)
            cluster.stop()
        if svc is not None:
            try:
                svc.stop(0)
            except Exception:
                pass


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("elasticdl_tpu_torch-slo-drill")
    parser.add_argument("--workdir", default="",
                        help="Scratch dir; the incident bundle lands "
                             "in <workdir>/incidents (default: fresh "
                             "tempdir, kept only on failure)")
    parser.add_argument("--report", default="",
                        help="default: <workdir>/SLO_DRILL.json, or "
                             "./slo_drill.json with no --workdir")
    parser.add_argument("--records", type=int, default=96)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from elasticdl_tpu_torch.common.device import resolve_device

    device = resolve_device(args.device)

    import shutil
    import tempfile

    workdir = args.workdir
    cleanup = False
    if not workdir:
        workdir = tempfile.mkdtemp(prefix="edl_slo_")
        cleanup = True
    report_path = args.report or (
        os.path.join(args.workdir, "SLO_DRILL.json") if args.workdir
        else "slo_drill.json")

    failures = []
    faulted = run_half(workdir, faulted=True, records=args.records,
                       device=device)
    if not faulted["finished"]:
        failures.append("faulted: job did not drain")
    if faulted["fired_count"] < 1:
        failures.append(
            "faulted: burn-rate rule never fired under the injected "
            f"stall ({faulted['injected']} delays injected)"
        )
    if not faulted["bundles"]:
        failures.append("faulted: no incident bundle written")
    else:
        from elasticdl_tpu_torch.tools.check_incident import (
            check_incident,
        )

        for err in check_incident(faulted["bundles"][0]):
            failures.append(f"faulted bundle: {err}")

    healthy = run_half(workdir, faulted=False, records=args.records,
                       device=device)
    if not healthy["finished"]:
        failures.append("healthy: job did not drain")
    if healthy["fired_count"] != 0:
        failures.append(
            "healthy twin FIRED the burn-rate rule "
            f"({healthy['fired_count']}x) — flapping alert"
        )

    report = {
        "ok": not failures,
        "failures": failures,
        "faulted": faulted,
        "healthy": healthy,
        "workdir": workdir,
    }
    with open(report_path, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True)
        fh.write("\n")
    for failure in failures:
        logger.error("SLO drill failure: %s", failure)
    logger.info(
        "SLO drill %s: faulted fired %dx (%d bundles), healthy fired "
        "%dx; report %s",
        "PASS" if not failures else "FAIL",
        faulted["fired_count"], len(faulted["bundles"]),
        healthy["fired_count"], report_path,
    )
    if cleanup and not failures:
        shutil.rmtree(workdir, ignore_errors=True)
    elif cleanup:
        logger.warning("keeping %s for inspection", workdir)
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
