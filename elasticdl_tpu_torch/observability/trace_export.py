"""Chrome/Perfetto ``trace_event`` export + the ``trace`` CLI command
(port of elasticdl_tpu/observability/trace_export.py).

``chrome_trace`` turns collected span dicts into the Chrome trace-event
JSON that https://ui.perfetto.dev (and chrome://tracing) loads: one
**pid per (role, instance)** — master, each worker, each row-service
shard, serving — one **tid per real thread**, and one complete (``X``)
event per span with the span/trace ids and attributes in ``args``.
Timestamps are the spans' monotonic ``t0`` normalized to the earliest
span; that is exact within one process (the MiniCluster harness and
every test) and per-process-relative across real pods (each process's
monotonic clock has its own epoch — cross-process skew is not
corrected, which Perfetto tolerates and the critical-path report never
depends on, since trees are linked by ids, not timestamps).

The CLI runs a small traced MiniCluster job (the same in-process
harness the chaos plane drives): recorder on, deepfm-host model with
its table behind a real localhost ``HostRowService`` — so the exported
JSON contains task trees crossing master → worker → row-service — then
writes the Perfetto file and prints the ``critical_path`` straggler
report. ``python -m elasticdl_tpu_torch.tools.check_trace`` validates
the output. The job runs on the card unless ``--device cpu``.
"""

import json
import os
from typing import Dict, List, Optional, Tuple

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.observability import critical_path, tracing

logger = get_logger("trace_export")

DEFAULT_TRACE_PATH = "TRACE.json"


# ---- Chrome trace-event rendering ---------------------------------------


def _track_name(role: str, instance: str) -> str:
    return role if instance in ("", "0") else f"{role}/{instance}"


def chrome_trace(spans: List[dict]) -> dict:
    """Spans → ``{"traceEvents": [...]}`` (Perfetto-loadable)."""
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t_base = min(float(s.get("t0", 0.0)) for s in spans)
    pids: Dict[Tuple[str, str], int] = {}
    tids: Dict[Tuple[int, int], int] = {}
    events: List[dict] = []
    for s in spans:
        key = (str(s.get("role", "process")),
               str(s.get("instance", "0")))
        pid = pids.get(key)
        if pid is None:
            pid = pids[key] = len(pids) + 1
            events.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": _track_name(*key)},
            })
        tkey = (pid, int(s.get("tid", 0)))
        tid = tids.get(tkey)
        if tid is None:
            tid = 1 + sum(1 for k in tids if k[0] == pid)
            tids[tkey] = tid
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": f"thread-{tid}"},
            })
        args = {
            "trace_id": s.get("trace_id"),
            "span_id": s.get("span_id"),
            "parent_id": s.get("parent_id"),
        }
        attrs = s.get("attrs") or {}
        for name, value in attrs.items():
            args[str(name)] = value
        events.append({
            "ph": "X",
            "name": str(s.get("name", "span")),
            "cat": key[0],
            "ts": round((float(s.get("t0", 0.0)) - t_base) * 1e6, 3),
            "dur": round(float(s.get("dur", 0.0)) * 1e6, 3),
            "pid": pid,
            "tid": tid,
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome_trace(spans: List[dict], path: str) -> dict:
    """Write the Perfetto JSON for ``spans``; returns the trace dict."""
    trace = chrome_trace(spans)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(trace, fh, indent=1)
        fh.write("\n")
    logger.info(
        "wrote %d trace events to %s", len(trace["traceEvents"]), path
    )
    return trace


# ---- traced demo job ----------------------------------------------------

SPARSE_MODEL_DEF = "deepfm.deepfm_host.custom_model"
DENSE_MODEL_DEF = "mnist.mnist_functional.custom_model"


def run_traced_job(
    workdir: str,
    model: str = "sparse",
    num_workers: int = 2,
    records: int = 64,
    minibatch_size: int = 8,
    num_minibatches_per_task: int = 2,
    recorder_capacity: int = 16384,
    use_rpc: bool = True,
    device=None,
) -> List[dict]:
    """Run a MiniCluster job with the flight recorder installed and
    return every collected span (master TraceCollector ∪ process ring,
    deduped). ``sparse`` puts the embedding table behind a localhost
    ``HostRowService`` so pull spans cross a real RPC hop. ``device``
    as the cluster's (None = the card)."""
    if model not in ("sparse", "dense"):
        raise ValueError(f"unknown trace model flavor {model!r}")
    from elasticdl_tpu_torch.testing.cluster import MiniCluster
    from elasticdl_tpu_torch.testing.data import (
        create_frappe_record_file,
        create_mnist_record_file,
        model_zoo_dir,
    )

    os.makedirs(workdir, exist_ok=True)
    data_path = os.path.join(workdir, "train.rec")
    if not os.path.exists(data_path):
        if model == "sparse":
            create_frappe_record_file(data_path, records, seed=11)
        else:
            create_mnist_record_file(data_path, records, seed=11)

    recorder = tracing.FlightRecorder(capacity=recorder_capacity)
    tracing.install_recorder(recorder)
    services = []
    cluster = None
    try:
        runner_factory = None
        if model == "sparse":
            from elasticdl_tpu_torch.embedding import HostStepRunner
            from elasticdl_tpu_torch.embedding.row_service import (
                make_remote_engine,
            )
            from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host

            svc = deepfm_host.make_row_service()
            svc.start(tag="rowservice/0")
            services.append(svc)
            addr = f"localhost:{svc.port}"

            def runner_factory():
                # Synchronous applies: pulls/pushes happen on the worker
                # thread, so their RPC spans nest under the step span.
                return HostStepRunner(
                    make_remote_engine(
                        addr,
                        id_keys={
                            deepfm_host.TABLE_NAME:
                                deepfm_host.FEATURE_KEY
                        },
                    ),
                    async_apply=False,
                )

        cluster = MiniCluster(
            model_zoo=model_zoo_dir(),
            model_def=(
                SPARSE_MODEL_DEF if model == "sparse" else DENSE_MODEL_DEF
            ),
            training_data=data_path,
            minibatch_size=minibatch_size,
            num_minibatches_per_task=num_minibatches_per_task,
            num_workers=num_workers,
            use_rpc=use_rpc,
            step_runner_factory=runner_factory,
            metrics_report_secs=0.0,
            device=device,
        )
        cluster.run()
        # Piggybacked spans landed in the master collector; the process
        # ring still holds everything (one process) — merge and dedup.
        collector = tracing.TraceCollector(capacity=2 * recorder_capacity)
        collector.ingest(cluster.metrics_plane.trace_spans())
        collector.ingest(recorder.snapshot())
        return collector.spans()
    finally:
        tracing.uninstall_recorder()
        if cluster is not None:
            if cluster._server is not None:
                cluster._server.stop(0)
            cluster.stop()
        for svc in services:
            try:
                svc.stop(0)
            except Exception:
                pass


# ---- CLI ----------------------------------------------------------------


def main(argv=None) -> int:
    """``python -m elasticdl_tpu_torch trace <flags>``: run a traced
    in-process job, export Perfetto JSON, print the critical-path
    report."""
    import argparse
    import shutil
    import tempfile

    parser = argparse.ArgumentParser("elasticdl_tpu_torch-trace")
    parser.add_argument("--out", default=DEFAULT_TRACE_PATH,
                        help="Perfetto trace_event JSON output path")
    parser.add_argument("--report", default="",
                        help="Also write the critical-path report JSON "
                             "here (default: print text only)")
    parser.add_argument("--model", choices=["sparse", "dense"],
                        default="sparse")
    parser.add_argument("--num_workers", type=int, default=2)
    parser.add_argument("--records", type=int, default=64)
    parser.add_argument("--minibatch_size", type=int, default=8)
    parser.add_argument("--num_minibatches_per_task", type=int, default=2)
    parser.add_argument("--recorder_spans", type=int, default=16384,
                        help="Flight-recorder ring capacity")
    parser.add_argument("--in_process", action="store_true",
                        help="Direct servicer calls instead of "
                             "localhost gRPC (spans stay connected; "
                             "RPC client/server spans disappear)")
    parser.add_argument("--workdir", default="",
                        help="Scratch dir (default: fresh tempdir, "
                             "removed afterwards)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu; with no GPU the "
                             "default raises")
    args = parser.parse_args(argv)

    workdir = args.workdir
    cleanup = False
    if not workdir:
        workdir = tempfile.mkdtemp(prefix="edl_trace_")
        cleanup = True
    try:
        spans = run_traced_job(
            workdir,
            model=args.model,
            num_workers=args.num_workers,
            records=args.records,
            minibatch_size=args.minibatch_size,
            num_minibatches_per_task=args.num_minibatches_per_task,
            recorder_capacity=args.recorder_spans,
            use_rpc=not args.in_process,
            device=args.device,
        )
    finally:
        if cleanup:
            shutil.rmtree(workdir, ignore_errors=True)
    export_chrome_trace(spans, args.out)
    report = critical_path.analyze(spans)
    print(critical_path.render_report(report), end="")
    if args.report:
        with open(args.report, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
            fh.write("\n")
    print(f"trace written to {args.out} "
          f"({len(spans)} spans; open at https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
