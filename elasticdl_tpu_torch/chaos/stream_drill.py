"""Streaming ingestion drill (port of
elasticdl_tpu/chaos/stream_drill.py): kill a worker AND a row shard in
one window and require the train→serve loop to close anyway.

``python -m elasticdl_tpu_torch.chaos.stream_drill run --workdir DIR
[--report PATH]`` (exit 0 only if every gate holds):

1. **Kill drill** — a live ``data/stream.py`` file-tail stream (two
   partitions, appended throughout the run) feeds a streaming-mode
   master (real ``MasterJournal`` + ``TaskDispatcher(streaming=True)``
   + ``StreamIngestor`` + ``MasterServicer`` over localhost gRPC) whose
   tasks are trained by REAL worker subprocesses pushing row grads into
   the quake drill's REAL 2-shard row-service fleet (durable-ack WAL).
   Mid-run — in ONE window — the drill SIGKILLs a worker, SIGKILLs a
   row shard, and crashes the master. The dead shard's WAL is fsck'd,
   everything relaunches, and the recovered master must resume from
   the **journaled watermark** (never below what was committed, never
   re-acking an offset). Gates:

   - **read-your-writes** — every offset committed before the kills
     is visible to serving (non-zero rows on pull) right after the
     relaunch, before the pipeline finishes catching up;
   - **byte-equal** — the final row fleet (rows + optimizer slots)
     matches a kill-free twin that consumed the same stream: each
     stream offset maps to a unique row id pushed exactly once with a
     deterministic ``(client, seq)``, so a lost or double-applied push
     cannot hide (Adam's step counters diverge);
   - **watermarks** — final committed == appended end per partition,
     no pending (uncommitted) ranges, and a cold fold of the journal's
     STREAM/REPORT records agrees with the live dispatcher;
   - **fsck** — master journal + every WAL (including the dead
     incarnation's, checked BEFORE relaunch touches it) come back
     clean.

2. **Coexistence** — the streaming job enters the gang scheduler's
   job table like any tenant (``spec={"stream": True}`` through the
   default dispatcher factory): a higher-priority batch job arrives
   mid-stream, preempts the streaming gang, runs to completion, and
   yields back. The watermark must be monotone across the preemption,
   every stream offset applied exactly once, and the paused ingestor's
   backpressure meter must have ticked while the todo queue sat full.

One difference from the JAX drill: the writer appends a whole task's
records to each partition at a time, and the drill master's pump runs
under the writer's lock, so both runs split the stream into the same
tasks. The JAX drill pumps on the ingestor's own thread, whose passes
may land between single appends; its split then follows thread timing,
and so do the shards' push counts and optimizer step counters that the
byte-equality gate compares (JAX workers, slow to import, leave the
todo queue full while the writer runs, which hides it; the port's fast
workers showed it).

Report: ``STREAM_DRILL.json``, validated by
``elasticdl_tpu_torch/tools/check_stream.py`` (offset contiguity,
watermark bounds, journal-vs-live coverage).
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List

import numpy as np

from elasticdl_tpu_torch.chaos.quake_drill import (
    TABLE,
    DIM,
    RowFleet,
    _capture_shard,
    _call_shard,
    _free_ports,
    _fsck_log,
    _pkg_root,
    _tables_equal,
    _wait_shard,
)
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("stream_drill")

PARTITIONS = ("clicks", "views")
RECORDS_PER_PARTITION = 96
RECORDS_PER_TASK = 4
KILL_AT_COMMITTED = 48       # total committed records before the kills
MAX_TODO = 6                 # ingestor backpressure bound
NUM_WORKERS = 2
NUM_SHARDS = 2
ID_STRIDE = 40               # spreads ids across the 8192-bucket space
WORK_GRACE = 60.0            # worker ride-out for master/shard outages
DRILL_DEADLINE = 240.0

# Coexistence scenario sizing.
CO_STREAM_RECORDS = 64
CO_BATCH_TASKS = 6
CO_ROWS_PER_TASK = 4
CO_PREEMPT_AT = 16           # stream records committed before batch job
CO_MAX_STEPS = 2000


def _record_id(partition: str, offset: int) -> int:
    """One UNIQUE row id per stream offset: final table state is then
    order-independent even under Adam (each row sees exactly one
    update), so the kill run and its kill-free twin must land
    byte-equal."""
    p = PARTITIONS.index(partition)
    return (offset * len(PARTITIONS) + p) * ID_STRIDE + 7


def _grad_row(rid: int) -> List[float]:
    return [float((rid + j) % 23 + 1) for j in range(DIM)]


def _shard_of(rid: int, nshards: int) -> int:
    from elasticdl_tpu_torch.embedding.shard_map import NUM_BUCKETS

    return (int(rid) % NUM_BUCKETS) * nshards // NUM_BUCKETS


# ---- `work` subcommand: one real streaming worker -------------------------


def _work(args) -> int:
    """Worker subprocess: lease stream tasks from the master, read the
    offset range from the SAME file tail, push each record's row grad
    to its home shard with a deterministic ``(client, seq)`` (a
    relaunched worker re-pushing a requeued task dedups server-side),
    then report. Rides out master/shard outages for ``--grace``."""
    from elasticdl_tpu_torch.comm.rpc import RpcStub
    from elasticdl_tpu_torch.data.stream import FileTailStream
    from elasticdl_tpu_torch.embedding.row_service import (
        SERVICE_NAME as ROW_SERVICE,
    )
    from elasticdl_tpu_torch.master.servicer import (
        SERVICE_NAME as MASTER_SERVICE,
    )

    source = FileTailStream(args.stream_dir)
    ports = [int(p) for p in args.shards.split(",")]
    master = RpcStub(args.master_addr, MASTER_SERVICE, max_retries=0)
    outage_deadline = [None]

    def call_master(method, **fields):
        while True:
            try:
                resp = master.call(method, timeout=5.0, **fields)
                outage_deadline[0] = None
                return resp
            except Exception as exc:
                now = time.monotonic()
                if outage_deadline[0] is None:
                    outage_deadline[0] = now + args.grace
                if now >= outage_deadline[0]:
                    raise TimeoutError(
                        f"master unreachable for {args.grace}s: {exc}"
                    )
                time.sleep(0.2)
                try:
                    master.reconnect()
                except Exception:
                    pass

    def push_shard(shard: int, ids, grads, client: str):
        stop_at = time.monotonic() + args.grace
        while True:
            stub = RpcStub(
                f"localhost:{ports[shard]}", ROW_SERVICE, max_retries=2
            )
            try:
                return stub.call(
                    "push_row_grads", timeout=10.0, table=TABLE,
                    ids=ids, grads=grads, client=client, seq=1,
                )
            except Exception:
                if time.monotonic() >= stop_at:
                    raise
                time.sleep(0.25)
            finally:
                stub.close()

    while True:
        resp = call_master("get_task", worker_id=args.worker_id)
        if resp.get("finished"):
            return 0
        task = resp.get("task")
        if not task or int(task.get("task_id", -1)) < 0:
            time.sleep(0.05)
            continue
        part = str(task["shard_name"])
        start, end = int(task["start"]), int(task["end"])
        stop_at = time.monotonic() + args.grace
        payloads = None
        while payloads is None:
            try:
                payloads = source.read(part, start, end)
            except Exception:
                if time.monotonic() >= stop_at:
                    raise
                time.sleep(0.05)
        per_shard: Dict[int, List[int]] = {}
        for payload in payloads:
            rid = int(json.loads(payload.decode())["id"])
            per_shard.setdefault(
                _shard_of(rid, len(ports)), []
            ).append(rid)
        for shard, ids in sorted(per_shard.items()):
            push_shard(
                shard, ids, [_grad_row(r) for r in ids],
                client=f"{part}:{start}:{end}:s{shard}",
            )
        call_master(
            "report_task_result",
            task_id=int(task["task_id"]),
            worker_id=args.worker_id,
            generation=int(resp.get("generation", 0)),
        )


class _WorkerFleet:
    """Spawn/SIGKILL/relaunch the drill's real worker processes."""

    def __init__(self, workdir: str, master_addr: str,
                 stream_dir: str, shard_ports: List[int]):
        self.workdir = workdir
        self.cmd_tail = [
            "--master_addr", master_addr,
            "--stream_dir", stream_dir,
            "--shards", ",".join(str(p) for p in shard_ports),
            "--grace", str(WORK_GRACE),
        ]
        self.procs: Dict[int, subprocess.Popen] = {}
        self._logs = []

    def spawn(self, worker_id: int) -> subprocess.Popen:
        log = open(os.path.join(
            self.workdir, f"worker{worker_id}-{len(self._logs)}.log"
        ), "w")
        self._logs.append(log)
        cmd = [
            sys.executable, "-m", "elasticdl_tpu_torch.chaos.stream_drill",
            "work", "--worker_id", str(worker_id),
        ] + self.cmd_tail
        proc = subprocess.Popen(
            cmd, env=dict(os.environ),
            cwd=_pkg_root(), stdout=log, stderr=subprocess.STDOUT,
        )
        self.procs[worker_id] = proc
        return proc

    def sigkill(self, worker_id: int):
        proc = self.procs[worker_id]
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)

    def join_all(self, timeout: float) -> Dict[int, int]:
        deadline = time.monotonic() + timeout
        codes = {}
        for worker_id, proc in self.procs.items():
            left = max(0.1, deadline - time.monotonic())
            try:
                codes[worker_id] = proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                codes[worker_id] = None
        return codes

    def stop_all(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                try:
                    os.kill(proc.pid, signal.SIGKILL)
                except OSError:
                    pass
        for proc in self.procs.values():
            try:
                proc.wait(timeout=10)
            except Exception:
                pass
        for log in self._logs:
            log.close()


# ---- in-drill master incarnations -----------------------------------------


class _Master:
    """One in-process master incarnation over a real journal — fresh
    start or journal recovery, the same code paths master/main.py
    runs."""

    def __init__(self, journal_dir: str, stream_dir: str, port: int,
                 append_lock: threading.Lock):
        from elasticdl_tpu_torch.comm.rpc import RpcServer
        from elasticdl_tpu_torch.data.stream import FileTailStream
        from elasticdl_tpu_torch.master.journal import (
            MasterJournal,
            recover_master_state,
        )
        from elasticdl_tpu_torch.master.servicer import (
            SERVICE_NAME,
            MasterServicer,
        )
        from elasticdl_tpu_torch.master.stream_ingest import StreamIngestor
        from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
        from elasticdl_tpu_torch.observability.registry import MetricsRegistry

        self.registry = MetricsRegistry()
        self.journal = MasterJournal(journal_dir)
        self.dispatcher = TaskDispatcher(
            {}, records_per_task=RECORDS_PER_TASK, shuffle=False,
            streaming=True,
        )
        self.recovered = None
        if self.journal.has_state():
            self.recovered = recover_master_state(
                self.journal, self.dispatcher,
                metrics_registry=self.registry,
            )
        else:
            self.journal.open_generation()
            self.dispatcher.attach_journal(self.journal)
        self.servicer = MasterServicer(
            self.dispatcher, task_timeout_secs=30.0,
            journal=self.journal, generation=self.journal.generation,
        )
        if self.recovered is not None:
            self.servicer.model_version = self.recovered[
                "model_version"
            ]
            self.servicer.seed_task_start_times(
                list(self.dispatcher.doing_start_times())
            )
        self.ingestor = StreamIngestor(
            FileTailStream(stream_dir), self.dispatcher,
            max_todo=MAX_TODO, metrics_registry=self.registry,
        )
        self.server = RpcServer(
            f"localhost:{port}",
            {SERVICE_NAME: self.servicer.handlers()},
        ).start()
        # The ingestor's pump loop, each pass under the writer's lock:
        # it sees the stream between whole writer steps (a whole task's
        # records in each partition), so every stream task holds
        # RECORDS_PER_TASK records in the kill run and in its twin alike.
        # With passes free to land between single appends, the split
        # into tasks, and with it the shards' push counts and optimizer
        # step counters, would follow thread timing.
        self._pumping = threading.Event()
        self._pump_thread = threading.Thread(
            target=self._pump_loop, args=(append_lock,),
            name="stream-ingest", daemon=True)
        self._pump_thread.start()

    def _pump_loop(self, append_lock):
        while not self._pumping.wait(0.05):
            with append_lock:
                try:
                    self.ingestor.pump()
                except Exception:
                    logger.exception("stream pump failed; continuing")

    def stop_pumping(self):
        self._pumping.set()
        self._pump_thread.join(timeout=5.0)

    def close_stream(self):
        self.stop_pumping()
        self.ingestor.close()

    def crash(self):
        """Abandon the incarnation. The flock forces one concession to
        in-process simulation: the journal fd must close so the next
        incarnation can lock the dir (a real SIGKILL releases it for
        free) — no snapshot or graceful drain happens."""
        self.stop_pumping()
        self.server.stop(grace=0)
        self.journal.close()

    def shutdown(self):
        self.stop_pumping()
        self.server.stop(grace=2.0)
        self.journal.close()


def _journal_stream_fold(journal_dir: str) -> dict:
    """Cold fold of the journal's stream plane — what a recovering
    master (or the fsck lane) derives from the records alone."""
    from elasticdl_tpu_torch.master.journal import (
        JOURNAL_FILE,
        REPORT,
        SNAPSHOT,
        STREAM,
        apply_stream_record,
        apply_stream_report_record,
        new_stream_state,
        normalize_stream_state,
        read_records,
    )

    state = new_stream_state()
    for _offset, _end, record in read_records(
        os.path.join(journal_dir, JOURNAL_FILE)
    ):
        if record["t"] == SNAPSHOT and record.get("stream") is not None:
            state = normalize_stream_state(record["stream"])
        elif record["t"] == STREAM:
            apply_stream_record(state, record)
        elif record["t"] == REPORT:
            apply_stream_report_record(state, record)
    return state


def _progress_view(progress: dict) -> dict:
    return {
        p: {"committed": int(part["committed"]),
            "next": int(part["next"]),
            "pending_ranges": len(part.get("pending") or {})}
        for p, part in sorted(progress.items())
    }


def _append_schedule(writer, upto: Dict[str, int], target: int):
    """Append one round-robin record per partition until ``target``."""
    appended = False
    for partition in PARTITIONS:
        offset = upto.get(partition, 0)
        if offset >= target:
            continue
        rid = _record_id(partition, offset)
        writer.append(
            partition, json.dumps({"id": rid}).encode(), fsync=False
        )
        upto[partition] = offset + 1
        appended = True
    return appended


def _pull_ids(port: int, ids: List[int]) -> np.ndarray:
    resp = _call_shard(
        port, "pull_rows", timeout=30.0, table=TABLE,
        ids=np.asarray(ids, np.int64),
    )
    return np.asarray(resp["rows"], np.float32)


def _check_journal(journal_dir: str) -> List[str]:
    from elasticdl_tpu_torch.tools.check_journal import check_journal

    return check_journal(journal_dir)


# ---- scenario 1: the kill drill -------------------------------------------


def _pipeline_run(workdir: str, kill: bool) -> dict:
    """One full streaming pipeline run; ``kill=True`` runs the
    worker-SIGKILL + shard-SIGKILL + master-crash window."""
    from elasticdl_tpu_torch.data.stream import StreamWriter

    label = "kill" if kill else "twin"
    root = os.path.join(workdir, label)
    stream_dir = os.path.join(root, "stream")
    journal_dir = os.path.join(root, "journal")
    os.makedirs(stream_dir, exist_ok=True)
    out = {"label": label, "events": [], "problems": []}

    shard_ports = _free_ports(NUM_SHARDS)
    (master_port,) = _free_ports(1)
    fleet = RowFleet(os.path.join(root, "rowfleet"))
    ckpt_dirs, wal_dirs = [], []
    for shard in range(NUM_SHARDS):
        ckpt = os.path.join(root, "row_ckpt", f"shard{shard}")
        wal = os.path.join(root, "row_wal", f"shard{shard}")
        ckpt_dirs.append(ckpt)
        wal_dirs.append(wal)
        # SGD: with one update per row, the final table is independent
        # of apply ORDER — Adam's per-table step counter would make the
        # kill run's different interleaving diverge from the twin even
        # with perfect exactly-once delivery.
        fleet.spawn(shard, shard_ports[shard], checkpoint_dir=ckpt,
                    push_log_dir=wal, ack="durable", group_ms=1.0,
                    optimizer="sgd")
    out["wal_dirs"] = list(wal_dirs)
    out["journal_dir"] = journal_dir

    writer = StreamWriter(stream_dir)
    upto: Dict[str, int] = {}
    # Seed enough records that the pipeline has work before workers
    # attach; the writer thread below keeps appending live.
    for _ in range(RECORDS_PER_TASK * 2):
        _append_schedule(writer, upto, RECORDS_PER_PARTITION)
    writer_done = threading.Event()
    append_lock = threading.Lock()

    def _writer_loop():
        while not writer_done.is_set():
            with append_lock:
                appended = [
                    _append_schedule(writer, upto, RECORDS_PER_PARTITION)
                    for _ in range(RECORDS_PER_TASK)
                ]
            if not any(appended):
                return
            time.sleep(0.01 * RECORDS_PER_TASK)

    writer_thread = threading.Thread(
        target=_writer_loop, name=f"stream-writer-{label}", daemon=True
    )

    master = None
    workers = None
    try:
        for port in shard_ports:
            _wait_shard(port)
        master = _Master(journal_dir, stream_dir, master_port,
                             append_lock)
        workers = _WorkerFleet(
            root, f"localhost:{master_port}", stream_dir, shard_ports
        )
        for worker_id in range(NUM_WORKERS):
            workers.spawn(worker_id)
        writer_thread.start()

        def committed_total() -> int:
            return sum(
                int(p["committed"])
                for p in master.dispatcher.stream_progress().values()
            )

        deadline = time.monotonic() + DRILL_DEADLINE
        if kill:
            while committed_total() < KILL_AT_COMMITTED:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"never reached {KILL_AT_COMMITTED} committed "
                        f"records (at {committed_total()})"
                    )
                time.sleep(0.05)
            committed_at_kill = _progress_view(
                master.dispatcher.stream_progress()
            )
            out["committed_at_kill"] = committed_at_kill
            # THE window: worker 0, shard 0, and the master all die
            # before anything recovers.
            workers.sigkill(0)
            out["events"].append("worker 0 SIGKILL")
            fleet.sigkill(0)
            out["events"].append("shard 0 SIGKILL")
            master.crash()
            out["events"].append("master crashed (journal abandoned)")
            # Dead incarnation's WAL fsck BEFORE the relaunch replays
            # it (same discipline as the quake drill).
            out["dead_wal_fsck"] = _fsck_log(wal_dirs[0], ckpt_dirs[0])
            fleet.relaunch(0)
            _wait_shard(shard_ports[0])
            out["events"].append("shard 0 relaunched (WAL replayed)")
            master = _Master(journal_dir, stream_dir, master_port,
                             append_lock)
            resumed = _progress_view(
                master.dispatcher.stream_progress()
            )
            out["resumed_progress"] = resumed
            out["events"].append(
                "master recovered from journal "
                f"(generation {master.journal.generation})"
            )
            for partition, snap in committed_at_kill.items():
                got = resumed.get(partition, {}).get("committed", 0)
                if got < snap["committed"]:
                    out["problems"].append(
                        f"{partition}: recovered watermark {got} "
                        f"below the committed {snap['committed']} at "
                        "kill time"
                    )
            # The dead worker's leases must requeue (what the instance
            # manager does on pod death), or its in-flight ranges
            # would wedge the stream forever.
            master.dispatcher.recover_tasks(0)
            # Read-your-writes: every offset committed BEFORE the
            # kills must already be served back non-zero — acked means
            # durable on the row plane, across both SIGKILLs.
            ryw = {"checked": 0, "missing": 0}
            for partition, snap in committed_at_kill.items():
                ids = [
                    _record_id(partition, o)
                    for o in range(snap["committed"])
                ]
                per_shard: Dict[int, List[int]] = {}
                for rid in ids:
                    per_shard.setdefault(
                        _shard_of(rid, NUM_SHARDS), []
                    ).append(rid)
                for shard, shard_ids in per_shard.items():
                    rows = _pull_ids(shard_ports[shard], shard_ids)
                    ryw["checked"] += len(shard_ids)
                    zero = int(np.sum(~np.any(rows != 0.0, axis=1)))
                    ryw["missing"] += zero
            out["read_your_writes"] = ryw
            if ryw["missing"]:
                out["problems"].append(
                    f"read-your-writes violated: {ryw['missing']} of "
                    f"{ryw['checked']} committed offsets served zero "
                    "rows after the relaunch"
                )
            workers.spawn(0)
            out["events"].append("worker 0 relaunched")

        # Drain: every appended record committed, then close the
        # stream so the dispatcher finishes and workers exit.
        def all_committed() -> bool:
            progress = master.dispatcher.stream_progress()
            return all(
                int(progress.get(p, {}).get("committed", -1))
                == RECORDS_PER_PARTITION
                for p in PARTITIONS
            )

        while not all_committed():
            if time.monotonic() > deadline:
                raise TimeoutError(
                    "stream never fully committed: "
                    f"{_progress_view(master.dispatcher.stream_progress())}"
                )
            time.sleep(0.05)
        writer_done.set()
        master.close_stream()
        codes = workers.join_all(timeout=30.0)
        for worker_id, code in codes.items():
            if code != 0:
                out["problems"].append(
                    f"worker {worker_id} exited {code}, want 0"
                )
        out["final_progress"] = _progress_view(
            master.dispatcher.stream_progress()
        )
        out["stream_render"] = master.ingestor.render()
        out["backpressure_seconds"] = (
            master.ingestor.backpressure_seconds
        )
        master.shutdown()
        master = None
        out["journal_fold"] = _progress_view(
            {p: part for p, part in _journal_stream_fold(
                journal_dir
            )["partitions"].items()}
        )
        out["journal_fsck_errors"] = _check_journal(journal_dir)
        captures = []
        for shard in range(NUM_SHARDS):
            cap = _capture_shard(shard_ports[shard])
            captures.append(cap)
        out["push_counts"] = [c["push_count"] for c in captures]
        out["_captures"] = captures
        wal_fsck = []
        for shard in range(NUM_SHARDS):
            wal_fsck.append(
                dict(_fsck_log(wal_dirs[shard], ckpt_dirs[shard]),
                     dir=wal_dirs[shard])
            )
        out["wal_fsck"] = wal_fsck
    finally:
        writer_done.set()
        if writer_thread.is_alive():
            writer_thread.join(timeout=5.0)
        if workers is not None:
            workers.stop_all()
        if master is not None:
            try:
                master.shutdown()
            except Exception:
                pass
        fleet.stop_all()
        writer.close()
    return out


def _kill_scenario(workdir: str) -> dict:
    result = {"problems": []}
    killed = _pipeline_run(workdir, kill=True)
    twin = _pipeline_run(workdir, kill=False)
    for run in (killed, twin):
        result["problems"].extend(
            f"{run['label']}: {p}" for p in run["problems"]
        )

    # Byte-equality per shard against the kill-free twin.
    byte_problems = []
    for shard in range(NUM_SHARDS):
        byte_problems.extend(_tables_equal(
            killed["_captures"][shard]["tables"],
            twin["_captures"][shard]["tables"],
            f"shard {shard}",
        ))
    result["byte_equal"] = not byte_problems
    result["problems"].extend(byte_problems)
    if killed["push_counts"] != twin["push_counts"]:
        result["problems"].append(
            "applied push counts diverged from the twin "
            f"({killed['push_counts']} vs {twin['push_counts']}) — "
            "a push was lost or double-applied"
        )

    # Watermark bookkeeping: live vs journal fold, completeness,
    # contiguity (no pending ranges at the end).
    for run in (killed, twin):
        if run["final_progress"] != run["journal_fold"]:
            result["problems"].append(
                f"{run['label']}: journal stream fold disagrees with "
                f"the live dispatcher ({run['journal_fold']} vs "
                f"{run['final_progress']})"
            )
        for partition in PARTITIONS:
            part = run["final_progress"].get(partition, {})
            if part.get("committed") != RECORDS_PER_PARTITION:
                result["problems"].append(
                    f"{run['label']}: {partition} committed "
                    f"{part.get('committed')} != appended "
                    f"{RECORDS_PER_PARTITION}"
                )
            if part.get("pending_ranges"):
                result["problems"].append(
                    f"{run['label']}: {partition} finished with "
                    f"{part['pending_ranges']} uncommitted pending "
                    "ranges"
                )
        result["problems"].extend(
            f"{run['label']} journal fsck: {e}"
            for e in run["journal_fsck_errors"]
        )
        for wal in run["wal_fsck"]:
            result["problems"].extend(
                f"{run['label']} wal fsck {wal['dir']}: {e}"
                for e in wal["errors"]
            )
            if wal["records"] <= 0:
                result["problems"].append(
                    f"{run['label']} wal {wal['dir']}: no push "
                    "records — the WAL was not exercised"
                )
    dead = killed.get("dead_wal_fsck", {})
    result["problems"].extend(
        f"dead-incarnation wal fsck: {e}" for e in dead.get(
            "errors", ["missing"]
        )
    )
    for run in (killed, twin):
        run.pop("_captures", None)
    result["killed"] = killed
    result["twin"] = twin
    return result


# ---- scenario 2: coexistence under the gang scheduler ---------------------


def _coexist_scenario(workdir: str) -> dict:
    """Streaming tenant + batch tenant on one fleet: the batch job
    preempts, completes, and yields back; the watermark is monotone
    throughout and every stream offset lands exactly once."""
    from elasticdl_tpu_torch.data.stream import FileTailStream, StreamWriter
    from elasticdl_tpu_torch.master.journal import MasterJournal
    from elasticdl_tpu_torch.master.scheduler import GangScheduler
    from elasticdl_tpu_torch.master.servicer import MasterServicer
    from elasticdl_tpu_torch.master.stream_ingest import StreamIngestor
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.observability.registry import MetricsRegistry

    root = os.path.join(workdir, "coexist")
    stream_dir = os.path.join(root, "stream")
    journal_dir = os.path.join(root, "journal")
    os.makedirs(stream_dir, exist_ok=True)
    out = {
        "problems": [], "preemptions": 0, "resumes": 0,
        "watermark_samples": [], "applied": {}, "batch_applied": {},
        "dropped_leases": 0,
    }

    journal = MasterJournal(journal_dir)
    generation = journal.open_generation()
    sched = GangScheduler(slots_fn=lambda: NUM_WORKERS,
                          journal=journal)
    servicer = MasterServicer(
        TaskDispatcher({}, shuffle=False),  # single-job plane unused
        journal=journal, generation=generation, scheduler=sched,
    )

    def _preempt(job_id, entry):
        out["preemptions"] += 1

    def _resume(job_id, entry):
        out["resumes"] += 1

    # The streaming tenant enters the job table through the DEFAULT
    # dispatcher factory's stream branch — exactly how a submitted
    # spec-only job would.
    sched.submit(
        "stream-live",
        spec={"stream": True, "records_per_task": RECORDS_PER_TASK},
        priority=1, gang_size=NUM_WORKERS,
        preempt_cb=_preempt, resume_cb=_resume,
    )
    # The factory builds the dispatcher at ADMISSION, not submit.
    sched.tick()
    stream_disp = sched.dispatcher_of("stream-live")
    if stream_disp is None or not getattr(
        stream_disp, "is_streaming", False
    ):
        out["problems"].append(
            "scheduler's dispatcher factory did not build a "
            "streaming dispatcher from spec={'stream': True}"
        )
        journal.close()
        return out
    writer = StreamWriter(stream_dir)
    upto: Dict[str, int] = {}
    ingestor = StreamIngestor(
        FileTailStream(stream_dir), stream_disp, max_todo=MAX_TODO,
        metrics_registry=MetricsRegistry(),
    )

    batch_submitted = False
    batch_done_seen = False
    stream_closed = False
    finished_seen = False
    last_committed = 0
    pending = {w: None for w in range(NUM_WORKERS)}

    def committed_total() -> int:
        return sum(
            int(p["committed"])
            for p in stream_disp.stream_progress().values()
        )

    try:
        for step in range(1, CO_MAX_STEPS + 1):
            out["steps"] = step
            _append_schedule(writer, upto, CO_STREAM_RECORDS)
            ingestor.pump()
            for w in range(NUM_WORKERS):
                if pending[w] is not None:
                    continue
                resp = servicer.get_task({"worker_id": w})
                if resp.get("finished"):
                    finished_seen = True
                    continue
                task = resp.get("task")
                if task is None or int(task["task_id"]) < 0:
                    continue
                pending[w] = (str(resp.get("job", "")), task)
            if not batch_submitted and (
                committed_total() >= CO_PREEMPT_AT
            ):
                resp = servicer.submit_job({
                    "job": "batch-hi",
                    "spec": {
                        "shards": {"data": [
                            0, CO_BATCH_TASKS * CO_ROWS_PER_TASK,
                        ]},
                        "records_per_task": CO_ROWS_PER_TASK,
                        "num_epochs": 1, "seed": 0,
                    },
                    "priority": 10, "gang_size": NUM_WORKERS,
                })
                if not resp.get("accepted"):
                    out["problems"].append(
                        f"submit_job rejected: {resp}"
                    )
                batch_submitted = True
            sched.tick()
            states = {
                j: e["state"]
                for j, e in sched.render()["jobs"].items()
            }
            # A preempted gang's leases die with its pods, un-applied.
            for w in range(NUM_WORKERS):
                if (pending[w] is not None
                        and states.get(pending[w][0]) == "preempted"):
                    pending[w] = None
                    out["dropped_leases"] += 1
            for w in range(NUM_WORKERS):
                if pending[w] is None:
                    continue
                job, task = pending[w]
                tid = int(task["task_id"])
                if job == "stream-live":
                    key = (
                        f"{task['shard_name']}:{task['start']}:"
                        f"{task['end']}"
                    )
                    out["applied"][key] = (
                        out["applied"].get(key, 0) + 1
                    )
                else:
                    out["batch_applied"][tid] = (
                        out["batch_applied"].get(tid, 0) + 1
                    )
                servicer.report_task_result({
                    "task_id": tid, "worker_id": w, "job": job,
                    "generation": generation,
                })
                pending[w] = None
            # Watermark monotonicity sampled every step — ESPECIALLY
            # across the preemption window.
            total = committed_total()
            if total < last_committed:
                out["problems"].append(
                    f"watermark regressed: {last_committed} -> "
                    f"{total} at step {step}"
                )
            last_committed = total
            out["watermark_samples"].append(total)
            if states.get("batch-hi") == "done":
                batch_done_seen = True
            if (not stream_closed
                    and committed_total() == CO_STREAM_RECORDS
                    * len(PARTITIONS)
                    and upto.get(PARTITIONS[0], 0)
                    >= CO_STREAM_RECORDS):
                ingestor.close()
                stream_closed = True
            if states and all(
                s == "done" for s in states.values()
            ) and batch_submitted:
                break
        resp = servicer.get_task({"worker_id": 0})
        if resp.get("finished"):
            finished_seen = True
        out["backpressure_seconds"] = ingestor.backpressure_seconds
        out["render"] = sched.render()
        out["final_progress"] = _progress_view(
            stream_disp.stream_progress()
        )
    finally:
        journal.close()
        writer.close()

    states = {
        j: e.get("state") for j, e in out["render"]["jobs"].items()
    }
    out["states"] = states
    if out["preemptions"] < 1:
        out["problems"].append(
            "the batch job never preempted the streaming tenant"
        )
    if out["resumes"] < 1:
        out["problems"].append(
            "the streaming tenant was never resumed after preemption"
        )
    if not batch_done_seen or states.get("batch-hi") != "done":
        out["problems"].append("batch job did not complete")
    if states.get("stream-live") != "done":
        out["problems"].append(
            f"streaming job ended in state "
            f"{states.get('stream-live')!r}, want 'done' after "
            "close_stream + drain"
        )
    if not finished_seen:
        out["problems"].append(
            "servicer never reported finished after both jobs done"
        )
    dupes = {k: c for k, c in out["applied"].items() if c != 1}
    if dupes:
        out["problems"].append(
            f"stream ranges applied more than once: {dupes}"
        )
    # Exactly-once over the OFFSET SPACE: the applied ranges (task
    # sizes vary with tail arrival) must tile [0, end) per partition —
    # a gap is a lost ack, an overlap a double apply.
    for partition in PARTITIONS:
        ranges = sorted(
            (int(s), int(e))
            for k in out["applied"]
            for p, s, e in [k.rsplit(":", 2)]
            if p == partition
        )
        cursor = 0
        for start, end in ranges:
            if start != cursor:
                out["problems"].append(
                    f"{partition}: applied ranges {'overlap' if start < cursor else 'leave a gap'} "
                    f"at offset {cursor} (next range [{start}, {end}))"
                )
                break
            cursor = end
        else:
            if cursor != CO_STREAM_RECORDS:
                out["problems"].append(
                    f"{partition}: applied ranges cover [0, {cursor}),"
                    f" want [0, {CO_STREAM_RECORDS})"
                )
    if len(out["batch_applied"]) != CO_BATCH_TASKS or any(
        c != 1 for c in out["batch_applied"].values()
    ):
        out["problems"].append(
            f"batch tasks misapplied: {out['batch_applied']}"
        )
    for partition in PARTITIONS:
        part = out["final_progress"].get(partition, {})
        if part.get("committed") != CO_STREAM_RECORDS:
            out["problems"].append(
                f"{partition}: final watermark "
                f"{part.get('committed')} != {CO_STREAM_RECORDS}"
            )
    if out.get("backpressure_seconds", 0.0) <= 0.0:
        out["problems"].append(
            "backpressure never ticked while the streaming gang was "
            "preempted (todo should have filled to max_todo)"
        )
    monotone = all(
        b >= a for a, b in zip(out["watermark_samples"],
                               out["watermark_samples"][1:])
    )
    out["watermark_monotone"] = monotone
    out["journal_fsck_errors"] = _check_journal(journal_dir)
    out["problems"].extend(
        f"coexist journal fsck: {e}"
        for e in out["journal_fsck_errors"]
    )
    # Bound the sample list in the report.
    out["watermark_samples"] = out["watermark_samples"][-64:]
    out.pop("render", None)
    return out


# ---- entry ----------------------------------------------------------------


def run_drill(workdir: str, seed: int = 0) -> dict:
    report = {
        "drill": "stream_ingest",
        "seed": seed,
        "config": {
            "partitions": list(PARTITIONS),
            "records_per_partition": RECORDS_PER_PARTITION,
            "records_per_task": RECORDS_PER_TASK,
            "kill_at_committed": KILL_AT_COMMITTED,
            "max_todo": MAX_TODO,
            "workers": NUM_WORKERS,
            "shards": NUM_SHARDS,
            "coexist": {
                "stream_records": CO_STREAM_RECORDS,
                "batch_tasks": CO_BATCH_TASKS,
                "preempt_at": CO_PREEMPT_AT,
            },
        },
        "problems": [],
    }
    kill = _kill_scenario(workdir)
    report["kill"] = kill
    report["problems"].extend(kill["problems"])
    coexist = _coexist_scenario(workdir)
    report["coexist"] = coexist
    report["problems"].extend(coexist["problems"])
    report["passed"] = not report["problems"]
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("elasticdl_tpu_torch-stream-drill")
    sub = parser.add_subparsers(dest="cmd")
    work = sub.add_parser("work")
    work.add_argument("--worker_id", type=int, required=True)
    work.add_argument("--master_addr", required=True)
    work.add_argument("--stream_dir", required=True)
    work.add_argument("--shards", required=True)
    work.add_argument("--grace", type=float, default=WORK_GRACE)
    run = sub.add_parser("run")
    for p in (run, parser):
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--workdir")
        p.add_argument("--report", default="",
                       help="default: <workdir>/STREAM_DRILL.json")
    args = parser.parse_args(argv)
    if args.cmd == "work":
        return _work(args)
    if not args.workdir:
        parser.error("--workdir required")
    args.report = args.report or os.path.join(args.workdir,
                                              "STREAM_DRILL.json")
    report = run_drill(args.workdir, args.seed)
    with open(args.report, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True, default=str)
        fh.write("\n")
    logger.info(
        "stream drill: %s (%d problems); report %s",
        "PASS" if report["passed"] else "FAIL",
        len(report["problems"]), args.report,
    )
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
