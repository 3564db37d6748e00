"""Zero-RPO quake drill (port of elasticdl_tpu/chaos/quake_drill.py):
SIGKILL real row-service processes mid-push-storm and require that no
acked push is ever lost.

``python -m elasticdl_tpu_torch.chaos.quake_drill run --workdir DIR
[--report PATH]`` (exit 0 only if every gate holds; the report defaults
to ``DIR/QUAKE_DRILL.json``); ``... serve --port P [--checkpoint_dir C
--push_log_dir W --push_log_ack durable|applied --optimizer adam|sgd]``
runs one shard (``chaos/stream_drill.py`` drives its fleet through
``RowFleet`` too). Host only: the rows live in host RAM and on disk.

1. **Shard quake** — a REAL 2-shard row-service fleet (subprocesses
   over localhost gRPC) with checkpoints + the write-ahead push log
   (``storage/pushlog.py``, durable acks) takes a seeded push storm;
   one shard is SIGKILLed mid-storm and relaunched. The client simply
   keeps pushing (bounded retries) — **no external replay of acked
   pushes** — and the final fleet state must be **byte-equal** (rows,
   optimizer slots, Adam step counters) to a fault-free twin driven by
   the same schedule: acked-push RPO = 0, recovered from
   restore-chain + WAL-tail replay alone. The dead incarnation's log
   is fsck'd (the port's ``tools/check_pushlog.py``) before the
   relaunch touches it.
2. **Durable-ack overhead** — the price of zero RPO, measured: the
   same storm against a no-log shard vs a durable-ack shard at the
   default group-commit window, interleaved windows, gate
   **p99 push ≤ 1.5x** the no-log baseline.
3. **Composed quake** — the multi-plane kill: a journaled master
   (primary + warm standby, the failover drill's real processes) runs
   a task schedule while the row fleet live-splits 2→3; the migration
   SOURCE self-SIGKILLs mid-copy (chunk-hook) and the drill SIGKILLs
   the PRIMARY MASTER in the same window. Recovery is three
   independent mechanisms converging at once: the standby fences and
   takes over (worker rides out, exactly-once accounting holds), the
   relaunched source restores chain + replays its WAL, and a fresh
   authority ``resume()``s the migration from its state file. Gates:
   the job drains with exactly the scheduled records trained, every
   shard converges to ONE map epoch, no row lost or double-homed, and
   the row fleet lands byte-equal to a kill-free twin that ran the
   same storm + split.

Contract note: pre-WAL drills re-drove lost pushes
externally after a kill — modeling a trainer retrying *unacked* work.
This drill is the stronger claim and never re-drives: once the push
log acks a write, only the dead process's own recovery may produce
it again.
"""

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("quake_drill")

TABLE = "quake_rows"
DIM = 16
# Spans the full 8192-bucket shard-map space (id % NUM_BUCKETS), so a
# bootstrap 2-shard map actually splits the storm across the fleet.
VOCAB = 120_000
PUSH_IDS = 48
SEED = 11
STORM_PUSHES = 240
KILL_AT_ACK = 90
CHECKPOINT_STEPS = 40
COMPOSED_PUSHES = 160
COMPOSED_SPLIT_AT = 80
BENCH_PUSHES = 480       # per window per mode (p99 needs samples)
BENCH_THREADS = 4
BENCH_WINDOWS = 3        # window 0 is warmup, gates on the rest
MAX_DURABLE_P99_RATIO = 1.5


def _schedule(seed: int, pushes: int):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(pushes):
        ids = np.unique(
            rng.randint(0, VOCAB, PUSH_IDS)
        ).astype(np.int64)
        out.append((ids, rng.rand(ids.size, DIM).astype(np.float32)))
    return out


def _pkg_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)
    )))


def _free_ports(n: int) -> List[int]:
    ports, socks = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("localhost", 0))
        ports.append(s.getsockname()[1])
        socks.append(s)
    for s in socks:
        s.close()
    return ports


# ---- `serve` subcommand: one real row-service shard ----------------------


def _serve(args) -> int:
    from elasticdl_tpu_torch.comm.rpc import RpcServer
    from elasticdl_tpu_torch.embedding import row_service as rs_mod
    from elasticdl_tpu_torch.embedding.optimizer import SGD, Adam
    from elasticdl_tpu_torch.embedding.row_service import (
        SERVICE_NAME,
        HostRowService,
    )
    from elasticdl_tpu_torch.native.row_store import (
        make_host_optimizer,
        make_host_table,
    )

    # SGD is for drills whose byte-equality gate compares runs with
    # DIFFERENT apply interleavings (stream_drill.py): Adam's per-table
    # step counter makes row state order-dependent even when every row
    # sees exactly one update.
    opt = (SGD(lr=0.01) if getattr(args, "optimizer", "adam") == "sgd"
           else Adam(lr=0.01))
    svc = HostRowService(
        {TABLE: make_host_table(TABLE, DIM)},
        make_host_optimizer(opt),
    )
    if args.checkpoint_dir:
        svc.configure_checkpoint(
            args.checkpoint_dir, checkpoint_steps=args.checkpoint_steps,
            delta_chain_max=3,
        )
    if args.push_log_dir:
        svc.configure_push_log(
            args.push_log_dir, group_ms=args.push_log_group_ms,
            ack=args.push_log_ack,
        )
    if args.die_after_migrate_chunks > 0:
        # The composed scenario's deterministic kill point: the REAL
        # process SIGKILLs itself after N migrated chunks landed on
        # the target — mid-copy, rows in flight, WAL mid-truncation
        # cycle.
        state = {"n": 0}

        def _die(_svc, _mig, _view, _chunk):
            state["n"] += 1
            if state["n"] >= args.die_after_migrate_chunks:
                os.kill(os.getpid(), signal.SIGKILL)

        rs_mod.set_reshard_chaos_hooks(mid_migrate=_die)

    def _capture(_request: dict) -> dict:
        out = {}
        for name, view in svc.host_tables.items():
            if name == rs_mod.SEQS_TABLE_NAME:
                # Client-id bookkeeping, keyed by which incarnation
                # pushed — not comparable row state.
                continue
            ids, rows = view.to_arrays()
            out[name] = {
                "ids": np.asarray(ids, np.int64),
                "rows": np.asarray(rows),
            }
        return {"tables": out, "push_count": svc._push_count}

    handlers = dict(svc.handlers())
    handlers["drill_capture"] = _capture
    handlers["ping"] = lambda _req: {"ok": True, "pid": os.getpid()}
    server = RpcServer(
        f"localhost:{args.port}", {SERVICE_NAME: handlers},
        tag=f"rowservice/{args.shard_id}",
    ).start()
    svc._server = server
    logger.info("quake shard %d serving on %d (pid %d)",
                args.shard_id, server.port, os.getpid())
    server.wait()
    return 0


# ---- runner: shard fleet management ---------------------------------------


class RowFleet:
    """Spawn/kill/relaunch the drill's real row-service processes."""

    def __init__(self, workdir: str):
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.procs: Dict[int, subprocess.Popen] = {}
        self.cmds: Dict[int, List[str]] = {}
        self._logs = []

    def spawn(self, shard: int, port: int, checkpoint_dir: str = "",
              push_log_dir: str = "", ack: str = "durable",
              group_ms: float = 2.0,
              die_after_migrate_chunks: int = 0,
              checkpoint_steps: int = CHECKPOINT_STEPS,
              optimizer: str = "adam",
              ) -> subprocess.Popen:
        cmd = [
            sys.executable, "-m", "elasticdl_tpu_torch.chaos.quake_drill",
            "serve", "--port", str(port), "--shard_id", str(shard),
            "--checkpoint_steps", str(checkpoint_steps),
            "--push_log_group_ms", str(group_ms),
            "--push_log_ack", ack,
            "--optimizer", optimizer,
        ]
        if checkpoint_dir:
            cmd += ["--checkpoint_dir", checkpoint_dir]
        if push_log_dir:
            cmd += ["--push_log_dir", push_log_dir]
        # The relaunch re-runs the identical command MINUS the death
        # hook — a pod restart does not inherit the fault injector —
        # so snapshot the command BEFORE appending the flag pair.
        self.cmds[shard] = list(cmd)
        if die_after_migrate_chunks:
            cmd += ["--die_after_migrate_chunks",
                    str(die_after_migrate_chunks)]
        log = open(os.path.join(
            self.workdir, f"shard{shard}-{port}-{len(self._logs)}.log"
        ), "w")
        self._logs.append(log)
        proc = subprocess.Popen(
            cmd, env=dict(os.environ),
            cwd=_pkg_root(), stdout=log, stderr=subprocess.STDOUT,
        )
        self.procs[shard] = proc
        return proc

    def relaunch(self, shard: int) -> subprocess.Popen:
        log = open(os.path.join(
            self.workdir, f"shard{shard}-relaunch-{len(self._logs)}.log"
        ), "w")
        self._logs.append(log)
        proc = subprocess.Popen(
            self.cmds[shard], env=dict(os.environ),
            cwd=_pkg_root(), stdout=log, stderr=subprocess.STDOUT,
        )
        self.procs[shard] = proc
        return proc

    def sigkill(self, shard: int):
        proc = self.procs[shard]
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)

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


def _call_shard(port: int, method: str, timeout: float = 10.0,
                **fields) -> dict:
    from elasticdl_tpu_torch.comm.rpc import RpcStub
    from elasticdl_tpu_torch.embedding.row_service import SERVICE_NAME

    stub = RpcStub(f"localhost:{port}", SERVICE_NAME, max_retries=0)
    try:
        return stub.call(method, timeout=timeout, **fields)
    finally:
        stub.close()


def _wait_shard(port: int, deadline_secs: float = 90.0):
    t0 = time.monotonic()
    last = None
    while time.monotonic() - t0 < deadline_secs:
        try:
            return _call_shard(port, "ping", timeout=2.0)
        except Exception as exc:
            last = exc
            time.sleep(0.1)
    raise TimeoutError(f"shard on port {port} never served: {last}")


def _capture_shard(port: int) -> dict:
    resp = _call_shard(port, "drill_capture", timeout=60.0)
    return resp


def _make_engine(ports: List[int]):
    from elasticdl_tpu_torch.embedding.row_service import make_remote_engine

    return make_remote_engine(
        ",".join(f"localhost:{p}" for p in ports), {},
        retries=20, backoff_secs=0.25,
    )


def _tables_equal(a: dict, b: dict, where: str) -> List[str]:
    problems = []
    for name in sorted(set(a) | set(b)):
        if name not in a or name not in b:
            problems.append(f"{where}: view {name} present on one "
                            "side only")
            continue
        ids_a = np.asarray(a[name]["ids"], np.int64)
        ids_b = np.asarray(b[name]["ids"], np.int64)
        order_a, order_b = np.argsort(ids_a), np.argsort(ids_b)
        if not np.array_equal(ids_a[order_a], ids_b[order_b]):
            problems.append(
                f"{where}: {name} id sets differ "
                f"({ids_a.size} vs {ids_b.size})"
            )
            continue
        rows_a = np.asarray(a[name]["rows"])[order_a]
        rows_b = np.asarray(b[name]["rows"])[order_b]
        if not np.array_equal(
            rows_a.astype(np.float64), rows_b.astype(np.float64)
        ):
            problems.append(f"{where}: {name} row bytes differ")
    return problems


def _fsck_log(log_dir: str, checkpoint_dir: Optional[str] = None
              ) -> dict:
    from elasticdl_tpu_torch.tools.check_pushlog import check_one_log

    errors, report = check_one_log(log_dir, checkpoint_dir)
    return {"errors": errors, "records": report["records"],
            "torn_tail": report["torn_tail"]}


# ---- scenario 1: shard quake ----------------------------------------------


def _run_quake_fleet(workdir: str, schedule, kill: bool) -> dict:
    fleet = RowFleet(workdir)
    ports = _free_ports(2)
    dirs = {}
    result = {"problems": [], "dead_log_fsck": None}
    for shard, port in enumerate(ports):
        ckpt = os.path.join(workdir, f"s{shard}", "ckpt")
        wal = os.path.join(workdir, f"s{shard}", "pushlog")
        dirs[shard] = (ckpt, wal)
        fleet.spawn(shard, port, checkpoint_dir=ckpt,
                    push_log_dir=wal, ack="durable")
    try:
        for port in ports:
            _wait_shard(port)
        engine = _make_engine(ports)
        table = engine.tables[TABLE]
        acked = 0
        for ids, grads in schedule:
            engine.optimizer.apply_gradients(table, ids, grads)
            acked += 1
            if kill and acked == KILL_AT_ACK:
                # SIGKILL shard 0 mid-storm: queued group commits die
                # with it; every *acked* push is already on disk
                # (durable ack). The dead incarnation's log must fsck
                # clean BEFORE the relaunch appends to it.
                fleet.sigkill(0)
                result["dead_log_fsck"] = _fsck_log(
                    dirs[0][1], dirs[0][0]
                )
                result["killed_at_ack"] = acked
                fleet.relaunch(0)
                # No waiting, no external replay: the next push's
                # bounded retries ride out the relaunch.
        result["acked"] = acked
        states = {
            shard: _capture_shard(port)
            for shard, port in enumerate(ports)
        }
        result["states"] = states
        result["push_counts"] = {
            s: int(st["push_count"]) for s, st in states.items()
        }
    finally:
        fleet.stop_all()
    return result


def scenario_shard_quake(workdir: str) -> dict:
    schedule = _schedule(SEED, STORM_PUSHES)
    result = {"scenario": "shard_quake", "passed": False,
              "problems": [], "config": {
                  "pushes": STORM_PUSHES, "kill_at_ack": KILL_AT_ACK,
                  "checkpoint_steps": CHECKPOINT_STEPS,
                  "ack": "durable",
              }}
    twin = _run_quake_fleet(
        os.path.join(workdir, "quake", "twin"), schedule, kill=False
    )
    result["problems"] += [f"twin: {p}" for p in twin["problems"]]
    faulted = _run_quake_fleet(
        os.path.join(workdir, "quake", "faulted"), schedule, kill=True
    )
    result["problems"] += [f"faulted: {p}" for p in faulted["problems"]]
    fsck = faulted.get("dead_log_fsck")
    result["dead_log_fsck"] = fsck
    if fsck is None:
        result["problems"].append("shard 0 was never killed")
    elif fsck["errors"]:
        result["problems"] += [
            f"dead incarnation log fsck: {e}" for e in fsck["errors"]
        ]
    for shard in (0, 1):
        result["problems"] += _tables_equal(
            twin["states"][shard]["tables"],
            faulted["states"][shard]["tables"],
            f"shard {shard} vs twin",
        )
    result["push_counts"] = {
        "twin": twin.get("push_counts"),
        "faulted": faulted.get("push_counts"),
    }
    if twin.get("push_counts") != faulted.get("push_counts"):
        result["problems"].append(
            "per-shard push counts diverged from the twin "
            f"({faulted.get('push_counts')} vs "
            f"{twin.get('push_counts')}) — lost or duplicated applies"
        )
    result["rpo_zero"] = not any(
        p for p in result["problems"] if "vs twin" in p
        or "push counts" in p
    )
    result["passed"] = not result["problems"]
    return result


# ---- scenario 2: durable-ack overhead -------------------------------------


def _bench_storm(engine, seed: int) -> List[float]:
    """One window of concurrent pushes; returns per-push seconds.
    The engine is reused across windows — fresh gRPC channels per
    window would charge connection setup to whichever mode ran
    first."""
    table = engine.tables[TABLE]
    latencies: List[float] = []
    lock = threading.Lock()
    errors: List[BaseException] = []

    def pusher(tid: int):
        rng = np.random.RandomState(seed * 97 + tid)
        mine = []
        try:
            for _ in range(BENCH_PUSHES // BENCH_THREADS):
                ids = np.unique(
                    rng.randint(0, VOCAB, PUSH_IDS)
                ).astype(np.int64)
                grads = rng.rand(ids.size, DIM).astype(np.float32)
                t0 = time.monotonic()
                engine.optimizer.apply_gradients(table, ids, grads)
                mine.append(time.monotonic() - t0)
        except BaseException as exc:
            errors.append(exc)
        with lock:
            latencies.extend(mine)

    threads = [
        threading.Thread(target=pusher, args=(tid,), daemon=True)
        for tid in range(BENCH_THREADS)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    if errors:
        raise errors[0]
    return latencies


def _fsync_profile(where: str, n: int = 120) -> dict:
    """The medium's raw fsync distribution — what a durable ack
    fundamentally pays per group commit."""
    import tempfile

    os.makedirs(where, exist_ok=True)
    fd, path = tempfile.mkstemp(dir=where)
    lats = []
    try:
        with os.fdopen(fd, "wb") as fh:
            for _ in range(n):
                fh.write(b"x" * 4096)
                fh.flush()
                t0 = time.monotonic()
                os.fsync(fh.fileno())
                lats.append(time.monotonic() - t0)
    finally:
        try:
            os.remove(path)
        except OSError:
            pass
    lats.sort()
    return {
        "p50_ms": round(1e3 * lats[len(lats) // 2], 3),
        "p99_ms": round(
            1e3 * lats[min(len(lats) - 1, int(0.99 * len(lats)))], 3
        ),
        "max_ms": round(1e3 * lats[-1], 3),
    }


# A medium whose own fsync p99 exceeds this is pathological (CI
# overlayfs: p50 ~2ms, p99 >50ms, max >400ms measured) — the bench
# would gate the disk, not the group-commit mechanism. Real NVMe
# deployment media fsync sub-millisecond.
FSYNC_SANE_P99_MS = 10.0


def scenario_durable_overhead(workdir: str) -> dict:
    """p99 push with the WAL in durable-ack mode vs a no-log shard at
    the default group window — interleaved measurement windows so the
    box's slow drift charges both modes equally; window 0 is warmup.

    The gate prices the MECHANISM (framing + enqueue + group wait +
    write/sync syscalls + the handler's durability rendezvous), so
    when the bench medium's own fsync tail is pathological (container
    overlayfs) the WAL moves to tmpfs and the report says so — the
    shard-quake scenario still proves recovery against real disk."""
    result = {"scenario": "durable_overhead", "passed": False,
              "problems": [], "config": {
                  "threads": BENCH_THREADS,
                  "pushes_per_window": BENCH_PUSHES,
                  "windows": BENCH_WINDOWS,
                  "group_ms": 2.0,
                  "max_p99_ratio": MAX_DURABLE_P99_RATIO,
              }}
    wal_dir = os.path.join(workdir, "bench", "wal")
    profile = _fsync_profile(os.path.join(workdir, "bench"))
    result["fsync_medium"] = {"workdir": profile}
    medium = "workdir"
    if profile["p99_ms"] > FSYNC_SANE_P99_MS and os.path.isdir(
        "/dev/shm"
    ):
        wal_dir = os.path.join(
            "/dev/shm", f"edl_quake_wal_{os.getpid()}"
        )
        result["fsync_medium"]["tmpfs"] = _fsync_profile(wal_dir)
        medium = "tmpfs"
    result["wal_medium"] = medium
    fleet = RowFleet(os.path.join(workdir, "bench"))
    ports = _free_ports(2)
    fleet.spawn(0, ports[0])  # no log, no checkpoint: the baseline
    fleet.spawn(1, ports[1], push_log_dir=wal_dir, ack="durable")
    p99s = {"nolog": [], "durable": []}
    try:
        for port in ports:
            _wait_shard(port)
        engines = {
            "nolog": _make_engine([ports[0]]),
            "durable": _make_engine([ports[1]]),
        }
        for window in range(BENCH_WINDOWS + 1):
            for mode in ("nolog", "durable"):
                lats = _bench_storm(engines[mode], seed=SEED + window)
                if window == 0:
                    continue  # warmup: first pushes pay lazy init
                lats.sort()
                p99s[mode].append(
                    lats[min(len(lats) - 1,
                             int(0.99 * len(lats)))]
                )
    finally:
        fleet.stop_all()
        if medium == "tmpfs":
            import shutil

            shutil.rmtree(wal_dir, ignore_errors=True)
    med = {
        mode: sorted(vals)[len(vals) // 2]
        for mode, vals in p99s.items()
    }
    ratio = med["durable"] / med["nolog"] if med["nolog"] else None
    result["p99_secs"] = {
        mode: [round(v, 5) for v in vals]
        for mode, vals in p99s.items()
    }
    result["p99_median_secs"] = {
        mode: round(v, 5) for mode, v in med.items()
    }
    result["p99_ratio"] = round(ratio, 3) if ratio else None
    if ratio is None or ratio > MAX_DURABLE_P99_RATIO:
        result["problems"].append(
            f"durable-ack p99 {med['durable'] * 1e3:.2f}ms is "
            f"{ratio:.2f}x the no-log baseline "
            f"{med['nolog'] * 1e3:.2f}ms "
            f"(gate <= {MAX_DURABLE_P99_RATIO}x)"
        )
    result["passed"] = not result["problems"]
    return result


# ---- scenario 3: composed master + shard + migration kill -----------------


def _run_composed_row_side(workdir: str, schedule, kill: bool,
                           result: dict) -> Optional[dict]:
    """The row half of the composed scenario (the master half rides
    the failover drill's real processes in the caller): 2-shard fleet,
    storm phase 1, live 2→3 split (source self-SIGKILLs mid-copy when
    ``kill``), relaunch + fresh-authority resume, storm phase 2.
    Returns captures keyed by shard."""
    from elasticdl_tpu_torch.comm.rpc import RpcStub
    from elasticdl_tpu_torch.embedding.row_service import SERVICE_NAME
    from elasticdl_tpu_torch.master.row_reshard import ShardMapController

    fleet = RowFleet(workdir)
    ports = _free_ports(3)
    addrs = [f"localhost:{p}" for p in ports]
    dirs = {}
    for shard in range(3):
        dirs[shard] = (
            os.path.join(workdir, f"s{shard}", "ckpt"),
            os.path.join(workdir, f"s{shard}", "pushlog"),
        )
    state_path = os.path.join(workdir, "shard_map.json")
    # Non-retrying transports: the drill wants the source's death to
    # surface immediately (the production RideOutTransport would mask
    # it for ~64s before the authority restart path engages).
    transport_factory = lambda addr: RpcStub(  # noqa: E731
        addr, SERVICE_NAME, max_retries=1
    )
    try:
        fleet.spawn(0, ports[0], checkpoint_dir=dirs[0][0],
                    push_log_dir=dirs[0][1],
                    die_after_migrate_chunks=2 if kill else 0)
        fleet.spawn(1, ports[1], checkpoint_dir=dirs[1][0],
                    push_log_dir=dirs[1][1])
        _wait_shard(ports[0])
        _wait_shard(ports[1])
        controller = ShardMapController(
            state_path, transport_factory=transport_factory
        )
        controller.bootstrap(addrs[:2])
        engine = _make_engine(ports[:2])
        table = engine.tables[TABLE]
        for ids, grads in schedule[:COMPOSED_SPLIT_AT]:
            engine.optimizer.apply_gradients(table, ids, grads)
        # The split target comes up fresh (its own checkpoint + WAL).
        fleet.spawn(2, ports[2], checkpoint_dir=dirs[2][0],
                    push_log_dir=dirs[2][1])
        _wait_shard(ports[2])
        if not kill:
            controller.split(0, new_addr=addrs[2])
            controller.close()
        else:
            # The caller boots the master plane NOW (primary +
            # standby + a worker holding a live lease), so the
            # composed kill window opens with the task job mid-
            # flight — not drained minutes earlier while the row
            # fleet was still importing.
            before = result.pop("_before_split", None)
            if before is not None:
                before()
            split_exc: List[BaseException] = []

            def _split():
                try:
                    controller.split(0, new_addr=addrs[2])
                except BaseException as exc:
                    split_exc.append(exc)

            splitter = threading.Thread(target=_split, daemon=True)
            splitter.start()
            # The source self-SIGKILLs after 2 migrated chunks — wait
            # for the REAL death, then the caller kills the master in
            # the same window.
            deadline = time.monotonic() + 60.0
            while (fleet.procs[0].poll() is None
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            if fleet.procs[0].poll() is None:
                result["problems"].append(
                    "composed: source never self-killed mid-copy"
                )
                return None
            kill_cb = result.pop("_on_source_dead", None)
            if kill_cb is not None:
                kill_cb()  # SIGKILL the primary master NOW
            splitter.join(timeout=90.0)
            result["split_interrupted"] = bool(split_exc)
            controller.close()
            # Dead incarnation's WAL must fsck clean before the
            # relaunch appends to it.
            result["dead_log_fsck"] = _fsck_log(
                dirs[0][1], dirs[0][0]
            )
            fleet.relaunch(0)
            _wait_shard(ports[0])
            # A FRESH authority incarnation finishes the move from
            # the persisted state file — the restarted-master path.
            controller2 = ShardMapController(
                state_path, transport_factory=transport_factory
            )
            resumed = controller2.resume()
            result["migration_resumed"] = resumed is not None
            controller2.close()
        for ids, grads in schedule[COMPOSED_SPLIT_AT:]:
            engine.optimizer.apply_gradients(table, ids, grads)
        # Convergence: every shard on ONE epoch.
        epochs = {}
        for shard, port in enumerate(ports):
            resp = _call_shard(port, "get_shard_map")
            m = resp.get("map") or {}
            epochs[shard] = int(m.get("version", -1))
        result.setdefault("epochs", {})[
            "kill" if kill else "twin"
        ] = epochs
        if len(set(epochs.values())) != 1:
            result["problems"].append(
                f"composed ({'kill' if kill else 'twin'}): shards "
                f"did not converge to one epoch: {epochs}"
            )
        return {
            shard: _capture_shard(port)
            for shard, port in enumerate(ports)
        }
    finally:
        fleet.stop_all()


def scenario_composed(workdir: str) -> dict:
    from elasticdl_tpu_torch.chaos.failover_drill import (
        RECORDS,
        Fleet,
        ScriptedWorker,
        _call,
        _wait_serving,
    )

    result = {"scenario": "composed_quake", "passed": False,
              "problems": [], "config": {
                  "pushes": COMPOSED_PUSHES,
                  "split_at": COMPOSED_SPLIT_AT,
                  "task_records": RECORDS,
              }}
    schedule = _schedule(SEED + 1, COMPOSED_PUSHES)

    # Fault-free twin of the ROW side (the master side's twin
    # equivalence is pinned by FAILOVER_DRILL; here the master gates
    # are exactly-once accounting + takeover + fsck).
    twin_states = _run_composed_row_side(
        os.path.join(workdir, "composed", "twin"), schedule,
        kill=False, result=result,
    )
    if twin_states is None:
        return result

    mdir = os.path.join(workdir, "composed", "master")
    os.makedirs(mdir, exist_ok=True)
    mfleet = Fleet(mdir, heartbeat_secs=0.05, miss_threshold=2,
                   poll_secs=0.05)
    mports = _free_ports(2)
    pauses = {"holding_lease": threading.Event()}
    worker = ScriptedWorker(
        ",".join(f"localhost:{p}" for p in mports), pauses
    )
    try:
        def _boot_master_plane():
            # Runs from the row side's pre-split hook: the primary,
            # its warm standby, and a worker HOLDING a live lease all
            # exist the instant the migration starts — so the kill
            # window has every plane mid-flight.
            mfleet.spawn_primary(mports[0])
            _wait_serving(mports[0])
            standby = mfleet.spawn_standby(mports[1], mports[0])
            Fleet.wait_attached(standby)
            worker.start()
            if not worker.reached["holding_lease"].wait(60.0):
                raise TimeoutError(
                    "composed: worker never held a lease"
                )

        def _kill_master():
            # The composed window: the master dies while the row
            # migration's source is ALSO freshly dead and a worker
            # holds a live lease.
            Fleet.sigkill(mfleet.procs[0])
            result["master_killed"] = True
            pauses["holding_lease"].set()

        result["_before_split"] = _boot_master_plane
        result["_on_source_dead"] = _kill_master
        faulted_states = _run_composed_row_side(
            os.path.join(workdir, "composed", "faulted"), schedule,
            kill=True, result=result,
        )
        if faulted_states is None:
            return result
        if not result.get("master_killed"):
            result["problems"].append(
                "composed: master kill callback never fired"
            )
        for shard in range(3):
            result["problems"] += _tables_equal(
                twin_states[shard]["tables"],
                faulted_states[shard]["tables"],
                f"composed shard {shard} vs twin",
            )
        # Row conservation: the primary table's ids must partition
        # across the fleet — no loss, no double-homing.
        def _owned(states):
            per = [
                set(np.asarray(
                    states[s]["tables"][TABLE]["ids"], np.int64
                ).tolist())
                for s in range(3)
            ]
            return per

        twin_owned = _owned(twin_states)
        fault_owned = _owned(faulted_states)
        for a in range(3):
            for b in range(a + 1, 3):
                dup = fault_owned[a] & fault_owned[b]
                if dup:
                    result["problems"].append(
                        f"composed: {len(dup)} row id(s) double-"
                        f"homed on shards {a} and {b}"
                    )
        if set().union(*fault_owned) != set().union(*twin_owned):
            result["problems"].append(
                "composed: surviving row id set differs from twin "
                "(rows lost across the multi-plane kill)"
            )
        # Master-plane gates: the job drained exactly once under the
        # promoted standby.
        worker.join(timeout=240.0)
        if worker.is_alive():
            result["problems"].append(
                "composed: worker never drained the task job after "
                "the takeover"
            )
        elif worker.error is not None:
            result["problems"].append(
                f"composed: worker error: {worker.error!r}"
            )
        else:
            result["trained_records"] = int(worker.trained_records)
            if worker.trained_records != RECORDS:
                result["problems"].append(
                    f"composed: trained {worker.trained_records} "
                    f"records, expected exactly {RECORDS} (task "
                    "loss or duplication across the takeover)"
                )
            final = _call(mports[1], "drill_export")
            result["promoted_generation"] = int(
                final.get("generation", -1)
            )
            if result["promoted_generation"] < 1:
                result["problems"].append(
                    "composed: standby never opened a new generation"
                )
        from elasticdl_tpu_torch.tools.check_journal import check_journal

        journal_errors = check_journal(mfleet.journal_dir)
        result["journal_fsck"] = journal_errors
        result["problems"] += [
            f"composed journal fsck: {e}" for e in journal_errors
        ]
        fsck = result.get("dead_log_fsck")
        if fsck and fsck["errors"]:
            result["problems"] += [
                f"composed dead-source log fsck: {e}"
                for e in fsck["errors"]
            ]
    finally:
        result.pop("_on_source_dead", None)
        result.pop("_before_split", None)
        mfleet.stop_all()
    result["passed"] = not result["problems"]
    return result


# ---- report + gates --------------------------------------------------------


def run_drill(workdir: str) -> dict:
    os.makedirs(workdir, exist_ok=True)
    scenarios = []
    logger.info("quake drill: shard quake (real processes)")
    scenarios.append(scenario_shard_quake(workdir))
    logger.info("quake drill: durable-ack overhead bench")
    scenarios.append(scenario_durable_overhead(workdir))
    logger.info("quake drill: composed master+shard+migration kill")
    scenarios.append(scenario_composed(workdir))
    for s in scenarios:
        # Captured table payloads are for comparison, not the report.
        s.pop("states", None)
    return {
        "drill": "zero_rpo_quake",
        "seed": SEED,
        "config": {
            "table": TABLE, "dim": DIM, "vocab": VOCAB,
            "push_ids": PUSH_IDS,
        },
        "scenarios": scenarios,
        "passed": all(s["passed"] for s in scenarios),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("elasticdl_tpu_torch-quake-drill")
    sub = parser.add_subparsers(dest="command", required=True)
    serve = sub.add_parser("serve")
    serve.add_argument("--port", type=int, required=True)
    serve.add_argument("--shard_id", type=int, default=0)
    serve.add_argument("--checkpoint_dir", default="")
    serve.add_argument("--checkpoint_steps", type=int,
                       default=CHECKPOINT_STEPS)
    serve.add_argument("--push_log_dir", default="")
    serve.add_argument("--push_log_group_ms", type=float, default=2.0)
    serve.add_argument("--push_log_ack", default="durable",
                       choices=["durable", "applied"])
    serve.add_argument("--die_after_migrate_chunks", type=int,
                       default=0)
    serve.add_argument("--optimizer", default="adam",
                       choices=["adam", "sgd"])

    run = sub.add_parser("run")
    run.add_argument("--workdir", required=True)
    run.add_argument("--report", default="",
                     help="default: <workdir>/QUAKE_DRILL.json")
    args = parser.parse_args(argv)

    if args.command == "serve":
        return _serve(args)

    args.report = args.report or os.path.join(args.workdir,
                                              "QUAKE_DRILL.json")
    report = run_drill(args.workdir)
    with open(args.report, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True, default=str)
        fh.write("\n")
    for scenario in report["scenarios"]:
        logger.info(
            "quake drill %s: %s%s", scenario["scenario"],
            "PASS" if scenario["passed"] else "FAIL",
            "" if scenario["passed"]
            else f" ({'; '.join(map(str, scenario['problems']))})",
        )
    logger.info(
        "quake drill: %s; report %s",
        "PASS" if report["passed"] else "FAIL", args.report,
    )
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
