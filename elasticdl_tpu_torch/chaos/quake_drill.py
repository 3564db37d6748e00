"""The quake drill's fleet helpers (port of the helpers of
elasticdl_tpu/chaos/quake_drill.py): real row-service shard processes
(this module's ``serve`` subcommand, with a checkpoint chain and the
write-ahead push log) spawned, SIGKILLed and relaunched by ``RowFleet``,
and the calls, captures and fsck that hold a fleet to a twin.

``python -m elasticdl_tpu_torch.chaos.quake_drill serve --port P
[--checkpoint_dir C --push_log_dir W --push_log_ack durable|applied
--optimizer adam|sgd]`` runs one shard. ``chaos/stream_drill.py`` drives
its fleet through these helpers. The quake drill's own scenarios (the
shard quake, the durable-ack overhead, the composed master + shard +
migration kill) and its ``run`` command are not ported yet (ROADMAP
item 8g).
"""

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("quake_drill")

TABLE = "quake_rows"
DIM = 16
CHECKPOINT_STEPS = 40


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


# ---- driver: shard fleet management ---------------------------------------


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
    args = parser.parse_args(argv)
    return _serve(args)


if __name__ == "__main__":
    sys.exit(main())
