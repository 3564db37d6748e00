"""Brownout drill (port of elasticdl_tpu/chaos/brownout_drill.py): a
slow-disk overload must degrade GRACEFULLY —
shed background work first, keep serving reads fast, cap retry
amplification — and a twin run with every control disabled must show
the inversion the controls exist to prevent.

``python -m elasticdl_tpu_torch.chaos.brownout_drill run --workdir DIR
[--report PATH]`` (exit 0 only if every gate holds; the report defaults
to ``DIR/BROWNOUT_DRILL.json``). Host only: the shards' rows live in
host RAM.

A REAL 2-shard row-service fleet (subprocesses over localhost gRPC,
durable-ack push WAL) takes a mixed principal-tagged workload —
serving reads under a 500ms ambient deadline, training pushes,
replica-refresh background pulls, canary probes — through three
windows: an unstalled **baseline**, a **brownout** (an ``fsync_stall``
fault plan stalls every WAL group commit, so durable-ack pushes pin
worker threads — the slow-disk regime), and a **recovery** window
after the stall lifts.

The drill runs twice:

- **controlled** — admission control in front of each shard
  (``comm/overload.py`` priority tiers), client retry budgets, and
  deadline propagation all on. Gates: brownout serving p99 ≤ 1.5x the
  unstalled baseline (with an absolute floor so a noisy CI box cannot
  fail a sub-millisecond ratio), ≥ 90% of sheds land on background
  purposes (``BACKGROUND_PURPOSES`` + never serving_read), total retry
  amplification ≤ 2x offered load, and 100% goodput for every purpose
  within the recovery window.
- **uncontrolled** — admission off, ``set_controls_enabled(False)``
  (no budgets, no breakers), same workload, same stall. Gates invert:
  zero sheds (nothing protects the fleet), background retry
  amplification exceeds the 2x cap (unbudgeted timeout→retry storms),
  and serving p99 blows through the bound the controlled run meets —
  the priority inversion where background load starves the serving
  path.

The report is validated by
``elasticdl_tpu_torch/tools/check_overload.py``. Latencies are
wall-clock, so the report is not byte-deterministic — the checker
gates on structure and the recorded verdicts, like the other
latency-bearing drills.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("brownout_drill")

TABLE = "brown_rows"
DIM = 8
VOCAB = 50_000
PULL_IDS = 32
PUSH_IDS = 24
NUM_SHARDS = 2

# Per-shard capacity. MAX_WORKERS == PUSHERS_PER_SHARD so the
# uncontrolled brownout genuinely saturates the worker pool (every
# thread pinned by a stalled durable-ack push), while the controlled
# run's admission gate (tier-1 threshold < limit) always leaves
# headroom for serving reads and cheap shed rejections.
MAX_WORKERS = 6
ADMISSION_LIMIT = 6
PUSHERS_PER_SHARD = 6
SERVING_PER_SHARD = 2
BACKGROUND_PER_SHARD = 5
CANARY_PER_SHARD = 1

# fsync_stall per group commit. Group commit acks whole batches, so
# push completions come in BURSTS one commit cycle (~ this delay)
# apart; the background per-attempt timeout sits well under it so an
# unbudgeted client visibly retry-storms while it waits for a burst.
STALL_DELAY_SECS = 0.6
GROUP_MS = 2.0
WARMUP_SECS = 1.0
BASELINE_SECS = 3.0
BROWNOUT_SECS = 6.0
SETTLE_SECS = 2.0            # > retry-after hints + breaker cooldown
RECOVERY_SECS = 3.0

SERVING_DEADLINE_SECS = 0.5  # ambient deadline on every serving read
BG_TIMEOUT_SECS = 0.1        # per-attempt timeout on background pulls
PUSH_TIMEOUT_SECS = 20.0
MAX_ATTEMPTS = {"serving_read": 3, "training": 8,
                "replica_refresh": 6, "canary": 6}
PACING_SECS = {"serving_read": 0.02, "training": 0.08,
               "replica_refresh": 0.02, "canary": 0.03}
PURPOSE_SALT = {"serving_read": 11, "training": 23,
                "replica_refresh": 37, "canary": 53}

MAX_P99_RATIO = 1.5
P99_ABS_FLOOR_SECS = 0.25    # ratio gate floor for sub-ms baselines
MAX_AMPLIFICATION = 2.0
MIN_BACKGROUND_SHED_FRAC = 0.9


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
    from elasticdl_tpu_torch.chaos.faults import FaultPlan
    from elasticdl_tpu_torch.chaos.interceptors import FaultInjector
    from elasticdl_tpu_torch.comm import overload as wl_overload
    from elasticdl_tpu_torch.comm.rpc import RpcServer
    from elasticdl_tpu_torch.embedding.optimizer import SGD
    from elasticdl_tpu_torch.embedding.row_service import (
        SERVICE_NAME,
        HostRowService,
    )
    from elasticdl_tpu_torch.native.row_store import (
        make_host_optimizer,
        make_host_table,
    )
    from elasticdl_tpu_torch.observability import default_registry

    svc = HostRowService(
        {TABLE: make_host_table(TABLE, DIM)},
        make_host_optimizer(SGD(lr=0.01)),
    )
    # Durable acks: the push RPC reply waits on the WAL fsync — the
    # seam the fsync_stall plan stalls, which is what pins handler
    # threads and builds the admission queue depth.
    svc.configure_push_log(
        args.push_log_dir, group_ms=args.push_log_group_ms,
        ack="durable",
    )
    box: Dict[str, FaultInjector] = {}

    def _stall(request: dict) -> dict:
        """Toggle the brownout: install/uninstall a FaultInjector for
        the plan the runner sends, so one server incarnation spans
        baseline → brownout → recovery."""
        if request.get("enable"):
            injector = FaultInjector(FaultPlan.from_dict(
                request["plan"]
            ))
            injector.install()
            box["injector"] = injector
            return {"ok": True}
        injector = box.pop("injector", None)
        fired = 0
        if injector is not None:
            injector.uninstall()
            fired = len(injector.injected)
        return {"ok": True, "fired": fired}

    def _metrics(_request: dict) -> dict:
        return {"metrics": default_registry().snapshot()}

    handlers = dict(svc.handlers())
    handlers["ping"] = lambda _req: {"ok": True, "pid": os.getpid()}
    handlers["drill_stall"] = _stall
    handlers["drill_metrics"] = _metrics
    admission = None
    if args.admission_limit > 0:
        admission = wl_overload.AdmissionController(
            args.admission_limit, tag=f"rowservice/{args.shard_id}"
        )
    server = RpcServer(
        f"localhost:{args.port}", {SERVICE_NAME: handlers},
        max_workers=args.max_workers,
        tag=f"rowservice/{args.shard_id}", admission=admission,
    ).start()
    svc._server = server
    logger.info("brownout shard %d serving on %d (pid %d, "
                "admission_limit=%d)", args.shard_id, server.port,
                os.getpid(), args.admission_limit)
    server.wait()
    return 0


# ---- runner: fleet + control-plane calls ---------------------------------


class _Fleet:
    def __init__(self, workdir: str, admission_limit: int):
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.ports = _free_ports(NUM_SHARDS)
        self.procs: List[subprocess.Popen] = []
        self._logs = []
        for shard, port in enumerate(self.ports):
            cmd = [
                sys.executable, "-m",
                "elasticdl_tpu_torch.chaos.brownout_drill", "serve",
                "--port", str(port), "--shard_id", str(shard),
                "--push_log_dir",
                os.path.join(workdir, f"s{shard}", "pushlog"),
                "--push_log_group_ms", str(GROUP_MS),
                "--max_workers", str(MAX_WORKERS),
                "--admission_limit", str(admission_limit),
            ]
            log = open(os.path.join(
                workdir, f"shard{shard}-{port}.log"
            ), "w")
            self._logs.append(log)
            self.procs.append(subprocess.Popen(
                cmd, cwd=_pkg_root(), stdout=log,
                stderr=subprocess.STDOUT,
            ))

    def stop_all(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in self.procs:
            try:
                proc.wait(timeout=15)
            except Exception:
                proc.kill()
        for log in self._logs:
            log.close()


def _control_call(port: int, method: str, **fields) -> dict:
    """Runner control-plane RPC, tagged tier-0 so the admission gate
    never sheds the drill's own instrumentation."""
    from elasticdl_tpu_torch.comm.rpc import RpcStub
    from elasticdl_tpu_torch.embedding.row_service import SERVICE_NAME
    from elasticdl_tpu_torch.observability import principal as wl_principal

    stub = RpcStub(f"localhost:{port}", SERVICE_NAME, max_retries=2)
    try:
        with wl_principal.pushed(job="brownout", component="drill",
                                 purpose="control"):
            return stub.call(method, timeout=30.0, **fields)
    finally:
        stub.close()


def _wait_shard(port: int, deadline_secs: float = 90.0):
    t0 = time.monotonic()
    last = None
    while time.monotonic() - t0 < deadline_secs:
        try:
            return _control_call(port, "ping")
        except Exception as exc:
            last = exc
            time.sleep(0.1)
    raise TimeoutError(f"shard on port {port} never served: {last}")


def _stall_plan(seed: int) -> dict:
    """Every WAL group commit sleeps STALL_DELAY_SECS while the
    brownout window is enabled (probability 1, unlimited fires — the
    window is bounded by the drill's enable/disable toggles)."""
    from elasticdl_tpu_torch.chaos.faults import FaultEvent, FaultPlan

    return FaultPlan(events=[FaultEvent(
        kind="fsync_stall", target="pushlog",
        probability=1.0, delay_secs=STALL_DELAY_SECS, max_fires=0,
    )], seed=seed).to_dict()


def _shed_counts(port: int) -> Dict[str, int]:
    """overload_shed_total by purpose from one shard's live registry."""
    snap = _control_call(port, "drill_metrics")["metrics"]
    out: Dict[str, int] = {}
    for family in snap.get("families", []):
        if family.get("name") != "edl_tpu_overload_shed_total":
            continue
        for series in family.get("series", []):
            labels = series.get("labels") or ["unknown"]
            out[labels[0]] = (out.get(labels[0], 0)
                              + int(series.get("value", 0)))
    return out


def _shed_delta(before: Dict[str, int], after: Dict[str, int]
                ) -> Dict[str, int]:
    return {
        purpose: after.get(purpose, 0) - before.get(purpose, 0)
        for purpose in sorted(set(before) | set(after))
        if after.get(purpose, 0) - before.get(purpose, 0) > 0
    }


# ---- traffic mix ----------------------------------------------------------


class _PhaseStats:
    """Per-purpose offered/attempt/outcome accounting for one window."""

    def __init__(self):
        self.lock = threading.Lock()
        self.offered: Dict[str, int] = {}
        self.ok: Dict[str, int] = {}
        self.attempts: Dict[str, int] = {}
        self.codes: Dict[str, Dict[str, int]] = {}
        self.latencies: Dict[str, List[float]] = {}

    def record(self, purpose: str, ok: bool, attempts: int,
               secs: float, code: Optional[str]):
        with self.lock:
            self.offered[purpose] = self.offered.get(purpose, 0) + 1
            self.attempts[purpose] = (
                self.attempts.get(purpose, 0) + attempts
            )
            if ok:
                self.ok[purpose] = self.ok.get(purpose, 0) + 1
            elif code:
                per = self.codes.setdefault(purpose, {})
                per[code] = per.get(code, 0) + 1
            self.latencies.setdefault(purpose, []).append(secs)

    def summary(self) -> dict:
        with self.lock:
            out = {}
            for purpose in sorted(self.offered):
                offered = self.offered[purpose]
                lats = sorted(self.latencies.get(purpose, []))
                out[purpose] = {
                    "offered": offered,
                    "ok": self.ok.get(purpose, 0),
                    "attempts": self.attempts.get(purpose, 0),
                    "amplification": round(
                        self.attempts.get(purpose, 0) / offered, 3
                    ),
                    "failure_codes": dict(
                        self.codes.get(purpose, {})
                    ),
                    "p50_secs": round(_pct(lats, 0.5), 5),
                    "p99_secs": round(_pct(lats, 0.99), 5),
                }
            total_offered = sum(self.offered.values())
            total_attempts = sum(self.attempts.values())
            out["_total"] = {
                "offered": total_offered,
                "attempts": total_attempts,
                "amplification": round(
                    total_attempts / max(1, total_offered), 3
                ),
            }
            return out


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(q * len(sorted_vals)))]


def _one_op(stub, method: str, purpose: str, controls: bool,
            timeout: Optional[float], **fields):
    """One budgeted op through a max_retries=0 stub.

    The drill layers its OWN retry loop (so attempts are countable
    per purpose), which is exactly the ``max_retries=0`` layering
    contract from comm/rpc.py: the loop honors the shared per-service
    retry budget, the shed retry-after hint, and the ambient deadline
    — the same discipline as row_service._call_with_retry."""
    from elasticdl_tpu_torch.comm import deadline as wl_deadline
    from elasticdl_tpu_torch.comm import overload as wl_overload
    from elasticdl_tpu_torch.comm.rpc import (
        EXPIRED_DETAIL,
        RETRYABLE_CODES,
        RpcError,
    )
    from elasticdl_tpu_torch.embedding.row_service import SERVICE_NAME

    max_attempts = MAX_ATTEMPTS[purpose]
    attempts = 0
    delay = 0.05
    rng = np.random
    while True:
        attempts += 1
        try:
            stub.call(method, timeout=timeout, **fields)
            if controls:
                wl_overload.retry_budget_for(SERVICE_NAME).on_success()
            return True, attempts, None
        except RpcError as exc:
            code = exc.code
            retryable = (code in RETRYABLE_CODES
                         and EXPIRED_DETAIL not in str(exc)
                         and not wl_deadline.expired())
            if not retryable or attempts >= max_attempts:
                return False, attempts, code
            if controls and not wl_overload.retry_budget_for(
                SERVICE_NAME
            ).try_spend():
                return False, attempts, code
            hint = None
            if code == "RESOURCE_EXHAUSTED":
                hint = wl_overload.parse_retry_after(str(exc))
            sleep_for = (hint if hint is not None else delay) * (
                0.5 + rng.random()
            )
            left = wl_deadline.remaining()
            if left is not None:
                sleep_for = min(sleep_for, max(0.0, left))
            time.sleep(sleep_for)
            delay = min(delay * 2.0, 0.5)


def _traffic_thread(purpose: str, port: int, tid: int, seed: int,
                    controls: bool, wtag: str,
                    stop: threading.Event, stats: _PhaseStats):
    from elasticdl_tpu_torch.comm import deadline as wl_deadline
    from elasticdl_tpu_torch.comm.rpc import RpcStub
    from elasticdl_tpu_torch.embedding.row_service import SERVICE_NAME
    from elasticdl_tpu_torch.observability import principal as wl_principal

    rng = np.random.RandomState(
        seed * 1009 + PURPOSE_SALT[purpose] * 101 + tid
    )
    # max_retries=0: the drill's own loop in _one_op is the retry
    # policy (budgets must not be spent twice per failure).
    stub = RpcStub(f"localhost:{port}", SERVICE_NAME, max_retries=0)
    seq = 0
    try:
        while not stop.is_set():
            t0 = time.monotonic()
            with wl_principal.pushed(job="brownout",
                                     component="drill",
                                     purpose=purpose):
                if purpose == "training":
                    ids = np.unique(rng.randint(
                        0, VOCAB, PUSH_IDS
                    )).astype(np.int64)
                    grads = rng.rand(ids.size, DIM).astype(np.float32)
                    seq += 1
                    ok, attempts, code = _one_op(
                        stub, "push_row_grads", purpose, controls,
                        PUSH_TIMEOUT_SECS, table=TABLE, ids=ids,
                        grads=grads,
                        # The window tag keeps every window's
                        # (client, seq) stream fresh: reusing a
                        # client key across windows would replay
                        # seqs the server has already seen and the
                        # dedup map would drop the pushes before
                        # they ever touch the WAL (no durable wait
                        # -> no brownout).
                        client=f"bd-{wtag}-{port}-{tid}", seq=seq,
                    )
                elif purpose == "serving_read":
                    ids = np.unique(rng.randint(
                        0, VOCAB, PULL_IDS
                    )).astype(np.int64)
                    # The ambient deadline bounds the WHOLE op —
                    # every attempt's hop timeout derives from it and
                    # retries stop when it expires.
                    with wl_deadline.running_out(
                        SERVING_DEADLINE_SECS
                    ):
                        ok, attempts, code = _one_op(
                            stub, "pull_rows", purpose, controls,
                            None, table=TABLE, ids=ids,
                        )
                else:  # replica_refresh / canary background pulls
                    ids = np.unique(rng.randint(
                        0, VOCAB, PULL_IDS
                    )).astype(np.int64)
                    ok, attempts, code = _one_op(
                        stub, "pull_rows", purpose, controls,
                        BG_TIMEOUT_SECS, table=TABLE, ids=ids,
                    )
            stats.record(purpose, ok, attempts,
                         time.monotonic() - t0, code)
            time.sleep(PACING_SECS[purpose])
    finally:
        stub.close()


def _run_window(ports: List[int], secs: float, seed: int,
                controls: bool, wtag: str) -> _PhaseStats:
    stats = _PhaseStats()
    stop = threading.Event()
    threads = []
    mix = (("training", PUSHERS_PER_SHARD),
           ("serving_read", SERVING_PER_SHARD),
           ("replica_refresh", BACKGROUND_PER_SHARD),
           ("canary", CANARY_PER_SHARD))
    for port in ports:
        for purpose, count in mix:
            for tid in range(count):
                threads.append(threading.Thread(
                    target=_traffic_thread,
                    args=(purpose, port, tid, seed, controls, wtag,
                          stop, stats),
                    daemon=True,
                ))
    for t in threads:
        t.start()
    time.sleep(secs)
    stop.set()
    for t in threads:
        t.join(timeout=60.0)
    return stats


# ---- one run (controlled or uncontrolled) --------------------------------


def _run_mode(workdir: str, seed: int, controlled: bool) -> dict:
    from elasticdl_tpu_torch.comm import overload as wl_overload

    mode = "controlled" if controlled else "uncontrolled"
    result = {"mode": mode, "problems": []}
    wl_overload.reset_retry_budgets()
    wl_overload.reset_breakers()
    fleet = _Fleet(
        os.path.join(workdir, mode),
        admission_limit=ADMISSION_LIMIT if controlled else 0,
    )
    restore_controls = wl_overload.controls_enabled()
    try:
        if not controlled:
            wl_overload.set_controls_enabled(False)
        for port in fleet.ports:
            _wait_shard(port)
        # Warmup: lazy init (channels, first group commit) off the
        # measured windows.
        _run_window(fleet.ports, WARMUP_SECS, seed, controlled,
                    "warm")

        logger.info("%s: baseline window (%.0fs)", mode,
                    BASELINE_SECS)
        baseline = _run_window(
            fleet.ports, BASELINE_SECS, seed + 1, controlled, "base"
        )
        result["baseline"] = baseline.summary()

        sheds_before = {
            port: _shed_counts(port) for port in fleet.ports
        }
        plan = _stall_plan(seed)
        for port in fleet.ports:
            _control_call(port, "drill_stall", enable=True, plan=plan)
        logger.info("%s: brownout window (%.0fs, fsync_stall %.2fs "
                    "per commit)", mode, BROWNOUT_SECS,
                    STALL_DELAY_SECS)
        brownout = _run_window(
            fleet.ports, BROWNOUT_SECS, seed + 2, controlled, "brown"
        )
        result["brownout"] = brownout.summary()
        stall_fired = 0
        for port in fleet.ports:
            resp = _control_call(port, "drill_stall", enable=False)
            stall_fired += int(resp.get("fired", 0))
        result["stall_fired"] = stall_fired
        if stall_fired <= 0:
            result["problems"].append(
                f"{mode}: fsync_stall never fired — no brownout "
                "actually happened"
            )
        sheds_after = {
            port: _shed_counts(port) for port in fleet.ports
        }
        sheds: Dict[str, int] = {}
        for port in fleet.ports:
            for purpose, n in _shed_delta(
                sheds_before[port], sheds_after[port]
            ).items():
                sheds[purpose] = sheds.get(purpose, 0) + n
        result["sheds"] = sheds

        time.sleep(SETTLE_SECS)
        logger.info("%s: recovery window (%.0fs)", mode,
                    RECOVERY_SECS)
        recovery = _run_window(
            fleet.ports, RECOVERY_SECS, seed + 3, controlled, "rec"
        )
        result["recovery"] = recovery.summary()
    finally:
        wl_overload.set_controls_enabled(restore_controls)
        fleet.stop_all()
    return result


# ---- gates ----------------------------------------------------------------


def _serving_bound(summary: dict) -> float:
    base_p99 = summary.get("serving_read", {}).get("p99_secs", 0.0)
    return max(MAX_P99_RATIO * base_p99, P99_ABS_FLOOR_SECS)


def evaluate_gates(controlled: dict, uncontrolled: dict) -> List[dict]:
    from elasticdl_tpu_torch.comm.overload import BACKGROUND_PURPOSES

    gates = []

    def gate(name: str, passed: bool, observed, bound):
        gates.append({"name": name, "passed": bool(passed),
                      "observed": observed, "bound": bound})

    # 1. Serving p99 through the brownout stays near baseline.
    bound = round(_serving_bound(controlled["baseline"]), 5)
    p99 = controlled["brownout"].get(
        "serving_read", {}
    ).get("p99_secs", 0.0)
    gate("controlled_serving_p99", p99 <= bound, p99, bound)

    # 2. Sheds happened, and >= 90% landed on background purposes
    # (and none on serving reads).
    sheds = controlled.get("sheds", {})
    total = sum(sheds.values())
    background = sum(
        n for p, n in sheds.items() if p in BACKGROUND_PURPOSES
    )
    frac = background / total if total else 0.0
    gate("controlled_sheds_background_frac",
         total > 0 and frac >= MIN_BACKGROUND_SHED_FRAC
         and sheds.get("serving_read", 0) == 0,
         {"total": total, "background_frac": round(frac, 3),
          "serving_shed": sheds.get("serving_read", 0)},
         {"min_background_frac": MIN_BACKGROUND_SHED_FRAC,
          "serving_shed": 0})

    # 3. Retry amplification capped by the budget.
    amp = controlled["brownout"]["_total"]["amplification"]
    gate("controlled_amplification", amp <= MAX_AMPLIFICATION,
         amp, MAX_AMPLIFICATION)

    # 4. Goodput is 100% for every purpose within the recovery window.
    recovery = controlled["recovery"]
    losses = {
        p: {"offered": s["offered"], "ok": s["ok"]}
        for p, s in recovery.items()
        if p != "_total" and s["ok"] < s["offered"]
    }
    gate("controlled_recovery_goodput", not losses,
         losses or "100%", "100% per purpose")

    # 5. The no-control twin sheds nothing (there is no gate to shed).
    un_sheds = sum(uncontrolled.get("sheds", {}).values())
    gate("uncontrolled_no_sheds", un_sheds == 0, un_sheds, 0)

    # 6. ...and its unbudgeted background retries blow the 2x cap.
    un_bg_amp = max(
        (uncontrolled["brownout"].get(p, {}).get("amplification", 0.0)
         for p in BACKGROUND_PURPOSES), default=0.0,
    )
    gate("uncontrolled_background_amplification",
         un_bg_amp > MAX_AMPLIFICATION, un_bg_amp,
         {"exceeds": MAX_AMPLIFICATION})

    # 7. ...and serving inverts: its p99 blows through the bound the
    # controlled run meets (background load starving the serving
    # path).
    un_bound = round(_serving_bound(uncontrolled["baseline"]), 5)
    un_p99 = uncontrolled["brownout"].get(
        "serving_read", {}
    ).get("p99_secs", 0.0)
    gate("uncontrolled_serving_inversion", un_p99 > un_bound,
         un_p99, {"exceeds": un_bound})
    return gates


def run_drill(workdir: str, seed: int) -> dict:
    os.makedirs(workdir, exist_ok=True)
    logger.info("brownout drill: controlled run")
    controlled = _run_mode(workdir, seed, controlled=True)
    logger.info("brownout drill: uncontrolled (no-control) run")
    uncontrolled = _run_mode(workdir, seed, controlled=False)
    gates = evaluate_gates(controlled, uncontrolled)
    problems = list(controlled["problems"])
    problems += uncontrolled["problems"]
    problems += [
        f"gate {g['name']}: observed {g['observed']!r}, "
        f"bound {g['bound']!r}"
        for g in gates if not g["passed"]
    ]
    return {
        "drill": "brownout",
        "seed": int(seed),
        "config": {
            "table": TABLE, "dim": DIM, "vocab": VOCAB,
            "num_shards": NUM_SHARDS,
            "max_workers": MAX_WORKERS,
            "admission_limit": ADMISSION_LIMIT,
            "stall_delay_secs": STALL_DELAY_SECS,
            "serving_deadline_secs": SERVING_DEADLINE_SECS,
            "baseline_secs": BASELINE_SECS,
            "brownout_secs": BROWNOUT_SECS,
            "recovery_secs": RECOVERY_SECS,
            "max_p99_ratio": MAX_P99_RATIO,
            "p99_abs_floor_secs": P99_ABS_FLOOR_SECS,
            "max_amplification": MAX_AMPLIFICATION,
            "min_background_shed_frac": MIN_BACKGROUND_SHED_FRAC,
        },
        "runs": {"controlled": controlled,
                 "uncontrolled": uncontrolled},
        "gates": gates,
        "problems": problems,
        "passed": not problems,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("elasticdl_tpu_torch-brownout-drill")
    sub = parser.add_subparsers(dest="command", required=True)
    serve = sub.add_parser("serve")
    serve.add_argument("--port", type=int, required=True)
    serve.add_argument("--shard_id", type=int, default=0)
    serve.add_argument("--push_log_dir", required=True)
    serve.add_argument("--push_log_group_ms", type=float,
                       default=GROUP_MS)
    serve.add_argument("--max_workers", type=int, default=MAX_WORKERS)
    serve.add_argument("--admission_limit", type=int, default=0)

    run = sub.add_parser("run")
    run.add_argument("--seed", type=int, default=7)
    run.add_argument("--workdir", required=True)
    run.add_argument("--report", default="",
                     help="default: <workdir>/BROWNOUT_DRILL.json")
    args = parser.parse_args(argv)

    if args.command == "serve":
        return _serve(args)
    args.report = args.report or os.path.join(args.workdir,
                                              "BROWNOUT_DRILL.json")

    report = run_drill(args.workdir, args.seed)
    with open(args.report, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True, default=str)
        fh.write("\n")
    for g in report["gates"]:
        logger.info("brownout gate %s: %s (observed %r, bound %r)",
                    g["name"], "PASS" if g["passed"] else "FAIL",
                    g["observed"], g["bound"])
    logger.info("brownout drill: %s; report %s",
                "PASS" if report["passed"] else "FAIL", args.report)
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
