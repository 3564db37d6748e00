"""Fault injection hooks threaded through the framework's seams (port
of elasticdl_tpu/chaos/interceptors.py).

One ``FaultInjector`` owns a ``FaultPlan`` and installs itself into:

- ``comm/rpc.py`` — client hook inside ``RpcStub.call`` (delay / drop
  / error / blackhole / kill before the request leaves) and server
  hook inside the ``_GenericService`` handler wrap (server-site delays
  and aborts, including row-service shard stalls by server tag);
- ``checkpoint/saver.py`` — post-save hook (corrupt the just-published
  version dir), post-restore hook (feeds the version-monotonicity
  invariant checker), and the shard-file fsync seam (``fsync_stall``
  slow-disk brownouts);
- ``storage/pushlog.py`` — group-commit fsync seam (``fsync_stall``
  stalls the WAL commit thread that durable-ack pushes wait on);
- ``master/instance_manager.py`` — observer on kill/relaunch events
  (recovery-latency timing for k8s-mode jobs);
- ``testing/cluster.MiniCluster`` — per-RPC callbacks on
  ``InProcessMaster`` so the no-network test path injects the same
  plan (``in_process_callbacks()``).

Every decision is driven by per-event call counters and per-event
seeded RNGs, so a sequential (single-worker) run replays bit-identical
fault schedules; ``injected`` is the deterministic record the chaos
report embeds. Wall-clock timing (kill→recovery latency) is kept in a
separate, explicitly non-deterministic log.
"""

import os
import random
import threading
import time
from typing import Dict, List, Optional

from elasticdl_tpu_torch.chaos.faults import (
    BLACKHOLE,
    CORRUPT_CHECKPOINT,
    FSYNC_STALL,
    KILL_WORKER,
    MASTER_KILL,
    RPC_DELAY,
    RPC_DROP,
    RPC_ERROR,
    STALL_SHARD,
    FaultPlan,
)
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("chaos")


class ChaosKill(BaseException):
    """Simulated pod death (SIGKILL / exit 137). BaseException on
    purpose: a real SIGKILL is not catchable, so no ``except
    Exception`` in the worker loop may swallow it — only the chaos
    runner (standing in for the instance manager watching pod events)
    handles it. ``finally`` blocks still run, which models the async
    checkpoint write that was already in flight landing on disk."""

    def __init__(self, worker_id: int, event_index: int):
        super().__init__(
            f"chaos: killed worker {worker_id} (event {event_index})"
        )
        self.worker_id = worker_id
        self.event_index = event_index


class FaultInjector:
    """Decides, per matching call/save, whether a plan event fires.

    Thread-safe; deterministic for sequential callers (the decision
    state is per-event counters + per-event ``random.Random`` seeded
    from ``plan.seed`` and the event index)."""

    def __init__(self, plan: FaultPlan, metrics_registry=None):
        self.plan = plan
        self._lock = threading.RLock()
        self._calls: Dict[int, int] = {}   # event idx -> matching calls
        self._fires: Dict[int, int] = {}   # event idx -> fires
        self._saves: Dict[int, int] = {}   # event idx -> matching saves
        self._rngs = {
            i: random.Random((int(plan.seed) << 8) ^ (i + 1))
            for i in range(len(plan.events))
        }
        # Deterministic record of every injected fault, in order.
        self.injected: List[dict] = []
        # Invariant checkers subscribe to save/restore observations.
        self._save_listeners: List[callable] = []
        self._restore_listeners: List[callable] = []
        # Wall-clock recovery log (NOT in the deterministic report
        # core): [{worker_id, new_id, latency_secs}].
        self.recoveries: List[dict] = []
        self._kill_times: Dict[int, float] = {}
        # Master-restart seam: the harness registers a
        # callable that plays the platform's restart-policy role —
        # tear down the master, rebuild it from its write-ahead
        # journal (master/journal.py), re-point the transport. Fired
        # OUTSIDE the injector lock (it rebuilds dispatchers). The
        # wall-clock log mirrors `recoveries` (timings-only section).
        self._master_restart: Optional[callable] = None
        self.master_restarts: List[dict] = []
        from elasticdl_tpu_torch.observability import default_registry

        registry = metrics_registry or default_registry()
        self._m_injected = registry.counter(
            "chaos_faults_injected_total",
            "Faults fired by the chaos plan", ["kind"],
        )
        self._m_kills = registry.counter(
            "chaos_kills_total", "Simulated worker deaths",
        )
        self._m_recoveries = registry.counter(
            "chaos_recoveries_total",
            "Worker kill→relaunch recoveries completed",
        )
        self._m_recovery_secs = registry.histogram(
            "chaos_recovery_seconds",
            "Kill→replacement-running recovery latency",
        )
        self._m_master_kills = registry.counter(
            "chaos_master_kills_total",
            "Simulated master deaths (journal-replay restarts)",
        )

    # ---- install / uninstall -------------------------------------------

    def install(self) -> "FaultInjector":
        from elasticdl_tpu_torch.checkpoint import saver as saver_mod
        from elasticdl_tpu_torch.comm import rpc as rpc_mod
        from elasticdl_tpu_torch.master import instance_manager as im_mod
        from elasticdl_tpu_torch.storage import pushlog as pushlog_mod

        rpc_mod.set_chaos_hooks(
            client=self.client_hook, server=self.server_hook
        )
        saver_mod.set_chaos_hooks(
            post_save=self.on_save, post_restore=self.on_restore,
            fsync=self.fsync_hook,
        )
        pushlog_mod.set_chaos_hooks(fsync=self.fsync_hook)
        im_mod.set_chaos_observer(self.observe_instance_event)
        return self

    def uninstall(self):
        from elasticdl_tpu_torch.checkpoint import saver as saver_mod
        from elasticdl_tpu_torch.comm import rpc as rpc_mod
        from elasticdl_tpu_torch.master import instance_manager as im_mod
        from elasticdl_tpu_torch.storage import pushlog as pushlog_mod

        rpc_mod.set_chaos_hooks(None, None)
        saver_mod.set_chaos_hooks(None, None, None)
        pushlog_mod.set_chaos_hooks(None)
        im_mod.set_chaos_observer(None)

    def set_master_restart(self, fn: Optional[callable]):
        """Register the master-restart seam (the chaos runner's
        ``MiniCluster.restart_master``; in k8s the restart policy +
        journal recovery in master/main.py play this role)."""
        self._master_restart = fn

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    # ---- core decision --------------------------------------------------

    def _should_fire(self, idx: int, event) -> bool:
        """Count this matching call against ``event`` and decide.
        Caller holds the lock."""
        if event.max_fires and self._fires.get(idx, 0) >= event.max_fires:
            return False
        n = self._calls.get(idx, 0) + 1
        self._calls[idx] = n
        if event.at_call > 0:
            lo = event.at_call
            hi = event.at_call + max(1, event.duration_calls)
            return lo <= n < hi
        return self._rngs[idx].random() < event.probability

    def _record(self, idx: int, event, **info):
        self._fires[idx] = self._fires.get(idx, 0) + 1
        entry = {"event": idx, "kind": event.kind,
                 "call": self._calls.get(idx, 0), **info}
        self.injected.append(entry)
        self._m_injected.labels(event.kind).inc()
        logger.warning("chaos fault fired: %s", entry)

    # ---- RPC hooks ------------------------------------------------------

    @staticmethod
    def _rpc_match(event, site: str, target: str, service: str,
                   method: str) -> bool:
        if event.site != site:
            return False
        if event.target and event.target not in (service, target):
            return False
        if event.method and event.method != method:
            return False
        return True

    def client_hook(self, service: str, method: str, request: dict):
        """Installed into ``RpcStub.call``; runs before each send
        attempt. May sleep, raise RpcError (drop/error), or raise
        ChaosKill."""
        from elasticdl_tpu_torch.comm.rpc import RpcError

        action = None
        with self._lock:
            for idx, event in enumerate(self.plan.events):
                if event.kind == MASTER_KILL:
                    # Default boundary is get_task (a dispatch: the
                    # journal tail ends on a dispatch record);
                    # method="report_task_result" kills mid-lease so
                    # the recovered master must resolve the retried
                    # report against the replayed lease.
                    kill_method = event.method or "get_task"
                    if method != kill_method or (
                        event.target and event.target != service
                    ):
                        continue
                    if self._should_fire(idx, event):
                        self._record(idx, event, method=method)
                        self._m_master_kills.inc()
                        action = ("master_kill", idx)
                        break
                elif event.kind == KILL_WORKER:
                    # Default boundary is get_task (a clean task
                    # boundary: nothing leased, loss-equivalent
                    # recovery); event.method can move the death to
                    # e.g. report_task_result to strand a leased task
                    # (at-least-once re-train territory).
                    kill_method = event.method or "get_task"
                    if method != kill_method or (
                        event.target and event.target != service
                    ):
                        continue
                    wid = int(request.get("worker_id", -1))
                    if event.worker_id >= 0 and event.worker_id != wid:
                        continue
                    if self._should_fire(idx, event):
                        self._record(idx, event, worker_id=wid,
                                     method=method)
                        self._m_kills.inc()
                        self._kill_times[wid] = time.monotonic()
                        action = ChaosKill(wid, idx)
                        break
                elif event.kind in (RPC_DROP, RPC_ERROR, RPC_DELAY,
                                    BLACKHOLE):
                    if not self._rpc_match(
                        event, "client", "", service, method
                    ):
                        continue
                    if self._should_fire(idx, event):
                        self._record(idx, event, service=service,
                                     method=method, site="client")
                        if event.kind == RPC_DELAY:
                            action = ("sleep", event.delay_secs)
                        elif event.kind == RPC_ERROR:
                            action = RpcError(
                                f"chaos: injected {event.code} on "
                                f"{service}.{method}", code=event.code,
                            )
                        else:  # drop / blackhole
                            action = RpcError(
                                f"chaos: dropped {service}.{method}",
                                code=event.code,
                            )
                        break
        if action is None:
            return
        if isinstance(action, tuple) and action[0] == "master_kill":
            # The master's memory dies HERE — whatever the journal
            # holds is all the restart seam gets. The in-flight call
            # then fails UNAVAILABLE (the dead master never answered);
            # the worker's transport retry re-sends it against the
            # recovered incarnation.
            self._run_master_restart()
            raise RpcError(
                f"chaos: master killed during {service}.{method}",
                code="UNAVAILABLE",
            )
        if isinstance(action, tuple):
            time.sleep(action[1])
            return
        raise action

    def _run_master_restart(self):
        restart = self._master_restart
        if restart is None:
            logger.error(
                "chaos: master_kill fired but no restart seam is "
                "registered — the outage will never end"
            )
            return
        t0 = time.monotonic()
        restart()
        self.master_restarts.append({
            "latency_secs": time.monotonic() - t0,
        })

    def server_hook(self, tag: str, service: str, method: str,
                    request: dict):
        """Installed into the ``_GenericService`` handler wrap. Returns
        None (proceed) or ``(code, detail)`` to abort the call."""
        verdict = None
        delay = 0.0
        with self._lock:
            for idx, event in enumerate(self.plan.events):
                if event.kind == STALL_SHARD:
                    if tag != f"rowservice/{event.shard}":
                        continue
                    # Method filter: the brownout drill stalls only
                    # the push methods so serving reads on the same
                    # shard stay fast enough to measure shedding.
                    if event.method and event.method != method:
                        continue
                    if self._should_fire(idx, event):
                        self._record(idx, event, tag=tag, method=method)
                        delay = max(delay, event.delay_secs)
                elif event.kind in (RPC_DROP, RPC_ERROR, RPC_DELAY,
                                    BLACKHOLE):
                    if not self._rpc_match(
                        event, "server", tag, service, method
                    ):
                        continue
                    if self._should_fire(idx, event):
                        self._record(idx, event, service=service,
                                     method=method, site="server",
                                     tag=tag)
                        if event.kind == RPC_DELAY:
                            delay = max(delay, event.delay_secs)
                        else:
                            verdict = (
                                event.code,
                                f"chaos: injected {event.code} on "
                                f"{service}.{method}",
                            )
        if delay > 0:
            time.sleep(delay)
        return verdict

    # ---- storage fsync seams -------------------------------------------

    def fsync_hook(self, site: str):
        """Installed into the storage fsync seams: ``site`` is
        ``"pushlog"`` (WAL group commit, commit thread) or
        ``"checkpoint"`` (saver shard-file fsync). Sleeps through any
        matching ``fsync_stall`` window — a slow-disk brownout,
        counted per-seam like every other windowed event."""
        delay = 0.0
        with self._lock:
            for idx, event in enumerate(self.plan.events):
                if event.kind != FSYNC_STALL:
                    continue
                if event.target and event.target != site:
                    continue
                if self._should_fire(idx, event):
                    self._record(idx, event, site=site)
                    delay = max(delay, event.delay_secs)
        if delay > 0:
            time.sleep(delay)

    # ---- in-process (no-RPC) master path -------------------------------

    def in_process_callbacks(
        self, service: str = "elasticdl_tpu.Master"
    ) -> Dict[str, callable]:
        """Per-RPC callbacks for ``InProcessMaster`` so the direct-call
        test path injects the same plan the gRPC path would: each
        master RPC routes through ``client_hook`` with the servicer's
        service name."""
        def make(method):
            def cb(request):
                self.client_hook(service, method, request)
            return cb

        return {
            name: make(name)
            for name in ("get_task", "report_task_result",
                         "report_evaluation_metrics", "report_version")
        }

    # ---- checkpoint hooks ----------------------------------------------

    def on_save(self, checkpoint_dir: str, version: int, vdir: str):
        corrupted = []
        with self._lock:
            for idx, event in enumerate(self.plan.events):
                if event.kind != CORRUPT_CHECKPOINT:
                    continue
                if event.target and event.target not in checkpoint_dir:
                    continue
                if event.max_fires and (
                    self._fires.get(idx, 0) >= event.max_fires
                ):
                    continue
                n = self._saves.get(idx, 0) + 1
                self._saves[idx] = n
                if n != event.at_save:
                    continue
                fname = self._corrupt(vdir, event.corrupt_mode)
                if fname:
                    self._record(
                        idx, event, save=n, version=int(version),
                        mode=event.corrupt_mode,
                        # Relative path: reports must not leak the
                        # (run-specific) workdir.
                        file=f"{os.path.basename(vdir)}/{fname}",
                    )
                    corrupted.append(fname)
        for listener in self._save_listeners:
            listener(checkpoint_dir, version)

    @staticmethod
    def _corrupt(vdir: str, mode: str) -> Optional[str]:
        """Damage the first shard file of a version dir. ``truncate``
        keeps a decodable-looking prefix (tests the decode fallback),
        ``garbage`` rewrites the head so msgpack decodes a non-payload
        value (tests structural validation), ``delete`` removes the
        file (tests the shard-count validity check)."""
        shards = sorted(
            f for f in os.listdir(vdir) if f.endswith(".ckpt")
        )
        if not shards:
            return None
        path = os.path.join(vdir, shards[0])
        if mode == "delete":
            os.remove(path)
            return shards[0]
        with open(path, "rb") as fh:
            blob = fh.read()
        if mode == "truncate":
            blob = blob[: max(1, len(blob) // 2)]
        else:  # garbage
            blob = b"\x00CHAOS" + blob[7:]
        with open(path, "wb") as fh:
            fh.write(blob)
        return shards[0]

    def on_restore(self, checkpoint_dir: str, version: int):
        for listener in self._restore_listeners:
            listener(checkpoint_dir, version)

    def add_checkpoint_listener(self, on_save=None, on_restore=None):
        if on_save is not None:
            self._save_listeners.append(on_save)
        if on_restore is not None:
            self._restore_listeners.append(on_restore)

    # ---- recovery timing ------------------------------------------------

    def observe_instance_event(self, event: str, **info):
        """instance_manager chaos observer: time kill→relaunch."""
        if event in ("kill_worker", "worker_dead"):
            self.note_kill(info["worker_id"])
        elif event == "worker_relaunched":
            self.note_recovered(info["worker_id"], info.get("new_id", -1))

    def note_kill(self, worker_id: int):
        with self._lock:
            self._kill_times.setdefault(worker_id, time.monotonic())

    def note_recovered(self, worker_id: int, new_id: int):
        with self._lock:
            t0 = self._kill_times.pop(worker_id, None)
        if t0 is None:
            return
        latency = time.monotonic() - t0
        self.recoveries.append({
            "worker_id": int(worker_id),
            "new_id": int(new_id),
            "latency_secs": latency,
        })
        self._m_recoveries.inc()
        self._m_recovery_secs.observe(latency)

    # ---- report ---------------------------------------------------------

    def fault_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for entry in self.injected:
            out[entry["kind"]] = out.get(entry["kind"], 0) + 1
        return out

    def metric_families(self) -> dict:
        """The ``edl_tpu_chaos_*`` families reconstructed from the
        injector's own deterministic state (the live registry is
        process-global and accumulates across runs; the report must
        reflect THIS run only, byte-identically). Histogram families
        report only their deterministic ``count``."""
        counts = self.fault_counts()
        return {
            "edl_tpu_chaos_faults_injected_total": {
                "kind": counts
            },
            "edl_tpu_chaos_kills_total": counts.get(KILL_WORKER, 0),
            "edl_tpu_chaos_master_kills_total": counts.get(
                MASTER_KILL, 0
            ),
            "edl_tpu_chaos_recoveries_total": len(self.recoveries),
            "edl_tpu_chaos_recovery_seconds": {
                "count": len(self.recoveries)
            },
        }
