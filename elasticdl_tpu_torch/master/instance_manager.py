"""Pod lifecycle + elasticity core (port of
elasticdl_tpu/master/instance_manager.py; reference
master/k8s_instance_manager.py).

The reference's ``InstanceManager`` starts worker/PS pods, watches pod
events, detects preemption (DELETED, or Failed with exit code 137 =
SIGKILL/OOM, reference k8s_instance_manager.py:250-271), re-queues the dead
worker's tasks and relaunches it under a **new** worker id
(reference :297-302). There is no PS here — state lives on the mesh and in
sharded checkpoints — so only the worker plane is managed; a relaunched
worker re-enters training by restoring the latest checkpoint and pulling
tasks (SURVEY.md §7.5).

Events are normalized through ``classify_pod_event`` so tests drive the
manager with plain dicts and no cluster (SURVEY.md §4 lesson).
"""

import itertools
import threading
from typing import Callable, Dict, List, Optional

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.platform.k8s_client import (
    ELASTICDL_REPLICA_INDEX_KEY,
    ELASTICDL_REPLICA_TYPE_KEY,
    build_pod_manifest,
    build_row_service_service_manifest,
    get_row_service_pod_name,
    get_row_service_service_name,
    get_worker_pod_name,
)

logger = get_logger("instance_manager")

# Exit code meaning "killed" (preemption / OOM), reference :250-271.
_EXIT_KILLED = 137

# ---- chaos seam (chaos/interceptors.py installs) -----------------------
# _chaos_observer(event, **info) with events "kill_worker" (a straggler
# kill was issued), "worker_dead" (recovery started: tasks re-queued)
# and "worker_relaunched" (replacement started) — the chaos plane times
# kill→relaunch recovery latency off these without the manager knowing
# chaos exists.
_chaos_observer: Optional[Callable] = None


def set_chaos_observer(fn: Optional[Callable]):
    global _chaos_observer
    _chaos_observer = fn


def _observe(event: str, **info):
    if _chaos_observer is not None:
        _chaos_observer(event, **info)


def classify_pod_event(event) -> Optional[dict]:
    """Normalize a k8s watch event (V1Pod or dict) to
    ``{type, name, replica_type, replica_index, phase, exit_code}``."""
    etype = event.get("type") if isinstance(event, dict) else event["type"]
    obj = event.get("object") if isinstance(event, dict) else None
    if obj is None:
        return None
    if isinstance(obj, dict):  # test path / raw dict from watch
        meta = obj.get("metadata", {})
        labels = meta.get("labels", {})
        name = meta.get("name", "")
        phase = obj.get("status", {}).get("phase", "")
        exit_code = obj.get("status", {}).get("exit_code")
    else:  # kubernetes V1Pod
        labels = obj.metadata.labels or {}
        name = obj.metadata.name
        phase = obj.status.phase if obj.status else ""
        exit_code = None
        statuses = (obj.status.container_statuses or []) if obj.status else []
        for cs in statuses:
            term = cs.state.terminated if cs.state else None
            if term is not None:
                exit_code = term.exit_code
    index = labels.get(ELASTICDL_REPLICA_INDEX_KEY)
    return {
        "type": etype,
        "name": name,
        "replica_type": labels.get(ELASTICDL_REPLICA_TYPE_KEY, ""),
        "replica_index": int(index) if index is not None else -1,
        "phase": phase,
        "exit_code": exit_code,
    }


class InstanceManager:
    def __init__(
        self,
        task_dispatcher,
        k8s_client,
        job_name: str,
        image_name: str,
        worker_command: Callable[[int], List[str]],
        num_workers: int = 1,
        namespace: str = "default",
        worker_resource_request: str = "cpu=1,memory=4096Mi",
        worker_resource_limit: str = "",
        volume: str = "",
        envs: Optional[Dict[str, str]] = None,
        restart_policy: str = "Never",
        owner: Optional[dict] = None,
        max_relaunches: int = 0,  # 0 = unlimited (reference relaunches
        # for the life of the job; task retries are capped instead)
        on_worker_relaunch: Optional[Callable[[int, int], None]] = None,
        multihost: bool = False,
        row_service_command: Optional[Callable[[int], List[str]]] = None,
        row_service_resource_request: str = "cpu=1,memory=4096Mi",
        row_service_resource_limit: str = "",
        num_row_service_shards: int = 1,
        journal=None,
    ):
        self._task_d = task_dispatcher
        self._client = k8s_client
        self._job_name = job_name
        self._image = image_name
        self._worker_command = worker_command
        self._num_workers = num_workers
        self._namespace = namespace
        self._resource_request = worker_resource_request
        self._resource_limit = worker_resource_limit
        self._volume = volume
        self._envs = envs or {}
        self._restart_policy = restart_policy
        self._owner = owner
        self._max_relaunches = max_relaunches
        self._on_worker_relaunch = on_worker_relaunch
        self._lock = threading.Lock()
        # live worker ids -> pod name; next id is monotonically fresh
        # (relaunched workers get NEW ids, reference :297-302).
        self._worker_pods: Dict[int, str] = {}
        self._next_worker_id = itertools.count(num_workers)
        self._relaunch_count = 0
        self._stopped = False
        # Multi-host jobs (torch.distributed) restart as a GANG: one death
        # invalidates every process's mesh, so all workers are deleted
        # and relaunched with their ORIGINAL ids (stable process ids;
        # docs/designs/multihost.md). Each gang generation gets a pod-
        # name suffix: k8s deletion is async, so recreating the same
        # name would 409, and the suffix also lets stale events for old
        # pods be recognized (name mismatch) instead of cascading.
        self._multihost = multihost
        self._generation = 0
        # Master write-ahead journal (master/journal.py): gang and
        # row-service relaunch generations append as ``relaunch``
        # records, so a recovered master adopts pods under their TRUE
        # (generation-suffixed) names instead of discarding their
        # death events as stale — the former "known limitation" in
        # docs/fault_tolerance.md.
        self._journal = journal
        # Host-tier row service (reference PS pod lifecycle: fixed
        # per-shard service names, relaunch on death —
        # k8s_instance_manager.py:303-308). One pod per shard (rows by
        # id % N client-side, row_service._ShardedTable); each shard's
        # state survives via its own checkpoint (row_service.py), which
        # the reference PS also relied on when re-init from workers
        # wasn't possible. ``row_service_command(shard)`` builds the
        # per-shard process command.
        self._row_service_command = row_service_command
        self._num_rs_shards = max(1, int(num_row_service_shards))
        # Dedicated sizing: the CPU-only row pods must not inherit the
        # workers' accelerator-sized resources (reference had its own
        # --ps_resource_* knobs).
        self._rs_resource_request = row_service_resource_request
        self._rs_resource_limit = row_service_resource_limit
        self._row_service_pods: Dict[int, str] = {}  # shard -> pod name
        self._rs_generation: Dict[int, int] = {}
        self._rs_relaunch_count = 0

    def _journal_relaunch(self, kind: str, generation: int,
                          shard: int = -1):
        """Persist a relaunch-generation bump BEFORE the replacement
        pod is created: a master crash between the bump and the
        create leaves the journal naming a pod that may not exist —
        harmless (its absence surfaces as watch events / straggler
        timeouts) — while the reverse order would leave a live pod
        the recovered master cannot recognize."""
        if self._journal is None:
            return
        try:
            self._journal.append(
                "relaunch", kind=str(kind),
                generation=int(generation), shard=int(shard),
            )
        except Exception as exc:
            # A fenced/failed append must not abort the relaunch path
            # (the pod plane is still this incarnation's to clean up);
            # the fencing rejection surfaces on the RPC plane.
            logger.warning("journal relaunch append failed: %s", exc)

    # ---- pod creation ---------------------------------------------------

    def _start_worker(self, worker_id: int):
        name = get_worker_pod_name(self._job_name, worker_id)
        if self._multihost and self._generation:
            name = f"{name}-g{self._generation}"
        manifest = build_pod_manifest(
            name=name,
            job_name=self._job_name,
            replica_type="worker",
            replica_index=worker_id,
            image=self._image,
            command=self._worker_command(worker_id),
            namespace=self._namespace,
            resource_request=self._resource_request,
            resource_limit=self._resource_limit,
            volume=self._volume,
            envs=self._envs,
            restart_policy=self._restart_policy,
            owner=self._owner,
        )
        self._client.create_pod(manifest)
        with self._lock:
            self._worker_pods[worker_id] = name
        logger.info("Started worker %d (%s)", worker_id, name)

    def start_workers(self):
        for worker_id in range(self._num_workers):
            self._start_worker(worker_id)

    # ---- master-restart adoption (master/journal.py recovery) ----------

    def adopt_workers(self, worker_ids, gang_generation: int = 0):
        """Track already-running worker pods instead of creating them
        (a recovered master re-attaches to the job it crashed out of).
        Pod names are reconstructed from the deterministic naming
        scheme; ids that died during the outage produce watch events /
        straggler timeouts against these names and recover through the
        normal dead-worker path. The fresh-id counter advances past
        every adopted id so relaunches never reuse one.

        ``gang_generation`` is the journal's replayed multihost
        gang-restart generation (``relaunch`` records): pods live
        under ``-gN``-suffixed names after a gang restart, and
        adopting them suffix-less would discard their death events as
        stale (the pre-journal known limitation)."""
        with self._lock:
            self._generation = max(self._generation,
                                   int(gang_generation))
            top = self._num_workers
            for wid in worker_ids:
                name = get_worker_pod_name(self._job_name, wid)
                if self._multihost and self._generation:
                    name = f"{name}-g{self._generation}"
                self._worker_pods[int(wid)] = name
                top = max(top, int(wid) + 1)
            self._next_worker_id = itertools.count(top)
        logger.info(
            "adopted %d running worker pod(s) after master restart "
            "(gang generation %d)",
            len(self._worker_pods), self._generation,
        )

    def adopt_row_service(self, generations: Optional[Dict[int, int]]
                          = None):
        """Track the (still-running) per-shard row-service pods after
        a master restart; their stable Services already exist.
        ``generations`` is the journal's replayed per-shard relaunch
        map (``relaunch`` records): a shard that relaunched before
        the crash lives under its bumped pod-name generation, and its
        next death is only detected when we track that name."""
        if self._row_service_command is None:
            return
        with self._lock:
            for shard, generation in (generations or {}).items():
                self._rs_generation[int(shard)] = max(
                    self._rs_generation.get(int(shard), 0),
                    int(generation),
                )
                # A shard ADDED after startup (add_row_service_shard
                # journals generation 0) lives beyond the configured
                # count; adopt it too, or its next death goes
                # undetected.
                self._num_rs_shards = max(
                    self._num_rs_shards, int(shard) + 1
                )
            for shard in range(self._num_rs_shards):
                self._row_service_pods[shard] = (
                    get_row_service_pod_name(
                        self._job_name,
                        self._rs_generation.get(shard, 0),
                        shard=shard,
                    )
                )
        logger.info(
            "adopted %d row-service pod(s) after master restart "
            "(relaunch generations %s)",
            self._num_rs_shards, dict(self._rs_generation),
        )

    # ---- row service (PS-pod lifecycle) --------------------------------

    def start_row_service(self):
        """Create the per-shard stable Services + serving pods."""
        if self._row_service_command is None:
            return
        for shard in range(self._num_rs_shards):
            self._client.create_service(
                build_row_service_service_manifest(
                    self._job_name, namespace=self._namespace,
                    shard=shard,
                )
            )
            self._start_row_service_pod(shard)

    def _start_row_service_pod(self, shard: int):
        with self._lock:
            if self._stopped:
                # A death event racing stop() must not recreate a pod
                # nothing will ever delete (same re-check the worker
                # relaunch path does).
                return
            name = get_row_service_pod_name(
                self._job_name, self._rs_generation.get(shard, 0),
                shard=shard,
            )
        manifest = build_pod_manifest(
            name=name,
            job_name=self._job_name,
            replica_type="rowservice",
            replica_index=shard,
            image=self._image,
            command=self._row_service_command(shard),
            namespace=self._namespace,
            resource_request=self._rs_resource_request,
            resource_limit=self._rs_resource_limit,
            volume=self._volume,
            envs=self._envs,
            restart_policy=self._restart_policy,
            owner=self._owner,
        )
        self._client.create_pod(manifest)
        with self._lock:
            self._row_service_pods[shard] = name
        logger.info("Started row service pod %s (shard %d)", name, shard)

    def _handle_dead_row_service(self, shard: int):
        """Same stable per-shard service name, fresh pod generation;
        workers ride the outage on their RPC retry/backoff (generous
        default budget, row_service.make_remote_engine) and the
        relaunched pod restores from its own checkpoint
        (row_service.py). Unlike workers, ANY failure relaunches: the
        service runs no user code, so the crash-loop concern behind the
        workers' exit-137-only policy does not apply; max_relaunches
        (when set) still bounds it (budget shared across shards)."""
        with self._lock:
            if self._stopped:
                return
            if self._max_relaunches and (
                self._rs_relaunch_count >= self._max_relaunches
            ):
                logger.error(
                    "Row service relaunch budget (%d) exhausted",
                    self._max_relaunches,
                )
                return
            self._rs_relaunch_count += 1
            self._rs_generation[shard] = (
                self._rs_generation.get(shard, 0) + 1
            )
            generation = self._rs_generation[shard]
        self._journal_relaunch("row_service", generation, shard=shard)
        logger.warning(
            "Row service shard %d pod died; relaunching "
            "(generation %d)", shard, generation,
        )
        self._start_row_service_pod(shard)

    def add_row_service_shard(self) -> Optional[int]:
        """Spawn one MORE row-service pod (stable Service + pod) under
        the next shard index — the autoscaler's pod-closing half of a
        live ``split`` (row_reshard.ShardMapController): the pod must
        exist and serve before the shard map routes ranges to it.
        Journaled as a generation-0 relaunch record BEFORE the create
        (the same order every relaunch uses), so a recovered master
        adopts the grown fleet instead of forgetting the extra pod.
        Returns the new shard index, or None when row service is off
        or the manager is stopped."""
        if self._row_service_command is None:
            return None
        with self._lock:
            if self._stopped:
                return None
            shard = self._num_rs_shards
            self._num_rs_shards += 1
            self._rs_generation.setdefault(shard, 0)
        self._journal_relaunch(
            "row_service", self._rs_generation.get(shard, 0),
            shard=shard,
        )
        self._client.create_service(
            build_row_service_service_manifest(
                self._job_name, namespace=self._namespace, shard=shard,
            )
        )
        self._start_row_service_pod(shard)
        logger.info("scaled up row service: added shard %d", shard)
        return shard

    def drain_row_service_shard(self, shard: int) -> bool:
        """Tear down one row-service pod + its Service WITHOUT
        relaunching — the pod-closing half of a completed ``merge``:
        call only AFTER the shard-map controller retired the shard
        (tick() returned ``retire:N``), i.e. the map no longer routes
        any range here and every row moved off. Untracked before
        deletion so the DELETED watch event matches nothing and the
        dead-row-service relaunch path never fires (the drain_worker
        pattern). Returns False when the shard is not tracked."""
        shard = int(shard)
        with self._lock:
            name = self._row_service_pods.pop(shard, None)
            if name is None:
                return False
            self._rs_generation.pop(shard, None)
            # Shrink the count only from the top — interior indices
            # stay burned (shard ids never recycle, like worker ids).
            while (self._num_rs_shards > 1
                   and (self._num_rs_shards - 1)
                   not in self._row_service_pods):
                self._num_rs_shards -= 1
        try:
            self._client.delete_pod(name)
        except Exception as exc:
            logger.warning("deleting drained row-service pod %s "
                           "failed: %s", name, exc)
        try:
            self._client.delete_service(
                get_row_service_service_name(self._job_name,
                                             shard=shard)
            )
        except Exception as exc:
            logger.warning("deleting drained row-service service "
                           "(shard %d) failed: %s", shard, exc)
        logger.info("drained row service shard %d (%s)", shard, name)
        return True

    def row_service_shards(self) -> Dict[int, str]:
        """shard -> tracked pod name (the pod scaler's view)."""
        with self._lock:
            return dict(self._row_service_pods)

    # ---- event handling -------------------------------------------------

    def _event_cb(self, event):
        """k8s watch callback (reference :219-308)."""
        info = classify_pod_event(event)
        if info is None:
            return
        if info["replica_type"] == "rowservice":
            dead = info["type"] == "DELETED" or info["phase"] == "Failed"
            with self._lock:
                # Map the event back to its shard by tracked pod name
                # (stale generations mismatch and are ignored, same as
                # the worker path).
                shard = next(
                    (
                        s for s, pod in self._row_service_pods.items()
                        if pod == info["name"]
                    ),
                    None,
                )
            if dead and shard is not None:
                self._handle_dead_row_service(shard)
            return
        if info["replica_type"] != "worker":
            return
        worker_id = info["replica_index"]
        # Relaunch only involuntary deaths: DELETED (preempted pod) or
        # Failed with exit 137 (SIGKILL/OOM). A worker that failed on its
        # own exit code crashed on user code — relaunching would loop
        # (reference :250-271).
        dead = info["type"] == "DELETED" or (
            info["phase"] == "Failed" and info["exit_code"] == _EXIT_KILLED
        )
        if not dead:
            return
        with self._lock:
            if self._stopped or worker_id not in self._worker_pods:
                return
            if self._worker_pods[worker_id] != info["name"]:
                # Stale event for a previous generation's pod (e.g. the
                # deletions a gang restart itself caused) — the tracked
                # pod is a newer one with a different name.
                return
            del self._worker_pods[worker_id]
        self._handle_dead_worker(worker_id)

    def _handle_dead_worker(self, worker_id: int):
        if self._multihost:
            self._handle_dead_worker_multihost(worker_id)
            return
        _observe("worker_dead", worker_id=worker_id)
        requeued = self._task_d.recover_tasks(worker_id)
        logger.info(
            "Worker %d died; re-queued %s task(s)", worker_id, requeued
        )
        with self._lock:
            # Re-check under the lock: a concurrent stop() may have run
            # since the event was classified — relaunching now would leak
            # a pod nothing will ever delete.
            if self._stopped:
                return
            if self._max_relaunches and (
                self._relaunch_count >= self._max_relaunches
            ):
                logger.warning(
                    "Relaunch budget (%d) exhausted; not replacing "
                    "worker %d", self._max_relaunches, worker_id,
                )
                return
            self._relaunch_count += 1
            new_id = next(self._next_worker_id)
        self._start_worker(new_id)
        _observe("worker_relaunched", worker_id=worker_id, new_id=new_id)
        if self._on_worker_relaunch is not None:
            self._on_worker_relaunch(worker_id, new_id)

    def _handle_dead_worker_multihost(self, worker_id: int):
        """Gang restart: one dead process invalidates every process's
        torch.distributed mesh, so delete ALL workers and relaunch the
        full set with their original ids (process ids must be stable)
        under a new pod-name generation. Workers resume from the rolling
        checkpoint (worker/main.py resolve_init_checkpoint)."""
        # The dead worker's tasks always re-queue, even when the budget
        # is spent — stuck `doing` tasks would hang the job forever.
        self._task_d.recover_tasks(worker_id)
        with self._lock:
            if self._stopped:
                return
            if self._max_relaunches and (
                self._relaunch_count >= self._max_relaunches
            ):
                logger.warning(
                    "Relaunch budget (%d) exhausted; not gang-"
                    "restarting after worker %d died",
                    self._max_relaunches, worker_id,
                )
                return
            self._relaunch_count += 1
            self._generation += 1
            generation = self._generation
            live = dict(self._worker_pods)
            live.pop(worker_id, None)
            self._worker_pods.clear()
        self._journal_relaunch("gang", generation)
        logger.info(
            "Multi-host gang restart (generation %d): worker %d died; "
            "deleting %d peer(s), relaunching all %d with original ids",
            self._generation, worker_id, len(live), self._num_workers,
        )
        for wid, pod_name in live.items():
            self._task_d.recover_tasks(wid)
            try:
                self._client.delete_pod(pod_name)
            except Exception as exc:
                logger.warning("deleting %s failed: %s", pod_name, exc)
        for wid in range(self._num_workers):
            self._start_worker(wid)
        if self._on_worker_relaunch is not None:
            self._on_worker_relaunch(worker_id, worker_id)

    # ---- elastic scaling (master/autoscaler.py) -------------------------

    def scale_up(self, count: int = 1) -> List[int]:
        """Add ``count`` workers under fresh ids (the same id scheme
        relaunches use — ids never recycle). Returns the new ids."""
        new_ids = []
        for _ in range(max(0, int(count))):
            with self._lock:
                if self._stopped:
                    break
                new_id = next(self._next_worker_id)
            self._start_worker(new_id)
            new_ids.append(new_id)
        if new_ids:
            logger.info("scaled up: started worker(s) %s", new_ids)
        return new_ids

    def drain_worker(self, worker_id: int) -> bool:
        """Scale-down: remove ``worker_id`` WITHOUT relaunching it.

        The pod is untracked before deletion, so its DELETED watch
        event matches nothing and the ``_handle_dead_worker`` relaunch
        path never fires — the one behavioral difference from a death.
        Its in-flight tasks re-queue exactly once here: if the worker's
        SIGTERM grace also hands a task back, the dispatcher's resolved
        ledger answers that late report with the original requeue
        outcome instead of double-queueing. Returns False when the id
        is not live."""
        with self._lock:
            name = self._worker_pods.pop(worker_id, None)
        if name is None:
            return False
        _observe("worker_drained", worker_id=worker_id)
        # Fence BEFORE the pod deletion: the dying worker keeps polling
        # through its SIGTERM grace, and a fresh lease taken after this
        # point would have no death event to recover it (the DELETED
        # event is deliberately ignored below).
        fence = getattr(self._task_d, "fence_worker", None)
        if fence is not None:
            fence(worker_id)
        try:
            self._client.delete_pod(name)
        except Exception as exc:
            logger.warning("deleting drained pod %s failed: %s",
                           name, exc)
        requeued = self._task_d.recover_tasks(worker_id)
        logger.info(
            "drained worker %d (%s); re-queued %s task(s)",
            worker_id, name, requeued,
        )
        return True

    # ---- straggler handling ---------------------------------------------

    def kill_worker(self, worker_id: int):
        """Delete a stuck worker's pod; the DELETED event then triggers
        recovery (reference master.py:487-509 timeout path). If the pod
        is already gone (delete returns None on 404 — e.g. it was
        preempted during a watch-stream reconnect gap, whose DELETED
        event was lost), run the dead-worker path directly: without this
        the task would sit in `doing` forever and the job would hang."""
        with self._lock:
            name = self._worker_pods.get(worker_id)
        if name is None:
            return
        _observe("kill_worker", worker_id=worker_id)
        result = self._client.delete_pod(name)
        if result is None:
            with self._lock:
                if worker_id not in self._worker_pods:
                    return
                del self._worker_pods[worker_id]
            self._handle_dead_worker(worker_id)

    # ---- lifecycle ------------------------------------------------------

    def start_watch(self):
        thread = threading.Thread(
            target=self._client.watch_job_pods,
            args=(self._job_name, self._event_cb),
            kwargs={"stop": lambda: self._stopped},
            daemon=True,
        )
        thread.start()
        return thread

    def stop(self):
        with self._lock:
            self._stopped = True
            pods = list(self._worker_pods.values())
            self._worker_pods.clear()
            pods.extend(self._row_service_pods.values())
            self._row_service_pods.clear()
        for name in pods:
            self._client.delete_pod(name)

    @property
    def live_workers(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._worker_pods)
