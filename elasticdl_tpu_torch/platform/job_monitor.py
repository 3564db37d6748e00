"""Job / pod completion monitoring (port of
elasticdl_tpu/platform/job_monitor.py).

Counterpart of the reference's ``common/k8s_job_monitor.py`` (PodMonitor
polls one pod to completion and prints failure logs; EdlJobMonitor
checks every replica of a job). TPU-native shape: one monitor polls the
master pod — the job's lifetime — while reporting a per-replica-type
phase snapshot (workers, the row-service pod) each tick, and tails the
master log on failure.
"""

import time
from typing import Dict, Optional

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.platform.k8s_client import (
    ELASTICDL_REPLICA_TYPE_KEY,
    get_master_pod_name,
)

logger = get_logger("job_monitor")

SUCCEEDED = "Succeeded"
FAILED = "Failed"

# Three-valued wait outcome: a pod last seen Running that then vanishes
# for good is UNKNOWN — it may have finished fast and been GC-deleted
# between polls, or been evicted/killed without ever succeeding. Only an
# observed Succeeded phase proves success; never-seen proves failure.
OUTCOME_SUCCEEDED = "succeeded"
OUTCOME_FAILED = "failed"
OUTCOME_UNKNOWN = "unknown"


def _phase(pod) -> str:
    status = getattr(pod, "status", None)
    if status is None and isinstance(pod, dict):
        return (pod.get("status") or {}).get("phase", "")
    return getattr(status, "phase", "") or ""


class PodMonitor:
    """Poll ONE pod until it finishes (reference PodMonitor semantics:
    bounded not-found retries, failure log tail)."""

    def __init__(self, client, pod_name: str, poll_secs: float = 10.0,
                 not_found_retries: int = 6, unknown_ok: bool = False):
        self._client = client
        self._pod_name = pod_name
        self._poll_secs = poll_secs
        self._not_found_retries = not_found_retries
        self._unknown_ok = unknown_ok

    def wait(self, timeout: Optional[float] = None) -> bool:
        """True iff the pod Succeeded. Failed pods tail their log.

        An UNKNOWN outcome (Running-then-gone — possible eviction or
        node drain, not just pod GC) maps to False unless the monitor
        was built with ``unknown_ok=True`` (fast-GC clusters where
        completed pods vanish between polls).
        """
        outcome = self.wait_outcome(timeout)
        if outcome == OUTCOME_UNKNOWN:
            return self._unknown_ok
        return outcome == OUTCOME_SUCCEEDED

    def wait_outcome(self, timeout: Optional[float] = None) -> str:
        """Poll to a terminal OUTCOME_* value (three-valued wait)."""
        deadline = (
            time.time() + timeout if timeout is not None else None
        )
        misses = 0
        ever_running = False
        while True:
            pod = self._client.get_pod(self._pod_name)
            if pod is None:
                misses += 1
                if misses > self._not_found_retries:
                    if ever_running:
                        # Seen Running, then gone for good, Succeeded
                        # never observed: could be pod GC after a fast
                        # completion OR an eviction/manual kill. Don't
                        # claim either — report unknown.
                        logger.warning(
                            "%s disappeared while Running; outcome "
                            "UNKNOWN (pod GC after completion, or "
                            "evicted/killed)", self._pod_name,
                        )
                        return OUTCOME_UNKNOWN
                    logger.error("%s not found", self._pod_name)
                    return OUTCOME_FAILED
            else:
                misses = 0
                phase = _phase(pod)
                logger.info("%s phase: %s", self._pod_name, phase)
                if phase == SUCCEEDED:
                    return OUTCOME_SUCCEEDED
                # Pending-then-gone (unschedulable, deleted) is failure;
                # only a pod that actually RAN gets the unknown verdict.
                ever_running = ever_running or phase == "Running"
                if phase == FAILED:
                    logger.error(
                        "%s failed; log tail:\n%s", self._pod_name,
                        self._client.get_pod_log(self._pod_name),
                    )
                    return OUTCOME_FAILED
            if deadline and time.time() > deadline:
                logger.error("%s: wait timed out", self._pod_name)
                return OUTCOME_FAILED
            time.sleep(self._poll_secs)


class JobMonitor:
    """Monitor a whole job: the master pod decides success; each tick
    also snapshots every replica's phase (workers / rowservice) so a
    degraded-but-running job is visible (reference EdlJobMonitor
    check_worker_status/check_ps_status)."""

    def __init__(self, client, job_name: str, poll_secs: float = 30.0,
                 unknown_ok: bool = False):
        self._client = client
        self._job_name = job_name
        self._poll_secs = poll_secs
        self._unknown_ok = unknown_ok

    def snapshot(self) -> Dict[str, Dict[str, str]]:
        """{replica_type: {pod_name: phase}} for all live job pods."""
        out: Dict[str, Dict[str, str]] = {}
        for pod in self._client.list_job_pods(self._job_name):
            labels = pod.metadata.labels or {}
            rtype = labels.get(ELASTICDL_REPLICA_TYPE_KEY, "?")
            out.setdefault(rtype, {})[pod.metadata.name] = _phase(pod)
        return out

    def wait(self, timeout: Optional[float] = None,
             not_found_retries: int = 6) -> bool:
        """True iff the master pod Succeeded; UNKNOWN (Running-then-gone)
        maps to False unless ``unknown_ok=True`` — a master evicted or
        externally deleted while Running must not make --wait exit 0."""
        outcome = self.wait_outcome(timeout, not_found_retries)
        if outcome == OUTCOME_UNKNOWN:
            return self._unknown_ok
        return outcome == OUTCOME_SUCCEEDED

    def wait_outcome(self, timeout: Optional[float] = None,
                     not_found_retries: int = 6) -> str:
        master = get_master_pod_name(self._job_name)
        deadline = (
            time.time() + timeout if timeout is not None else None
        )
        misses = 0
        ever_running = False
        while True:
            pod = self._client.get_pod(master)
            if pod is None:
                # Transient 404s (API eventual consistency right after
                # submit) must not read as job failure.
                misses += 1
                if misses > not_found_retries:
                    if ever_running:
                        # Seen Running, then gone for good, Succeeded
                        # never observed: pod GC after a fast completion
                        # or an eviction/kill — report unknown, claim
                        # neither.
                        logger.warning(
                            "job %s: master pod %s disappeared while "
                            "Running; outcome UNKNOWN (pod GC after "
                            "completion, or evicted/killed)",
                            self._job_name, master,
                        )
                        return OUTCOME_UNKNOWN
                    logger.error(
                        "job %s: master pod %s not found",
                        self._job_name, master,
                    )
                    return OUTCOME_FAILED
                time.sleep(self._poll_secs)
                continue
            misses = 0
            phase = _phase(pod)
            # Pending-then-gone (unschedulable, deleted) is failure;
            # only a master that actually RAN gets the unknown verdict.
            ever_running = ever_running or phase == "Running"
            snap = self.snapshot()
            logger.info(
                "job %s: master=%s %s", self._job_name, phase,
                {t: dict(p) for t, p in snap.items()},
            )
            for rtype, pods in snap.items():
                for name, p in pods.items():
                    if p == FAILED and rtype != "master":
                        logger.warning("replica %s (%s) Failed", name, rtype)
            # Decide from the phase already in hand — re-fetching races
            # pod GC and could misreport a finished job.
            if phase == FAILED:
                logger.error(
                    "job %s failed; master log tail:\n%s",
                    self._job_name,
                    self._client.get_pod_log(master),
                )
                return OUTCOME_FAILED
            if phase == SUCCEEDED:
                return OUTCOME_SUCCEEDED
            if deadline and time.time() > deadline:
                logger.error("job %s: wait timed out", self._job_name)
                return OUTCOME_FAILED
            time.sleep(self._poll_secs)
