"""Synthetic-probe chaos drill (port of
elasticdl_tpu/chaos/probe_drill.py): every fault reds the MATCHING
black-box probe within a bounded interval count, a kill-free twin
stays 100% green.

``python -m elasticdl_tpu_torch.chaos.probe_drill --workdir DIR
[--report PATH] [--device cpu]`` (exit 0 only if every gate holds; the
report defaults to ``DIR/PROBE_DRILL.json`` and is audited by
``elasticdl_tpu_torch/tools/check_probe.py``). The serving replica runs
on the device (CUDA unless cpu is given); rows live in host RAM.

White-box drills adjudicate recovery from inside the planes they
fault; this drill adjudicates the OBSERVER: the prober
(``observability/prober.py``) must detect each outage from outside,
fast, and must never cry wolf. One process hosts the full plane set
the five shipped probes exercise, all real surfaces:

- **row tier** — two ``quake_drill`` row-service subprocesses (durable
  WAL, ``--optimizer sgd`` so ``row_ryw``'s byte-equality expectation
  is order-free);
- **dispatch + stream** — a ``stream_drill._Master`` incarnation
  (real journal, streaming dispatcher, ingestor) whose ONLY job is the
  canary stream partition; a background canary worker (the dispatch
  probe body in ``resolve=True`` mode, running under the ``canary``
  principal) drains it so the committed watermark can advance;
- **serving** — an exported DeepFM host-tier bundle with an **int64
  feature signature** (the server coerces request ids onto the
  recorded signature; an int32 signature would truncate every
  canary-range id to garbage), served by a REAL replica subprocess
  behind an in-process router, rows from a dedicated serving row
  service (so the row-tier kill window cannot leak into the serving
  verdict).

Fault windows (the faulted run, after a green barrier):

1. ``row_shard_kill``  — SIGKILL the row shard owning the canary ids
                         → ``row_ryw`` reds; relaunch, re-green.
2. ``serving_stall``   — SIGSTOP the serving replica (the process is
                         alive but the path is wedged — exactly what
                         white-box metrics miss) →
                         ``serving_freshness`` reds; SIGCONT.
3. ``master_kill``     — crash the master incarnation →
                         ``dispatch_roundtrip`` reds; a fresh
                         incarnation journal-recovers on the same
                         port, re-green.

Gates: each window's matching probe turns red within
``DETECT_BOUND_TICKS`` probe intervals and the plane re-greens within
``GREEN_BOUND_TICKS`` after repair; the twin run's ticks are 100%
green (zero false positives); each red transition captured an
incident bundle whose rule is ``probe-<name>`` and whose alert carries
the failing run's trace id; and the master-side ``/usage`` metering
accounts every canary RPC under the ``canary`` purpose — and ONLY
under it.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("probe_drill")

SEED = 23
UNHEALTHY_AFTER = 2
DETECT_BOUND_TICKS = 5
GREEN_BOUND_TICKS = 40
TWIN_TICKS = 8
SETUP_BOUND_TICKS = 40
SERVING_DEADLINE_SECS = 3.0
STREAM_DEADLINE_SECS = 4.0
ROW_LR = 0.01          # quake_drill SGD shard: --optimizer sgd
SERVING_ROW_LR = 0.5   # the serving plane's own row service

PROBES = ("row_ryw", "serving_freshness", "reshard_convergence",
          "stream_watermark", "dispatch_roundtrip")

WINDOWS = (
    ("row_shard_kill", "row_ryw"),
    ("serving_stall", "serving_freshness"),
    ("master_kill", "dispatch_roundtrip"),
)


def _pkg_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)
    )))


# ---- serving plane ---------------------------------------------------------

# The served model: deepfm_host computing in f32. At the port's initial
# weights a canary write (lr 0.5 x 1e-3 per coordinate) moves the bf16
# twin's logit by less than one bf16 step, so the freshness probe would
# read a live write as stale; in f32 every write is visible.
PROBE_ZOO = '''\
"""deepfm_host in f32 (written by chaos/probe_drill.py)."""

import torch

from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host


def custom_model(device=None):
    return deepfm_host.HostDeepFM(compute_dtype=torch.float32).to(device)
'''
PROBE_MODEL_DEF = "probe_drill_zoo.custom_model"


def _write_probe_zoo(root: str) -> str:
    zoo = os.path.join(root, "zoo")
    os.makedirs(zoo, exist_ok=True)
    with open(os.path.join(zoo, "probe_drill_zoo.py"), "w") as fh:
        fh.write(PROBE_ZOO)
    return zoo


def export_probe_bundle(tmpdir: str, seed: int) -> str:
    """DeepFM host-tier bundle whose feature signature is **int64**.
    ``serving_drill.export_sparse_bundle`` traces with int32 ids; the
    server coerces every request onto the recorded signature
    (``server.py _coerce_signature``), which would truncate canary-
    range ids (>= 2^62) into the real vocabulary — the probe would
    then perturb row 0 of the REAL table and never see its own write.
    """
    import torch

    from elasticdl_tpu_torch.serving.export import export_serving_bundle
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = deepfm_host.HostDeepFM(compute_dtype=torch.float32).eval()
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 200, (4, 10)).astype(np.int64)
    batch = {
        "features": {deepfm_host.FEATURE_KEY: ids},
        "labels": np.zeros((4,), np.int32),
        "mask": np.ones((4,), np.float32),
    }
    bundle = os.path.join(tmpdir, "bundle")
    _write_probe_zoo(tmpdir)
    export_serving_bundle(
        bundle, model, batch_example=batch,
        model_def=PROBE_MODEL_DEF,
        host_id_keys={deepfm_host.TABLE_NAME: deepfm_host.FEATURE_KEY},
    )
    return bundle


class _ServingPlane:
    """Replica SUBPROCESS (SIGSTOP-able) + in-process router + a
    dedicated row service for the serving tier's rows."""

    def __init__(self, workdir: str, bundle: str, device: str):
        from elasticdl_tpu_torch.chaos.quake_drill import _free_ports
        from elasticdl_tpu_torch.embedding.optimizer import (
            SGD,
            HostOptimizerWrapper,
        )
        from elasticdl_tpu_torch.embedding.row_service import HostRowService
        from elasticdl_tpu_torch.embedding.table import EmbeddingTable
        from elasticdl_tpu_torch.observability import MetricsRegistry
        from elasticdl_tpu_torch.serving.router import RouterServer
        from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host

        os.makedirs(workdir, exist_ok=True)
        self.feature_key = deepfm_host.FEATURE_KEY
        self.row_service = HostRowService(
            {deepfm_host.TABLE_NAME: EmbeddingTable(
                deepfm_host.TABLE_NAME, deepfm_host.EMBEDDING_DIM
            )},
            HostOptimizerWrapper(SGD(lr=SERVING_ROW_LR)),
            metrics_registry=MetricsRegistry(),
        ).start()
        self._replica_port = _free_ports(1)[0]
        self._log = open(os.path.join(workdir, "replica.log"), "w")
        self.replica = subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.serving.server",
             "--model_dir", bundle,
             "--port", str(self._replica_port),
             "--row_service_addr",
             f"localhost:{self.row_service.port}",
             "--row_cache_capacity", "4096",
             "--row_cache_version_check_ms", "20",
             "--model_zoo",
             os.path.join(os.path.dirname(bundle), "zoo"),
             "--device", device],
            cwd=_pkg_root(), stdout=self._log,
            stderr=subprocess.STDOUT,
        )
        self.router = RouterServer(
            [f"localhost:{self._replica_port}"], port=0,
            metrics_registry=MetricsRegistry(),
            replica_timeout=2.0, probe_secs=0.2,
        ).start()

    def wait_ready(self, predict_fn, deadline_secs: float = 180.0):
        from elasticdl_tpu_torch.observability.prober import ProbeFailure

        t0 = time.monotonic()
        while True:
            try:
                predict_fn()
                return
            except ProbeFailure as exc:
                if time.monotonic() - t0 > deadline_secs:
                    raise TimeoutError(
                        f"serving replica never answered: {exc}"
                    )
                time.sleep(0.5)

    def stall(self):
        os.kill(self.replica.pid, signal.SIGSTOP)

    def unstall(self):
        os.kill(self.replica.pid, signal.SIGCONT)

    def stop(self):
        try:
            self.router.drain(grace=2.0)
        except Exception:
            pass
        try:
            os.kill(self.replica.pid, signal.SIGCONT)
        except OSError:
            pass
        self.replica.terminate()
        try:
            self.replica.wait(timeout=15)
        except Exception:
            self.replica.kill()
        self.row_service.stop(0)
        self._log.close()


# ---- canary worker ---------------------------------------------------------


class _CanaryWorker(threading.Thread):
    """Drains the master's canary stream tasks so the committed
    watermark can advance. Reuses the dispatch probe body in
    ``resolve=True`` mode — the drill master's only job IS the canary
    partition — and runs under the canary principal so its RPCs meter
    as synthetic load, like all probe traffic."""

    def __init__(self, master_addr: str):
        super().__init__(name="canary-worker", daemon=True)
        from elasticdl_tpu_torch.observability import prober

        self._resolve = prober.make_dispatch_roundtrip_probe(
            master_addr, worker_id=7, resolve=True,
        )
        # NOT `_stop`: threading.Thread.join() calls its private
        # `_stop()` internally; shadowing it with an Event breaks join.
        self._halt = threading.Event()

    def run(self):
        from elasticdl_tpu_torch.observability import principal, prober

        with principal.pushed(job=prober.CANARY_JOB,
                              component="prober", purpose="canary"):
            while not self._halt.is_set():
                try:
                    self._resolve()
                except Exception:
                    # Master down (the kill window) — retry quietly.
                    self._halt.wait(0.2)
                self._halt.wait(0.02)

    def stop(self, timeout: float = 5.0):
        self._halt.set()
        self.join(timeout=timeout)


# ---- one plane-set run -----------------------------------------------------


class _Plane:
    """Everything one run probes: row fleet, master, serving,
    prober."""

    def __init__(self, workdir: str, bundle: str,
                 incident_dir: str = "", device: str = "cuda"):
        from elasticdl_tpu_torch.chaos.quake_drill import (
            RowFleet,
            _free_ports,
            _wait_shard,
        )
        from elasticdl_tpu_torch.chaos.stream_drill import _Master
        from elasticdl_tpu_torch.observability import MetricsRegistry, prober
        from elasticdl_tpu_torch.observability.slo import IncidentRecorder

        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.row_ports = _free_ports(2)
        self.fleet = RowFleet(os.path.join(workdir, "rows"))
        for shard, port in enumerate(self.row_ports):
            self.fleet.spawn(
                shard, port,
                checkpoint_dir=os.path.join(
                    workdir, "rows", f"s{shard}", "ckpt"),
                push_log_dir=os.path.join(
                    workdir, "rows", f"s{shard}", "wal"),
                ack="durable", optimizer="sgd",
            )
        for port in self.row_ports:
            _wait_shard(port)

        self.journal_dir = os.path.join(workdir, "journal")
        self.stream_dir = os.path.join(workdir, "stream")
        os.makedirs(self.journal_dir, exist_ok=True)
        os.makedirs(self.stream_dir, exist_ok=True)
        self.master_port = _free_ports(1)[0]
        # The port's stream master pumps its ingestor under a writer's
        # lock; the canary appender writes single records, so the lock
        # is this plane's own and never contended by a writer.
        self._append_lock = threading.Lock()
        self.master = _Master(self.journal_dir, self.stream_dir,
                              self.master_port, self._append_lock)
        self.worker = _CanaryWorker(f"localhost:{self.master_port}")
        self.worker.start()

        self.serving = _ServingPlane(
            os.path.join(workdir, "serving"), bundle, device
        )

        self.registry = MetricsRegistry()
        self.incidents = None
        if incident_dir:
            os.makedirs(incident_dir, exist_ok=True)
            self.incidents = IncidentRecorder(
                incident_dir, background=False
            )
        self.sched = prober.ProbeScheduler(
            registry=self.registry,
            incident_recorder=self.incidents,
            unhealthy_after=UNHEALTHY_AFTER,
        )
        self._register_probes()

    def _register_probes(self):
        from elasticdl_tpu_torch.observability import prober

        row_addrs = ",".join(
            f"localhost:{p}" for p in self.row_ports
        )
        self.canary_client = prober.RowCanaryClient(row_addrs)
        # The quake shards run SGD(lr=ROW_LR): the deployment knows
        # its optimizer rule, so RYW gates BYTE equality, not just
        # visibility.
        expect = lambda before, grads: (  # noqa: E731
            before - np.float32(ROW_LR) * grads
        )
        self.sched.register(
            "row_ryw",
            prober.make_row_ryw_probe(self.canary_client,
                                      expect_fn=expect),
            interval_secs=0,
        )
        self.sched.register(
            "reshard_convergence",
            prober.make_reshard_convergence_probe(row_addrs),
            interval_secs=0,
        )

        cid = prober.canary_id(1)
        predict = prober.make_router_predictor(
            f"localhost:{self.serving.router.port}",
            self.serving.feature_key, [[cid] * 10], timeout=3.0,
        )
        self.serving.wait_ready(predict)
        push_client = prober.RowCanaryClient(
            f"localhost:{self.serving.row_service.port}"
        )

        def push_canary(sign):
            dim = push_client.dim()
            push_client.push(
                np.array([cid], np.int64),
                np.full((1, dim), sign * 1e-3, np.float32),
            )

        self.sched.register(
            "serving_freshness",
            prober.make_serving_freshness_probe(
                predict, push_canary,
                deadline_secs=SERVING_DEADLINE_SECS,
            ),
            interval_secs=0,
        )

        append = prober.make_stream_appender(self.stream_dir)
        plane = self

        def watermark():
            part = plane.master.ingestor.render()["partitions"].get(
                prober.CANARY_STREAM_PARTITION
            )
            return None if part is None else int(part["committed"])

        self.sched.register(
            "stream_watermark",
            prober.make_stream_watermark_probe(
                append, watermark,
                deadline_secs=STREAM_DEADLINE_SECS,
            ),
            interval_secs=0,
        )
        self.sched.register(
            "dispatch_roundtrip",
            prober.make_dispatch_roundtrip_probe(
                f"localhost:{self.master_port}"
            ),
            interval_secs=0,
        )

    # -- faults ----------------------------------------------------------

    def kill_row_shard(self):
        # Shard 0 owns the low shard-map buckets, and canary ids land
        # there (2^62 % 8192 == 0).
        self.fleet.sigkill(0)

    def relaunch_row_shard(self):
        from elasticdl_tpu_torch.chaos.quake_drill import _wait_shard

        self.fleet.relaunch(0)
        _wait_shard(self.row_ports[0])

    def crash_master(self):
        self.master.crash()

    def relaunch_master(self):
        from elasticdl_tpu_torch.chaos.stream_drill import _Master

        # Fresh incarnation, same port, journal recovery — the
        # watermark closure reads self.master so it follows along.
        self.master = _Master(self.journal_dir, self.stream_dir,
                              self.master_port, self._append_lock)

    # -- ticks -----------------------------------------------------------

    def tick(self) -> Dict[str, str]:
        """Run every probe once; returns {probe: "ok" | reason}."""
        out = {}
        for name in PROBES:
            record = self.sched.run_once(name)
            out[name] = "ok" if record["ok"] else (
                record["reason"] or "exception"
            )
        return out

    def statuses(self) -> Dict[str, str]:
        return {
            name: ent["status"]
            for name, ent in self.sched.render()["probes"].items()
        }

    def stop(self):
        self.worker.stop()
        self.serving.stop()
        try:
            self.master.shutdown()
        except Exception:
            pass
        self.fleet.stop_all()
        if self.incidents is not None:
            self.incidents.flush()


def _green_barrier(plane: _Plane, timeline: List[dict],
                   bound: int) -> Optional[int]:
    """Tick until every probe is green; returns the tick count or
    None when the bound elapsed first."""
    for i in range(bound):
        results = plane.tick()
        timeline.append({"results": results})
        if all(s == "green" for s in plane.statuses().values()):
            return i + 1
    return None


def run_twin(workdir: str, bundle: str, device: str = "cuda") -> dict:
    """Kill-free twin: after the setup barrier, every tick of every
    probe must be green — the zero-false-positive half of the gate."""
    out = {"role": "twin", "problems": [], "timeline": []}
    plane = _Plane(workdir, bundle, device=device)
    try:
        setup = _green_barrier(plane, [], SETUP_BOUND_TICKS)
        if setup is None:
            out["problems"].append(
                f"twin never reached all-green within "
                f"{SETUP_BOUND_TICKS} setup ticks: {plane.statuses()}"
            )
            return out
        out["setup_ticks"] = setup
        failures = 0
        for _ in range(TWIN_TICKS):
            results = plane.tick()
            out["timeline"].append({"results": results})
            failures += sum(1 for v in results.values() if v != "ok")
        out["ticks"] = TWIN_TICKS
        out["failures"] = failures
        if failures:
            out["problems"].append(
                f"twin saw {failures} probe failure(s) with no fault "
                "injected (false positives)"
            )
        out["probes"] = plane.sched.render()["probes"]
    finally:
        plane.stop()
    return out


def run_faulted(workdir: str, bundle: str,
                device: str = "cuda") -> dict:
    """Three fault windows; each must red the MATCHING probe within
    the detection bound and re-green after repair."""
    out = {"role": "faulted", "problems": [], "windows": [],
           "timeline": []}
    incident_dir = os.path.join(workdir, "incidents")
    plane = _Plane(workdir, bundle, incident_dir=incident_dir,
                   device=device)
    faults = {
        "row_shard_kill": (plane.kill_row_shard,
                           plane.relaunch_row_shard),
        "serving_stall": (plane.serving.stall,
                          plane.serving.unstall),
        "master_kill": (plane.crash_master, plane.relaunch_master),
    }
    try:
        setup = _green_barrier(plane, [], SETUP_BOUND_TICKS)
        if setup is None:
            out["problems"].append(
                f"faulted run never reached all-green within "
                f"{SETUP_BOUND_TICKS} setup ticks: {plane.statuses()}"
            )
            return out
        out["setup_ticks"] = setup
        for window, probe in WINDOWS:
            fault, repair = faults[window]
            entry = {"window": window, "probe": probe,
                     "detect_ticks": None, "within_bound": False,
                     "recover_ticks": None, "collateral": []}
            logger.info("probe drill window %s: faulting", window)
            fault()
            collateral = set()
            for i in range(DETECT_BOUND_TICKS):
                results = plane.tick()
                out["timeline"].append(
                    {"window": window, "results": results}
                )
                statuses = plane.statuses()
                collateral |= {
                    n for n, s in statuses.items()
                    if s == "red" and n != probe
                }
                if statuses[probe] == "red":
                    entry["detect_ticks"] = i + 1
                    entry["within_bound"] = True
                    entry["reason"] = (
                        plane.sched.render()["probes"][probe]
                        ["last_reason"]
                    )
                    break
            entry["collateral"] = sorted(collateral)
            if not entry["within_bound"]:
                out["problems"].append(
                    f"{window}: probe {probe} did not red within "
                    f"{DETECT_BOUND_TICKS} ticks "
                    f"(status {plane.statuses()[probe]})"
                )
            logger.info("probe drill window %s: repairing", window)
            repair()
            recover = _green_barrier(
                plane, out["timeline"], GREEN_BOUND_TICKS
            )
            entry["recover_ticks"] = recover
            if recover is None:
                out["problems"].append(
                    f"{window}: plane never re-greened within "
                    f"{GREEN_BOUND_TICKS} ticks after repair: "
                    f"{plane.statuses()}"
                )
                break
            out["windows"].append(entry)
        out["probes"] = plane.sched.render()["probes"]
        out["incidents"] = _audit_incidents(
            incident_dir, [probe for _, probe in WINDOWS],
            out["problems"],
        )
    finally:
        plane.stop()
    return out


def _audit_incidents(incident_dir: str, expected_probes: List[str],
                     problems: List[str]) -> dict:
    """Each red transition must have captured a bundle whose rule is
    ``probe-<name>`` and whose alert carries the failing run's trace
    id (resolvable against the trace the bundle itself snapshots)."""
    found: Dict[str, dict] = {}
    if os.path.isdir(incident_dir):
        for name in sorted(os.listdir(incident_dir)):
            alert_path = os.path.join(incident_dir, name, "alert.json")
            if not os.path.isfile(alert_path):
                continue
            try:
                with open(alert_path) as fh:
                    alert = json.load(fh).get("alert", {})
            except (OSError, ValueError):
                continue
            rule = str(alert.get("rule", ""))
            if rule.startswith("probe-"):
                found[rule[len("probe-"):]] = {
                    "bundle": name,
                    "trace_id": str(alert.get("trace_id", "")),
                    "reason": str(alert.get("reason", "")),
                }
    for probe in expected_probes:
        if probe not in found:
            problems.append(
                f"no incident bundle captured for probe {probe}"
            )
        elif not found[probe]["trace_id"]:
            problems.append(
                f"incident bundle for probe {probe} carries no "
                "trace id"
            )
    return found


def _usage_verdict(problems: List[str]) -> dict:
    """Master-side attribution gate: canary traffic meters under the
    ``canary`` purpose and ONLY under it (the drill's master, row
    services, and router live in this process, so their request
    metering lands on the default registry)."""
    from elasticdl_tpu_torch.observability import default_registry
    from elasticdl_tpu_torch.observability.prober import CANARY_JOB

    canary_series = 0
    canary_requests = 0
    violations = []
    snapshot = default_registry().snapshot()
    for family in snapshot.get("families", []):
        if not family["name"].startswith("edl_tpu_usage_"):
            continue
        names = family.get("labelnames", [])
        if "job" not in names:
            # usage_handler_seconds meters by (purpose, method) only
            # (bounded axes) — no job to cross-check.
            continue
        for series in family.get("series", []):
            labels = dict(zip(names, series.get("labels", [])))
            job = labels.get("job", "")
            purpose = labels.get("purpose", "")
            if job == CANARY_JOB:
                canary_series += 1
                if family["name"] == "edl_tpu_usage_requests_total":
                    canary_requests += int(series.get("value", 0))
                if purpose != "canary":
                    violations.append(
                        f"{family['name']}{labels} — canary job "
                        f"metered under purpose {purpose!r}"
                    )
            elif purpose == "canary":
                violations.append(
                    f"{family['name']}{labels} — purpose canary "
                    f"under foreign job {job!r}"
                )
    if canary_requests <= 0:
        problems.append(
            "no canary-principal requests metered in /usage"
        )
    problems.extend(violations)
    return {
        "canary_series": canary_series,
        "canary_requests": canary_requests,
        "violations": violations,
    }


def run_drill(workdir: str, seed: int = SEED, device=None) -> dict:
    from elasticdl_tpu_torch.common.device import resolve_device

    from elasticdl_tpu_torch.observability import prober, tracing

    device = str(resolve_device(device))
    os.makedirs(workdir, exist_ok=True)
    # Real trace ids for exemplars + incident bundles.
    from elasticdl_tpu_torch.observability.tracing import FlightRecorder

    tracing.install_recorder(FlightRecorder(4096))
    bundle = export_probe_bundle(workdir, seed)
    try:
        logger.info("probe drill: kill-free twin")
        twin = run_twin(os.path.join(workdir, "twin"), bundle, device)
        logger.info("probe drill: faulted run (3 windows)")
        faulted = run_faulted(
            os.path.join(workdir, "faulted"), bundle, device
        )
    finally:
        tracing.uninstall_recorder()
    problems = (
        [f"twin: {p}" for p in twin["problems"]]
        + [f"faulted: {p}" for p in faulted["problems"]]
    )
    usage = _usage_verdict(problems)
    report = {
        "drill": "probe",
        "seed": seed,
        "config": {
            "probes": list(PROBES),
            "windows": [list(w) for w in WINDOWS],
            "unhealthy_after": UNHEALTHY_AFTER,
            "detect_bound_ticks": DETECT_BOUND_TICKS,
            "green_bound_ticks": GREEN_BOUND_TICKS,
            "twin_ticks": TWIN_TICKS,
            "canary_id_base": prober.CANARY_ID_BASE,
            "canary_id_span": prober.CANARY_ID_SPAN,
            "canary_partition": prober.CANARY_STREAM_PARTITION,
            "canary_job": prober.CANARY_JOB,
        },
        "twin": twin,
        "faulted": faulted,
        "usage": usage,
        "problems": problems,
        "passed": not problems,
    }
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("elasticdl_tpu_torch-probe-drill")
    parser.add_argument("--seed", type=int, default=SEED)
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--report", default="",
                        help="default: <workdir>/PROBE_DRILL.json")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    args.report = args.report or os.path.join(args.workdir,
                                              "PROBE_DRILL.json")

    report = run_drill(args.workdir, seed=args.seed, device=args.device)
    with open(args.report, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True, default=str)
        fh.write("\n")
    for entry in report["faulted"].get("windows", []):
        logger.info(
            "probe drill window %-16s -> %s red in %s tick(s) "
            "(reason %s), re-green in %s",
            entry["window"], entry["probe"], entry["detect_ticks"],
            entry.get("reason", "?"), entry["recover_ticks"],
        )
    logger.info(
        "probe drill: %s; twin %d tick(s) %d failure(s); report %s",
        "PASS" if report["passed"] else "FAIL",
        report["twin"].get("ticks", 0),
        report["twin"].get("failures", -1), args.report,
    )
    if not report["passed"]:
        for problem in report["problems"]:
            logger.error("probe drill problem: %s", problem)
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
