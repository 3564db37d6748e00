"""Serving-fleet chaos drill (port of
elasticdl_tpu/chaos/serving_drill.py): kill a replica mid-load,
availability holds.

``python -m elasticdl_tpu_torch.chaos.serving_drill [--report PATH]
[--device cpu]``: the replicas serve on the device (CUDA unless cpu is
given), the rows live in the row service's host RAM.

The training-side chaos plane (runner.py) adjudicates recovery with
invariant checkers over a faulted run; this is the serving-tier
equivalent, fully in-process: a router + 2 ``InferenceServer``
replicas (each with a hot-row LRU) over ONE live ``HostRowService``,
driven by seeded mixed-priority closed-loop clients. After a fixed
number of completed requests one replica is hard-killed; the router
must hedge/route around it. Mid-run row pushes exercise the cache's
version-based invalidation under fire.

Invariants checked (exit nonzero on failure):
- availability: non-shed requests answer 200 at >= the threshold
  across the kill (sheds are counted separately — a 429 is the system
  WORKING, not failing);
- cache effectiveness: the replicas' hot-row caches served a nonzero
  share of resolved rows;
- the router noticed: the killed replica is marked unhealthy by the
  end of the run.

Deterministic per seed on the REQUEST side (ids, priorities, kill
trigger); wall-clock effects (which exact request straddles the kill,
hedge timing) vary — the invariants are thresholds, not byte
equality, mirroring the soak mode's contract.
"""

import json
import os
import shutil
import tempfile
import threading
import time

import numpy as np

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("serving_drill")

ID_SPACE = 200  # small id universe -> the LRU warms inside the drill


def export_sparse_bundle(tmpdir: str, seed: int):
    """DeepFM host-tier bundle (row-service export mode) — the sparse
    serving shape the hot-row cache exists for, its weights drawn from
    ``seed``. Returns (bundle dir, the deepfm_host zoo module). The row
    plane is the caller's."""
    import torch

    from elasticdl_tpu_torch.serving.export import export_serving_bundle
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = deepfm_host.custom_model(device="cpu").eval()
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, ID_SPACE, (4, 10)).astype(np.int32)
    batch = {
        "features": {deepfm_host.FEATURE_KEY: ids},
        "labels": np.zeros((4,), np.int32),
        "mask": np.ones((4,), np.float32),
    }
    bundle = os.path.join(tmpdir, "bundle")
    export_serving_bundle(
        bundle, model, batch_example=batch,
        model_def="deepfm.deepfm_host.custom_model",
        host_id_keys={deepfm_host.TABLE_NAME: deepfm_host.FEATURE_KEY},
    )
    return bundle, deepfm_host


def _export_sparse_bundle(tmpdir: str, seed: int):
    """Bundle + a live in-process row service (the drill's shape)."""
    from elasticdl_tpu_torch.embedding.optimizer import (
        SGD,
        HostOptimizerWrapper,
    )
    from elasticdl_tpu_torch.embedding.row_service import HostRowService
    from elasticdl_tpu_torch.embedding.table import EmbeddingTable
    from elasticdl_tpu_torch.observability import MetricsRegistry

    bundle, deepfm_host = export_sparse_bundle(tmpdir, seed)
    service = HostRowService(
        {deepfm_host.TABLE_NAME:
            EmbeddingTable(deepfm_host.TABLE_NAME,
                           deepfm_host.EMBEDDING_DIM)},
        HostOptimizerWrapper(SGD(lr=0.5)),
        metrics_registry=MetricsRegistry(),
    ).start()
    return bundle, service, deepfm_host


def run_drill(seed: int = 7, requests_per_client: int = 40,
              clients: int = 4, kill_after: int = 30,
              availability_threshold: float = 0.98,
              row_cache: int = 4096,
              report_path: str = "", device=None) -> dict:
    """Run the fleet drill; returns the report dict (["passed"])."""
    from elasticdl_tpu_torch.common import tensor_utils
    from elasticdl_tpu_torch.observability import MetricsRegistry
    from elasticdl_tpu_torch.serving.model_store import ModelStore
    from elasticdl_tpu_torch.serving.router import RouterServer
    from elasticdl_tpu_torch.serving.server import InferenceServer

    tmpdir = tempfile.mkdtemp(prefix="serving_drill_")
    bundle, service, deepfm_host = _export_sparse_bundle(tmpdir, seed)
    feature_key = deepfm_host.FEATURE_KEY
    table_name = deepfm_host.TABLE_NAME

    replica_registries = [MetricsRegistry(), MetricsRegistry()]
    replicas = []
    stores = []
    for registry in replica_registries:
        store = ModelStore(
            bundle, device=device,
            model_fn=lambda: deepfm_host.custom_model(device=device),
            row_service_addr=f"localhost:{service.port}",
            poll_seconds=3600,
            row_cache_capacity=row_cache,
            row_cache_version_check_secs=0.02,
            metrics_registry=registry,
        )
        store.load_initial()
        stores.append(store)
        replicas.append(InferenceServer(
            store, max_batch_size=8, batch_deadline_ms=2.0, port=0,
            metrics_registry=registry,
        ).start())
    router_registry = MetricsRegistry()
    router = RouterServer(
        [f"localhost:{r.port}" for r in replicas], port=0,
        metrics_registry=router_registry,
        hedge_min_ms=10, hedge_max_ms=200, replica_timeout=10.0,
        probe_secs=0.2,
    ).start()

    # Warm every replica's buckets + the hedge window so the measured
    # phase never pays a first-compile.
    rng = np.random.RandomState(seed)

    def payload(client_rng):
        ids = client_rng.randint(0, ID_SPACE, (4, 10)).astype(np.int32)
        return tensor_utils.dumps({"features": {feature_key: ids}})

    import http.client

    def predict(conn, body, priority):
        conn.request(
            "POST", "/v1/predict", body=body,
            headers={"Content-Type": "application/x-msgpack",
                     "X-Priority": priority},
        )
        resp = conn.getresponse()
        resp.read()
        return resp.status

    warm_conn = http.client.HTTPConnection(
        "localhost", router.port, timeout=30
    )
    for _ in range(8):
        status = predict(warm_conn, payload(rng), "normal")
        assert status == 200, f"warmup failed with {status}"
    warm_conn.close()

    completed = [0]
    statuses = []
    lock = threading.Lock()
    killed = threading.Event()
    priorities = ("high", "normal", "low")

    def client(worker: int):
        client_rng = np.random.RandomState(seed * 1000 + worker)
        conn = http.client.HTTPConnection(
            "localhost", router.port, timeout=30
        )
        try:
            for i in range(requests_per_client):
                priority = priorities[
                    int(client_rng.randint(0, len(priorities)))
                ]
                try:
                    status = predict(conn, payload(client_rng),
                                     priority)
                except Exception:
                    # Transport error surfaces as a failed request —
                    # counted against availability, and the keep-alive
                    # conn is replaced.
                    status = -1
                    conn.close()
                    conn = http.client.HTTPConnection(
                        "localhost", router.port, timeout=30
                    )
                with lock:
                    statuses.append((priority, status))
                    completed[0] += 1
                    fire_kill = (
                        completed[0] >= kill_after
                        and not killed.is_set()
                    )
                    if fire_kill:
                        killed.set()  # claim before dropping the lock
                if fire_kill:
                    logger.info(
                        "DRILL: kill trigger at request %d",
                        completed[0],
                    )
                    replicas[0].stop()
                if i > 0 and i % 10 == 0:
                    # Row pushes under fire: bump the table version so
                    # the replicas' caches must invalidate + re-pull.
                    service._push_row_grads({
                        "table": table_name,
                        "ids": client_rng.randint(
                            0, ID_SPACE, (4,)
                        ).astype(np.int64),
                        "grads": np.full(
                            (4, deepfm_host.EMBEDDING_DIM), 0.1,
                            np.float32,
                        ),
                    })
        finally:
            conn.close()

    threads = [
        threading.Thread(target=client, args=(w,))
        for w in range(clients)
    ]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.monotonic() - t0
    drained = router.drain(grace=10.0)
    for replica in replicas[1:]:
        replica.stop()
    for store in stores:
        store.stop()
    service.stop(0)
    shutil.rmtree(tmpdir, ignore_errors=True)

    # ---- adjudicate ----------------------------------------------------

    counts = {}
    for _, status in statuses:
        counts[str(status)] = counts.get(str(status), 0) + 1
    ok = counts.get("200", 0)
    shed = counts.get("429", 0)
    total = len(statuses)
    answered = total - shed
    availability = ok / answered if answered else 0.0

    def cache_stats():
        hits = misses = 0.0
        for registry in replica_registries:
            for family in registry.snapshot()["families"]:
                if family["name"] == \
                        "edl_tpu_serving_row_cache_hits_total":
                    hits += sum(
                        s["value"] for s in family["series"]
                    )
                if family["name"] == \
                        "edl_tpu_serving_row_cache_misses_total":
                    misses += sum(
                        s["value"] for s in family["series"]
                    )
        rate = hits / (hits + misses) if hits + misses else 0.0
        return {"hits": hits, "misses": misses,
                "hit_rate": round(rate, 4)}

    cache = cache_stats()
    router_snap = {
        f["name"]: f for f in router_registry.snapshot()["families"]
    }
    hedges = {
        s["labels"][0]: s["value"]
        for s in router_snap.get(
            "edl_tpu_router_hedges_total", {"series": []}
        )["series"]
    }
    unhealthy = sum(
        s["value"] for s in router_snap.get(
            "edl_tpu_router_replica_unhealthy_total", {"series": []}
        )["series"]
    )

    invariants = [
        {
            "name": "availability_across_replica_kill",
            "passed": availability >= availability_threshold,
            "detail": f"{ok}/{answered} non-shed requests answered "
                      f"200 ({availability:.4f} >= "
                      f"{availability_threshold})",
        },
        {
            "name": "hot_row_cache_effective",
            "passed": cache["hits"] > 0,
            "detail": f"cache hit rate {cache['hit_rate']} "
                      f"({int(cache['hits'])} hits / "
                      f"{int(cache['misses'])} misses)",
        },
        {
            "name": "router_detected_dead_replica",
            "passed": unhealthy >= 1,
            "detail": f"{int(unhealthy)} unhealthy transition(s)",
        },
        {
            "name": "router_drained_clean",
            "passed": bool(drained),
            "detail": "in-flight hedged requests settled in grace",
        },
    ]
    report = {
        "config": {
            "seed": seed,
            "clients": clients,
            "requests_per_client": requests_per_client,
            "kill_after_requests": kill_after,
            "row_cache": row_cache,
            "availability_threshold": availability_threshold,
        },
        "elapsed_s": round(elapsed, 3),
        "statuses": counts,
        "shed": shed,
        "availability": round(availability, 4),
        "cache": cache,
        "hedges": hedges,
        "replica_unhealthy_transitions": int(unhealthy),
        "invariants": invariants,
        "passed": all(inv["passed"] for inv in invariants),
    }
    if report_path:
        with open(report_path, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")
    for inv in invariants:
        logger.info(
            "DRILL invariant %-34s %s  (%s)", inv["name"],
            "PASS" if inv["passed"] else "FAIL", inv["detail"],
        )
    return report


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        "elasticdl_tpu_torch-serving-fleet-drill")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--clients", type=int, default=4)
    parser.add_argument("--requests_per_client", type=int, default=40)
    parser.add_argument("--kill_after", type=int, default=30)
    parser.add_argument("--availability_threshold", type=float,
                        default=0.98)
    parser.add_argument("--report", default="")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    report = run_drill(
        seed=args.seed, clients=args.clients,
        requests_per_client=args.requests_per_client,
        kill_after=args.kill_after,
        availability_threshold=args.availability_threshold,
        report_path=args.report, device=args.device,
    )
    print(json.dumps({
        k: report[k] for k in (
            "availability", "shed", "cache", "hedges", "passed"
        )
    }))
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
