"""Load-generator client for the inference server
(``elasticdl_tpu_torch/serving/server.py``), the port's copy of
``tools/serve_client.py`` over the port's codec. It drives a server of
either package (the wire is the same bytes).

Drives ``POST /v1/predict`` with synthetic traffic shaped by the
bundle's recorded feature signature (``GET /v1/models``), from N
concurrent closed-loop workers, and reports latency percentiles +
throughput as one JSON line. 429 responses (load shed) are counted,
not retried — the point of a closed-loop generator is to SEE the shed
rate at a given concurrency, not to hide it.

Usage:
  python -m elasticdl_tpu_torch.tools.serve_client --addr localhost:8500 \
      --requests 500 --concurrency 8 --batch 4

Also importable: ``predict_once`` / ``run_load``.
"""

import argparse
import http.client
import json
import sys
import threading
import time
import urllib.request

import numpy as np

MSGPACK_CONTENT_TYPE = "application/x-msgpack"


def _percentile(values, q):
    return float(np.percentile(np.asarray(values), q)) if values else 0.0


def synth_features(signature, batch: int, seed: int = 0):
    """Random features matching a bundle's recorded signature (the
    ``feature_signature`` metadata written at export): float leaves
    uniform, int leaves small non-negative ids."""
    rng = np.random.RandomState(seed)

    def leaf(spec):
        shape = [batch if d is None else int(d) for d in spec["shape"]]
        dtype = np.dtype(spec["dtype"])
        if np.issubdtype(dtype, np.integer):
            return rng.randint(0, 1000, size=shape).astype(dtype)
        return rng.rand(*shape).astype(dtype)

    if isinstance(signature, dict) and "dtype" in signature:
        return leaf(signature)
    if isinstance(signature, dict):
        return {k: synth_features(v, batch, seed + i)
                for i, (k, v) in enumerate(sorted(signature.items()))}
    raise ValueError(f"unsupported signature node: {signature!r}")


def fetch_signature(addr: str):
    with urllib.request.urlopen(f"http://{addr}/v1/models") as resp:
        meta = json.loads(resp.read())["meta"] or {}
    return meta.get("feature_signature")


class PredictConnection:
    """One persistent keep-alive connection to the server (HTTP/1.1):
    a closed-loop worker reuses it across requests, so the measured
    path is enqueue->batch->predict, not TCP setup + server thread
    spawn per request."""

    def __init__(self, addr: str, timeout: float = 30.0):
        host, _, port = addr.partition(":")
        self._conn = http.client.HTTPConnection(
            host, int(port or 80), timeout=timeout
        )

    def predict(self, features):
        """One msgpack predict round trip -> (status, payload|None)."""
        from elasticdl_tpu_torch.common import tensor_utils

        body = tensor_utils.dumps({"features": features})
        self._conn.request(
            "POST", "/v1/predict", body=body,
            headers={"Content-Type": MSGPACK_CONTENT_TYPE},
        )
        resp = self._conn.getresponse()
        raw = resp.read()
        if resp.status == 200:
            return resp.status, tensor_utils.loads(raw)
        return resp.status, None

    def close(self):
        self._conn.close()


def predict_once(addr: str, features, timeout: float = 30.0):
    """Single-shot convenience predict (fresh connection)."""
    conn = PredictConnection(addr, timeout=timeout)
    try:
        return conn.predict(features)
    finally:
        conn.close()


def run_load(addr: str, features, requests: int, concurrency: int,
             timeout: float = 30.0):
    """Closed-loop load: ``concurrency`` workers issue ``requests``
    total predicts over persistent connections. ``features`` is one
    payload tree or a LIST of them cycled across requests (distinct
    ids exercise a serving-side row cache realistically). Returns a
    dict with latency percentiles (ms), throughput, and per-status
    counts."""
    pool = features if isinstance(features, list) else [features]
    latencies = []
    statuses = {}
    lock = threading.Lock()
    remaining = [requests]

    def worker():
        conn = PredictConnection(addr, timeout=timeout)
        try:
            while True:
                with lock:
                    if remaining[0] <= 0:
                        return
                    remaining[0] -= 1
                    index = remaining[0]
                payload = pool[index % len(pool)]
                t0 = time.monotonic()
                try:
                    status, _ = conn.predict(payload)
                except (OSError, http.client.HTTPException):
                    # Transport failure (timeout, reset mid-shed):
                    # count it — a silently dead worker would shrink
                    # the offered load and skew every percentile —
                    # and reopen the connection for the next request.
                    status = "transport_error"
                    conn.close()
                    conn = PredictConnection(addr, timeout=timeout)
                dt = time.monotonic() - t0
                with lock:
                    statuses[status] = statuses.get(status, 0) + 1
                    if status == 200:
                        latencies.append(dt)
        finally:
            conn.close()

    threads = [
        threading.Thread(target=worker, daemon=True)
        for _ in range(max(1, concurrency))
    ]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.monotonic() - t0
    leaf = pool[0]
    while isinstance(leaf, dict):  # first leaf carries the batch dim
        leaf = leaf[sorted(leaf)[0]]
    batch = int(np.shape(leaf)[0])
    ok = statuses.get(200, 0)
    return {
        "requests": requests,
        "concurrency": concurrency,
        "request_batch": batch,
        "elapsed_s": round(elapsed, 4),
        "ok": ok,
        "statuses": {str(k): v for k, v in sorted(statuses.items())},
        "throughput_rps": round(ok / elapsed, 2) if elapsed else 0.0,
        "throughput_eps": round(ok * batch / elapsed, 2) if elapsed
        else 0.0,
        "p50_ms": round(_percentile(latencies, 50) * 1e3, 3),
        "p99_ms": round(_percentile(latencies, 99) * 1e3, 3),
        "latencies_ms": [round(v * 1e3, 3) for v in latencies],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("serve_client")
    parser.add_argument("--addr", default="localhost:8500")
    parser.add_argument("--requests", type=int, default=200)
    parser.add_argument("--concurrency", type=int, default=8)
    parser.add_argument("--batch", type=int, default=1,
                        help="examples per request")
    parser.add_argument("--timeout", type=float, default=30.0)
    parser.add_argument("--warmup", type=int, default=3,
                        help="untimed warmup requests (compile)")
    parser.add_argument("--seed", type=int, default=0,
                        help="base seed for synthetic payloads")
    parser.add_argument("--payload_pool", type=int, default=1,
                        help="distinct payloads cycled across "
                             "requests (id diversity for row-cache "
                             "benching)")
    parser.add_argument("--dump-latencies", action="store_true",
                        help="include the raw per-request latency "
                             "array (multi-process aggregation)")
    args = parser.parse_args(argv)

    signature = fetch_signature(args.addr)
    if signature is None:
        print("server bundle records no feature_signature; re-export "
              "with a batch_example", file=sys.stderr)
        return 2
    pool = [
        synth_features(signature, args.batch,
                       seed=args.seed + 1000 * i)
        for i in range(max(1, args.payload_pool))
    ]
    for _ in range(args.warmup):
        predict_once(args.addr, pool[0], timeout=args.timeout)
    result = run_load(
        args.addr, pool, args.requests, args.concurrency,
        timeout=args.timeout,
    )
    if not args.dump_latencies:
        result.pop("latencies_ms", None)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
