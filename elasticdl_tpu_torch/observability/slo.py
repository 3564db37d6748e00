"""The per-replica SLO window of the serving router (port of
``RollingWindow`` from elasticdl_tpu/observability/slo.py).

The JAX module's SLO engine, its rules and the incident recorder run on
the master over the time-series store; they are not ported yet (ROADMAP
Queue 1, item 8). The router needs only this window.
"""

import threading
import time
from collections import deque
from typing import Optional


class RollingWindow:
    """A bounded deque of ``(t, ok, latency)`` samples with windowed
    error-ratio and p95 reductions (one per replica in the router)."""

    def __init__(self, window_secs: float = 60.0, capacity: int = 2048):
        self.window_secs = float(window_secs)
        self._samples = deque(maxlen=int(capacity))
        self._lock = threading.Lock()

    def record(self, ok: bool, latency_secs: float,
               now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        with self._lock:
            self._samples.append((now, bool(ok), float(latency_secs)))

    def status(self, now: Optional[float] = None) -> dict:
        now = time.monotonic() if now is None else now
        cutoff = now - self.window_secs
        with self._lock:
            live = [s for s in self._samples if s[0] >= cutoff]
        n = len(live)
        if not n:
            return {"window_secs": self.window_secs, "requests": 0,
                    "error_ratio": 0.0, "p95_ms": 0.0}
        errors = sum(1 for _t, ok, _l in live if not ok)
        lats = sorted(lat for _t, _ok, lat in live)
        p95 = lats[min(n - 1, int(round(0.95 * (n - 1))))]
        return {
            "window_secs": self.window_secs,
            "requests": n,
            "error_ratio": round(errors / n, 4),
            "p95_ms": round(p95 * 1e3, 3),
        }
