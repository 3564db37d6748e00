"""Per-phase wall-clock accumulators (port of elasticdl_tpu/common/timing.py,
without its metrics-registry hook: the observability plane is not
ported yet)."""

import contextlib
import time
from collections import defaultdict


class Timing:
    def __init__(self, enabled: bool = False, logger=None):
        self.enabled = enabled
        self._logger = logger
        self.reset()

    def reset(self):
        self._totals = defaultdict(float)
        self._counts = defaultdict(int)
        self._mins = {}
        self._maxs = {}
        self._starts = {}

    def start_record_time(self, phase: str):
        if self.enabled:
            self._starts[phase] = time.monotonic()

    def end_record_time(self, phase: str):
        if self.enabled and phase in self._starts:
            elapsed = time.monotonic() - self._starts.pop(phase)
            self._totals[phase] += elapsed
            self._counts[phase] += 1
            if phase not in self._mins or elapsed < self._mins[phase]:
                self._mins[phase] = elapsed
            if phase not in self._maxs or elapsed > self._maxs[phase]:
                self._maxs[phase] = elapsed

    @contextlib.contextmanager
    def record(self, phase: str):
        self.start_record_time(phase)
        try:
            yield
        finally:
            self.end_record_time(phase)

    def summary(self) -> dict:
        return {
            phase: {
                "total_secs": total,
                "count": self._counts[phase],
                "min_secs": self._mins[phase],
                "max_secs": self._maxs[phase],
            }
            for phase, total in sorted(self._totals.items())
        }

    def report_timing(self, reset: bool = False):
        if self.enabled and self._logger is not None:
            for phase, stats in self.summary().items():
                self._logger.debug(
                    "Phase %s: %.3fs over %d calls (min %.3fs, max %.3fs)",
                    phase, stats["total_secs"], stats["count"],
                    stats["min_secs"], stats["max_secs"],
                )
        if reset:
            self.reset()
