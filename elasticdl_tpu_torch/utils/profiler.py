"""Step-window ``torch.profiler`` trace of the worker (port of
elasticdl_tpu/utils/profiler.py).

The reference's only tracing is wall-clock phase accumulators
(common/timing.py). On the card the interesting time is *inside* the
step, which host timers cannot see — so this wraps ``torch.profiler``:
a step-window trace with CPU and CUDA activities, one Chrome trace
(Perfetto-loadable) a window, the card's kernels named beside the host
ops that launched them, plus named annotations (``record_function``)
that show host phases on the same timeline.

Wired via ``--profile_dir`` (+ ``--profile_start_step/--profile_steps``):
the worker starts the trace when the step window opens and stops it when
it closes, so steady-state steps are captured rather than set-up. A
trace that cannot start or whose file is not written raises: the window
never quietly leaves nothing.
"""

import contextlib
import os
from typing import Optional

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("profiler")


class TorchProfilerBackend:
    """``start_trace(dir)`` / ``stop_trace()`` over one
    ``torch.profiler.profile`` at a time (CPU activities, and CUDA ones
    when a card is present); ``stop_trace`` exports the window as
    ``<dir>/trace-<pid>-<n>.json`` and returns the path.
    ``TraceAnnotation`` is ``torch.profiler.record_function``."""

    def __init__(self):
        self._prof = None
        self._dir = ""
        self._windows = 0
        self.last_trace_path = ""

    @property
    def TraceAnnotation(self):  # noqa: N802 (the JAX backend's name)
        import torch

        return torch.profiler.record_function

    def start_trace(self, log_dir: str):
        import torch

        if self._prof is not None:
            raise RuntimeError("a torch.profiler trace is already started")
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        self._prof = prof
        self._dir = log_dir

    def stop_trace(self) -> str:
        if self._prof is None:
            raise RuntimeError("no torch.profiler trace is started")
        prof, self._prof = self._prof, None
        prof.stop()
        path = os.path.join(
            self._dir, f"trace-{os.getpid()}-{self._windows}.json"
        )
        self._windows += 1
        prof.export_chrome_trace(path)
        if not os.path.isfile(path) or os.path.getsize(path) == 0:
            raise RuntimeError(f"torch.profiler wrote no trace at {path}")
        self.last_trace_path = path
        return path


class Profiler:
    """Step-windowed ``torch.profiler`` trace.

    ``observe_step(step)`` is called once per training step; the trace
    runs for steps [start_step, start_step + num_steps). The window is
    closed by ``stop()`` — the worker calls it on loop exit so a
    training run that ends (or is preempted) before the window fills
    still lands its trace, and a later ``start_trace`` in the process
    doesn't raise "already started".

    ``backend`` defaults to ``TorchProfilerBackend``; tests inject a
    fake with the same ``start_trace``/``stop_trace`` surface.
    """

    def __init__(self, profile_dir: str = "", start_step: int = 5,
                 num_steps: int = 5, backend=None):
        self.profile_dir = profile_dir
        self.start_step = int(start_step)
        self.num_steps = int(num_steps)
        self._backend = backend
        self._active = False
        self._done = False
        self._window_end = None

    @property
    def enabled(self) -> bool:
        return bool(self.profile_dir)

    def _get_backend(self):
        if self._backend is None:
            self._backend = TorchProfilerBackend()
        return self._backend

    def observe_step(self, step: int):
        if not self.enabled or self._done:
            return
        if not self._active and step >= self.start_step:
            self._get_backend().start_trace(self.profile_dir)
            self._active = True
            self._window_end = step + self.num_steps
            logger.info(
                "profiler: tracing steps %d..%d to %s",
                step, self._window_end - 1, self.profile_dir,
            )
        elif self._active and step >= self._window_end:
            self.stop()
        # step < window_end while active (out-of-order final steps — a
        # restored state can rewind the counter): keep tracing; stop()
        # on loop exit closes the window regardless.

    def stop(self):
        if self._active:
            self._get_backend().stop_trace()
            self._active = False
            self._done = True
            logger.info("profiler: trace written to %s", self.profile_dir)

    @contextlib.contextmanager
    def annotation(self, name: str):
        """Host-phase annotation visible on the device timeline."""
        if not self.enabled:
            yield
            return
        annotate = getattr(self._get_backend(), "TraceAnnotation", None)
        if annotate is None:  # fake backends need not implement it
            yield
            return
        with annotate(name):
            yield


def from_args(args) -> Optional[Profiler]:
    profile_dir = getattr(args, "profile_dir", "")
    if not profile_dir:
        return None
    return Profiler(
        profile_dir,
        start_step=getattr(args, "profile_start_step", 5),
        num_steps=getattr(args, "profile_steps", 5),
    )
