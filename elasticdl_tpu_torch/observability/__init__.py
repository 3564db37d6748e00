"""Telemetry plane of the port (the part of elasticdl_tpu/observability
that the checkpoint slice needs).

- ``registry``: process-local counters, gauges and histograms (labeled
  families, thread-safe) that the checkpoint saver, writer and hook
  feed (``checkpoint_*`` families);
- ``tracing``: spans into a bounded flight recorder (the checkpoint
  writer's ``ckpt_write`` span).

The aggregator, Prometheus exposition, SLO engine, profiler and the
rest of the JAX package's plane are not ported yet. Metric names follow
``edl_tpu_<layer>_<name>``, as there.
"""

from elasticdl_tpu_torch.observability import tracing  # noqa: F401
from elasticdl_tpu_torch.observability.registry import (  # noqa: F401
    MetricsRegistry,
    default_registry,
)
