"""Telemetry plane of the port (the part of elasticdl_tpu/observability
that the checkpoint slice, the master's task plane and serving need).

- ``registry``: process-local counters, gauges and histograms (labeled
  families, thread-safe) that the checkpoint saver, writer and hook,
  the task dispatcher, the servicer and the worker's step loop feed;
- ``tracing``: spans into a bounded flight recorder, with the trace
  context propagated through the RPC layer (``comm/rpc.py``);
- ``aggregator``: the master's cluster view of the worker snapshots
  that ride each RPC, and ``MetricsPlane``;
- ``exposition``: Prometheus text over a stdlib HTTP endpoint
  (``/metrics``, ``/healthz``, ``/traces``);
- ``principal`` and ``usage``: the workload principal that rides every
  RPC and the per-principal metering of each request;
- ``slo``: only ``RollingWindow``, the serving router's per-replica
  SLO window.

The SLO engine, the time-series store, the profiler and the prober of
the JAX package's plane are not ported yet. Metric names follow
``edl_tpu_<layer>_<name>``, as there.
"""

from elasticdl_tpu_torch.observability import tracing  # noqa: F401
from elasticdl_tpu_torch.observability.aggregator import (  # noqa: F401
    ClusterMetrics,
    MetricsPlane,
)
from elasticdl_tpu_torch.observability.exposition import (  # noqa: F401
    MetricsHTTPServer,
    render_prometheus,
)
from elasticdl_tpu_torch.observability.principal import (  # noqa: F401
    Principal,
)
from elasticdl_tpu_torch.observability.registry import (  # noqa: F401
    MetricsRegistry,
    default_registry,
)
