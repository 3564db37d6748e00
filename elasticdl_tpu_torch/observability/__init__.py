"""Telemetry plane of the port (port of elasticdl_tpu/observability,
the whole plane):

- ``registry``: process-local counters, gauges and histograms (labeled
  families, thread-safe) that the checkpoint saver, writer and hook,
  the task dispatcher, the servicer, the host engine and the worker's
  step loop feed;
- ``tracing``: spans into a bounded flight recorder, with the trace
  context propagated through the RPC layer (``comm/rpc.py``);
- ``trace_export``: Chrome/Perfetto ``trace_event`` JSON export and the
  ``trace`` CLI command;
- ``critical_path``: per-step critical-path and straggler reports over
  collected span trees;
- ``aggregator``: the master's cluster view of the snapshots that ride
  each RPC, and ``MetricsPlane`` (``/metrics``, ``/traces``,
  ``/timeseries``, ``/alerts``, ``/profile``, ``/usage``);
- ``exposition``: Prometheus text over a stdlib HTTP endpoint;
- ``principal`` and ``usage``: the workload principal that rides every
  RPC and the per-principal metering of each request;
- ``profiler``: the sampling profiler, its windows piggybacked to the
  master's ``ProfileStore`` and served on ``/profile``;
- ``reporter``: ``ComponentMetricsReporter``, the snapshot push of a
  process with no task loop (row service, serving replica, router,
  standby master);
- ``timeseries``: the master's ring time-series store over the
  registries above;
- ``slo``: declarative SLO rules evaluated on the master tick,
  ``/alerts``, and the incident bundles of ``IncidentRecorder``;
- ``prober``: the black-box canaries behind ``/probes`` and
  ``/healthz``.

Metric names follow ``edl_tpu_<layer>_<name>``, as there.
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
from elasticdl_tpu_torch.observability.profiler import (  # noqa: F401
    ProfileStore,
    SamplingProfiler,
)
from elasticdl_tpu_torch.observability.registry import (  # noqa: F401
    MetricsRegistry,
    default_registry,
)
from elasticdl_tpu_torch.observability.slo import (  # noqa: F401
    IncidentRecorder,
    SLOEngine,
    SLORule,
    default_rules,
    load_rules,
)
from elasticdl_tpu_torch.observability.timeseries import (  # noqa: F401
    TimeSeriesStore,
)
from elasticdl_tpu_torch.observability.tracing import (  # noqa: F401
    FlightRecorder,
    TraceCollector,
    Tracer,
)
