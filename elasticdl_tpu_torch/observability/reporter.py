"""Fold a standalone component's telemetry into the master's cluster
view.

Workers piggyback registry snapshots on RPCs they already make; a
process with no task loop (the serving router, a predict replica, a
row-service shard) has nothing to piggyback on, so this thread
periodically pushes the snapshot over the master's ``report_metrics``
RPC instead. The master keys it ``<component>-<id>`` — same TTL aging,
same exposition (``worker="router-0"`` / ``worker="serving-1"``
labels), same time-series sampling as any worker, which is what lets
master-side SLO rules (e.g. the default ``row-freshness`` rule over
the replicas' ``edl_tpu_row_freshness_seconds``) watch the whole fleet
(docs/observability.md "Time series").

Like the worker's piggyback, the snapshot carries the process's trace
spans (``spans`` key) and continuous-profiling windows (``profiles``
key) when a flight recorder / sampling profiler is installed — cursors
commit only on a CONFIRMED delivery, so spans/windows offered on a
failed report are re-offered next interval instead of being lost with
the outage they describe.
"""

import threading

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("metrics_reporter")


class ComponentMetricsReporter(threading.Thread):
    """Daemon thread pushing this process's registry snapshot to the
    master every ``interval_secs``. Master unavailability degrades to
    a warning + channel rebuild (a refused gRPC channel can wedge
    permanently in-container — the PR 5/6 lesson), never an error in
    the component itself."""

    def __init__(self, master_addr: str, component: str,
                 component_id: int = 0, interval_secs: float = 15.0,
                 registry=None):
        super().__init__(
            daemon=True, name=f"{component}-metrics-report"
        )
        from elasticdl_tpu_torch.observability import default_registry

        self._master_addr = master_addr
        self._component = str(component)
        self._component_id = int(component_id)
        self._interval = max(0.5, float(interval_secs))
        self._registry = registry or default_registry()
        self._stop = threading.Event()
        self._stub = None
        self._span_cursor = 0
        self._profile_cursor = 0
        self.reports_sent = 0
        # Decorrelated-jitter backoff after failed reports: a master
        # failover fails EVERY component's report at the same instant,
        # and per-interval retries in lockstep would stampede the
        # promoted standby (comm/rpc.decorrelated_jitter). Reset on
        # the first confirmed delivery.
        self._retry_delay = 0.0

    def send_once(self):
        from elasticdl_tpu_torch.comm.rpc import RpcStub
        from elasticdl_tpu_torch.observability import profiler, tracing

        if self._stub is None:
            self._stub = RpcStub(
                self._master_addr, "elasticdl_tpu.Master"
            )
        snapshot = self._registry.snapshot()
        spans, span_offer = tracing.spans_since(self._span_cursor)
        if spans:
            snapshot["spans"] = spans
        windows, profile_offer = profiler.windows_since(
            self._profile_cursor
        )
        if windows:
            snapshot["profiles"] = windows
        try:
            from elasticdl_tpu_torch.observability import principal

            # Telemetry pushes are control-plane chatter, tagged as
            # such so the master's usage meter never files them under
            # a workload (the reporter thread has no ambient
            # principal of its own).
            with principal.pushed(component=self._component,
                                  purpose="control"):
                self._stub.call(
                    "report_metrics", component=self._component,
                    component_id=self._component_id,
                    metrics=snapshot,
                )
            # Confirmed delivery: advance past what this report
            # carried (the master dedups re-offers anyway — by span id
            # and by window (seq, t0) — but the cursors keep re-sends
            # bounded).
            self._span_cursor = span_offer
            self._profile_cursor = profile_offer
            self.reports_sent += 1
            self._retry_delay = 0.0
        except Exception as exc:
            from elasticdl_tpu_torch.comm.rpc import decorrelated_jitter

            self._retry_delay = decorrelated_jitter(
                self._retry_delay,
                base=0.5, cap=self._interval,
            )
            logger.warning(
                "%s-%d master metrics report failed (backing off "
                "%.2fs extra): %s",
                self._component, self._component_id,
                self._retry_delay, exc,
            )
            try:
                # The rebuild also rotates a multi-address master
                # target (failover re-resolve).
                self._stub.reconnect()
            except Exception:
                self._stub = None

    def run(self):
        # The jittered extra delay decorrelates the fleet's retries
        # after an outage hits everyone at once.
        while not self._stop.wait(self._interval + self._retry_delay):
            self.send_once()

    def stop(self):
        self._stop.set()
