"""Closed-loop elastic autoscaling over the master's own telemetry (port
of elasticdl_tpu/master/autoscaler.py).

The control loop the ROADMAP asked for: the master already *measures*
everything a scaling decision needs — queue depth
(``master_task_queue_depth``), per-worker device saturation
(``worker_step_utilization``, piggybacked in the cluster snapshots),
and per-phase p99 straggler attribution
(``observability/critical_path.py`` over the collected span trees).
This module closes the loop: a policy with hysteresis + cooldown +
min/max bounds reads those signals each master tick and issues scale
decisions through pluggable actions:

- **pod scaling** (k8s): ``InstanceManager.scale_up`` /
  ``InstanceManager.drain_worker`` — more or fewer worker pods pulling
  from the same task queue;
- **mesh scaling** (SPMD): ``MasterServicer.begin_resize`` — the
  checkpointless live-reshard barrier (parallel/reshard.py), where the
  same workers re-place their train state onto a bigger or smaller
  device mesh with no disk round trip.

The policy is deliberately boring and fully unit-testable: decisions
are pure functions of an ``AutoscaleSignals`` snapshot, and all
statefulness (hysteresis streaks, cooldown clock) lives in
``Autoscaler`` behind an injectable clock. What keeps it safe in
production is the plumbing around it, not the thresholds: decisions
are rate-limited (cooldown), damped (hysteresis), bounded (min/max),
and the resize barrier serializes — a new decision is suppressed while
a barrier is pending, and a worker killed mid-barrier cannot wedge it
(the tick refreshes barrier membership from the live worker set).
"""

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("autoscaler")

UP = "up"
DOWN = "down"
HOLD = "hold"


@dataclasses.dataclass
class AutoscaleSignals:
    """One tick's telemetry snapshot (see ``master_signals``)."""

    queue_depth: int = 0          # tasks waiting in todo
    doing: int = 0                # tasks currently leased
    live_workers: int = 1         # current fleet size
    # Mean worker_step_utilization across reporting workers; None when
    # no worker has reported the gauge yet (don't guess — hold).
    step_utilization: Optional[float] = None
    # Critical-path reduction over collected spans (when tracing is
    # on): p99 task latency and its dominant phase. Informational for
    # the decision log; a fetch-dominated p99 also vetoes scale-up
    # (more workers cannot help a job starved on input).
    p99_task_secs: float = 0.0
    p99_dominant_phase: Optional[str] = None
    resize_pending: bool = False


@dataclasses.dataclass
class AutoscalePolicy:
    """Decision thresholds. Defaults are conservative: scale up only
    on real backlog with saturated workers, scale down only when the
    queue is empty and workers are measurably idle."""

    min_workers: int = 1
    max_workers: int = 4
    # Scale up when todo > backlog_factor × live_workers (each worker
    # already has more than a full task of lookahead) AND utilization
    # is high (a starved fleet with a deep queue means input, not
    # compute, is the bottleneck — more workers won't help).
    scale_up_backlog_factor: float = 2.0
    scale_up_utilization: float = 0.7
    # Scale down when nothing queues and utilization is low.
    scale_down_utilization: float = 0.3
    # Consecutive same-direction ticks required before acting.
    hysteresis_ticks: int = 3
    # Quiet period after any decision.
    cooldown_secs: float = 60.0

    def direction(self, s: AutoscaleSignals) -> str:
        """Pure per-tick desired direction, before hysteresis."""
        if s.resize_pending:
            return HOLD
        util = s.step_utilization
        if (
            s.queue_depth > self.scale_up_backlog_factor * max(
                1, s.live_workers
            )
            and s.live_workers < self.max_workers
            and (util is None or util >= self.scale_up_utilization)
            and s.p99_dominant_phase != "fetch"
        ):
            return UP
        if (
            s.queue_depth == 0
            and s.live_workers > self.min_workers
            and util is not None
            and util <= self.scale_down_utilization
        ):
            return DOWN
        return HOLD


class Autoscaler:
    """The loop: read signals, damp, bound, act.

    ``signals_fn``  → AutoscaleSignals for this tick;
    ``scale_up``    → add capacity (one worker / one mesh rung);
    ``scale_down``  → remove capacity;
    both actions receive the signals snapshot. ``clock`` is injectable
    for tests."""

    def __init__(
        self,
        policy: AutoscalePolicy,
        signals_fn: Callable[[], AutoscaleSignals],
        scale_up: Callable[[AutoscaleSignals], None],
        scale_down: Callable[[AutoscaleSignals], None],
        metrics_registry=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        from elasticdl_tpu_torch.observability import default_registry

        self.policy = policy
        self._signals_fn = signals_fn
        self._scale_up = scale_up
        self._scale_down = scale_down
        self._clock = clock
        self._streak_direction = HOLD
        self._streak = 0
        self._last_decision_at: Optional[float] = None
        self.decisions: List[dict] = []
        registry = metrics_registry or default_registry()
        self._m_decisions = registry.counter(
            "master_autoscale_decisions_total",
            "Autoscale decisions issued", ["direction"],
        )
        self._m_streak = registry.gauge(
            "master_autoscale_streak",
            "Consecutive ticks agreeing on the pending direction",
        )

    def _in_cooldown(self, now: float) -> bool:
        return (
            self._last_decision_at is not None
            and now - self._last_decision_at < self.policy.cooldown_secs
        )

    def tick(self) -> Optional[str]:
        """One control-loop iteration; returns the issued direction
        (``"up"``/``"down"``) or None."""
        now = self._clock()
        signals = self._signals_fn()
        direction = self.policy.direction(signals)
        if direction == HOLD:
            self._streak_direction, self._streak = HOLD, 0
            self._m_streak.set(0.0)
            return None
        if direction == self._streak_direction:
            self._streak += 1
        else:
            self._streak_direction, self._streak = direction, 1
        self._m_streak.set(float(self._streak))
        if self._streak < self.policy.hysteresis_ticks:
            return None
        if self._in_cooldown(now):
            return None
        # Act. The streak resets so another full hysteresis window is
        # required on top of the cooldown.
        self._streak_direction, self._streak = HOLD, 0
        self._m_streak.set(0.0)
        self._last_decision_at = now
        self._m_decisions.labels(direction).inc()
        self.decisions.append({
            "direction": direction,
            "signals": dataclasses.asdict(signals),
        })
        logger.info(
            "autoscale %s: queue=%d doing=%d workers=%d util=%s "
            "p99=%.3fs[%s]",
            direction, signals.queue_depth, signals.doing,
            signals.live_workers, signals.step_utilization,
            signals.p99_task_secs, signals.p99_dominant_phase,
        )
        if direction == UP:
            self._scale_up(signals)
        else:
            self._scale_down(signals)
        return direction


class RowServicePodScaler:
    """Closes the PR 12 loop: the shard-map controller could already
    ``split``/``merge`` ranges across row-service processes, but
    nothing ever SPAWNED or REMOVED a process — splits were confined
    to pods that existed at launch. This scaler owns the pod half:

    - ``grow()``  — ``InstanceManager.add_row_service_shard`` (stable
      Service + pod, journaled before the create), then ``split`` the
      hottest live shard onto the new pod's service address. Pod
      first, routes second: the map must never point at an address
      with nothing behind it.
    - ``shrink()`` — ``merge`` the coldest scaled pod's shard into the
      busiest survivor and remember its address as pending. The pod
      keeps serving: clients holding a pre-drain map still route ids
      at it until the controller's quiescence check proves otherwise.
    - ``tick()`` — called after the controller's own tick. When a
      pending address has left the map (the controller retired the
      drained slot), the pod has served its last request:
      ``drain_row_service_shard`` deletes pod + Service without
      triggering the dead-pod relaunch path. Routes first, pod
      second — the mirror of grow.

    Decision *policy* (when to grow/shrink) stays with the caller —
    the master tick, a drill, or an ``Autoscaler`` wired to row
    telemetry; this class only makes the actions safe."""

    def __init__(self, controller, instance_manager,
                 address_fn: Callable[[int], str],
                 metrics_registry=None):
        from elasticdl_tpu_torch.observability import default_registry

        self._controller = controller
        self._im = instance_manager
        self._address_fn = address_fn
        # Service addresses merged away, awaiting the controller's
        # retirement proof. Keyed by ADDRESS, not shard index — map
        # indices shift when a slot is retired.
        self._pending_drain: set = set()
        registry = metrics_registry or default_registry()
        self._m_pods = registry.counter(
            "master_rowservice_pod_scale_total",
            "Row-service pods spawned/drained by the pod scaler",
            ["action"],
        )
        self.events: List[dict] = []

    def _addr_to_im_shard(self) -> Dict[str, int]:
        return {
            self._address_fn(shard): shard
            for shard in self._im.row_service_shards()
        }

    def _traffic_by_shard(self) -> Dict[int, int]:
        stats = self._controller.poll_stats()
        return {
            s: int(per.get("pulled_rows", 0))
            + int(per.get("pushed_rows", 0))
            for s, per in stats.items()
        }

    def grow(self) -> Optional[dict]:
        """Spawn a pod and split the hottest shard onto it. Returns
        ``{"im_shard", "addr", "source"}`` or None (row service off /
        manager stopped / no live map)."""
        shard_map = self._controller.map
        if shard_map is None or not shard_map.shards:
            return None
        im_shard = self._im.add_row_service_shard()
        if im_shard is None:
            return None
        addr = self._address_fn(im_shard)
        traffic = self._traffic_by_shard()
        live = range(len(shard_map.shards))
        source = max(live, key=lambda s: traffic.get(s, 0))
        try:
            self._controller.split(source, new_addr=addr)
        except Exception:
            # The pod exists but the routes never moved: tear it back
            # down rather than leak an unreferenced pod.
            logger.exception(
                "split onto new row-service pod %s failed; draining "
                "the unused pod", addr,
            )
            self._im.drain_row_service_shard(im_shard)
            return None
        self._m_pods.labels("add").inc()
        event = {"action": "add", "im_shard": im_shard,
                 "addr": addr, "source": int(source)}
        self.events.append(event)
        logger.info(
            "row-service pod scale-up: shard %d (%s) split from "
            "shard %d", im_shard, addr, source,
        )
        return event

    def shrink(self) -> Optional[dict]:
        """Merge the coldest scaler-managed pod's shard into the
        busiest survivor; the pod itself drains on a later ``tick``
        once the controller retires the slot. Returns
        ``{"addr", "source", "target"}`` or None (nothing safely
        removable)."""
        shard_map = self._controller.map
        if shard_map is None or len(shard_map.shards) <= 1:
            return None
        by_addr = self._addr_to_im_shard()
        candidates = [
            s for s, addr in enumerate(shard_map.shards)
            if addr in by_addr and addr not in self._pending_drain
        ]
        if len(candidates) < 1 or len(shard_map.shards) - len(
            self._pending_drain
        ) <= 1:
            return None
        traffic = self._traffic_by_shard()
        source = min(candidates, key=lambda s: traffic.get(s, 0))
        survivors = [
            s for s in range(len(shard_map.shards))
            if s != source
            and shard_map.shards[s] not in self._pending_drain
        ]
        if not survivors:
            return None
        target = max(survivors, key=lambda s: traffic.get(s, 0))
        addr = shard_map.shards[source]
        self._controller.merge(source, target)
        self._pending_drain.add(addr)
        self._m_pods.labels("merge").inc()
        event = {"action": "merge", "addr": addr,
                 "source": int(source), "target": int(target)}
        self.events.append(event)
        logger.info(
            "row-service pod scale-down: shard %d (%s) merging into "
            "shard %d; pod drains after retirement", source, addr,
            target,
        )
        return event

    def tick(self) -> Optional[int]:
        """Drain the pod behind any pending address the controller
        has retired from the map. Returns the drained instance-manager
        shard index, or None."""
        if not self._pending_drain:
            return None
        shard_map = self._controller.map
        live = set(shard_map.shards) if shard_map is not None else set()
        by_addr = self._addr_to_im_shard()
        for addr in sorted(self._pending_drain):
            if addr in live:
                continue  # not retired yet: keep serving stale routes
            self._pending_drain.discard(addr)
            im_shard = by_addr.get(addr)
            if im_shard is None:
                continue  # pod already gone (master restart raced)
            self._im.drain_row_service_shard(im_shard)
            self._m_pods.labels("drain").inc()
            self.events.append({"action": "drain",
                                "im_shard": im_shard, "addr": addr})
            logger.info(
                "row-service pod drained after retirement: shard %d "
                "(%s)", im_shard, addr,
            )
            return im_shard
        return None


# ---- signal extraction ---------------------------------------------------


def utilization_from_snapshots(snapshots: Dict[int, dict],
                               ) -> Optional[float]:
    """Mean ``worker_step_utilization`` across the live cluster
    snapshots; None when no worker has published the gauge."""
    values = []
    for snapshot in snapshots.values():
        for family in snapshot.get("families", []):
            if family.get("name") == "edl_tpu_worker_step_utilization":
                for series in family.get("series", []):
                    values.append(float(series.get("value", 0.0)))
    if not values:
        return None
    return sum(values) / len(values)


def p99_attribution(spans: List[dict]) -> tuple:
    """(p99_task_secs, dominant_phase) from the collected span trees —
    the critical-path reduction's headline, as an autoscale input."""
    from elasticdl_tpu_torch.observability import critical_path

    if not spans:
        return 0.0, None
    report = critical_path.analyze(spans)
    tasks = report.get("tasks")
    if not tasks:
        return 0.0, None
    p99 = tasks.get("p99") or {}
    return float(tasks.get("p99_secs", 0.0)), p99.get("dominant_phase")


def utilization_from_timeseries(store, window_secs: float,
                                ) -> Optional[float]:
    """Mean ``worker_step_utilization`` over the trailing time-series
    window — the trend-backed alternative to the instantaneous
    snapshot mean. One worker flapping between 0.9 and 0.1 across two
    report intervals reads as ~0.5 here instead of whichever extreme
    the tick happened to land on; None when the window holds no points
    (same don't-guess contract as the snapshot path)."""
    values = store.gauge_values(
        "edl_tpu_worker_step_utilization", window_secs
    )
    if not values:
        return None
    return sum(values) / len(values)


def master_signals(dispatcher, servicer, metrics_plane,
                   live_workers_fn: Callable[[], int],
                   with_traces: bool = True,
                   timeseries=None,
                   trend_window_secs: float = 120.0,
                   ) -> Callable[[], AutoscaleSignals]:
    """Bind the master's live objects into a ``signals_fn``.

    ``timeseries`` (a ``TimeSeriesStore``, opted in via
    ``--autoscale_from_timeseries``) replaces the instantaneous
    utilization snapshot with the mean over ``trend_window_secs`` —
    decisions then damp over the window like the SRE-style alerts do,
    instead of reacting to whichever report the tick caught. The
    snapshot path stays the default (and the fallback while the window
    is still empty)."""

    def signals() -> AutoscaleSignals:
        queue_depth, doing = dispatcher.queue_depths()
        util = None
        if timeseries is not None:
            util = utilization_from_timeseries(
                timeseries, trend_window_secs
            )
        if util is None:
            util = utilization_from_snapshots(
                metrics_plane.cluster.snapshots()
            )
        p99_secs, p99_phase = (0.0, None)
        if with_traces and queue_depth > 0:
            # The p99 attribution only gates the scale-UP veto, and
            # merging + analyzing the full span store is O(collected
            # spans) — skip it on idle ticks (empty queue can never
            # scale up).
            p99_secs, p99_phase = p99_attribution(
                metrics_plane.trace_spans()
            )
        return AutoscaleSignals(
            queue_depth=queue_depth,
            doing=doing,
            live_workers=max(1, int(live_workers_fn())),
            step_utilization=util,
            p99_task_secs=p99_secs,
            p99_dominant_phase=p99_phase,
            resize_pending=servicer.resize_status() is not None,
        )

    return signals
