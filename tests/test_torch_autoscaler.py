"""The port's autoscaler (``elasticdl_tpu_torch/master/autoscaler.py``) and
critical-path reduction (``observability/critical_path.py``) held to the
JAX package's on the CPU.

``AutoscalePolicy.direction`` gives JAX's decision over a grid of
signals; ``Autoscaler`` under a fake clock issues the same decisions at
the same ticks (hysteresis, cooldown, streak resets) and meters them
the same; ``RowServicePodScaler`` over fake shard-map controllers and
instance managers makes the same grow, merge and drain calls;
the signal functions agree; ``critical_path.analyze`` and
``render_report`` give JAX's report on the same seeded span trees. The
port's master builds the autoscaler under ``--autoscale`` (pods through
its instance manager), with ``--autoscale_from_timeseries`` over its
time-series store (held to JAX in tests/test_torch_slo.py).
"""

import itertools
import time

import numpy as np
import pytest

from elasticdl_tpu.master import autoscaler as jas
from elasticdl_tpu.observability import critical_path as jcp
from elasticdl_tpu.observability.registry import MetricsRegistry as JaxReg
from elasticdl_tpu_torch.master import autoscaler as pas
from elasticdl_tpu_torch.observability import critical_path as pcp
from elasticdl_tpu_torch.observability.registry import (
    MetricsRegistry as PortReg,
)

PKGS = {"jax": (jas, JaxReg), "port": (pas, PortReg)}

GRID = list(itertools.product(
    (0, 3, 5, 40),            # queue_depth
    (1, 2, 4),                # live_workers
    (None, 0.1, 0.5, 0.95),   # step_utilization
    (None, "fetch", "device_step"),
    (False, True),            # resize_pending
))


@pytest.mark.parametrize("policy", [
    {}, {"min_workers": 2, "max_workers": 2},
    {"scale_up_backlog_factor": 1.0, "scale_up_utilization": 0.4,
     "scale_down_utilization": 0.6, "max_workers": 8}])
def test_policy_decides_as_jax(policy):
    decisions = {}
    for tag, (mod, _) in PKGS.items():
        p = mod.AutoscalePolicy(**policy)
        decisions[tag] = [
            p.direction(mod.AutoscaleSignals(
                queue_depth=q, doing=1, live_workers=w,
                step_utilization=u, p99_dominant_phase=phase,
                resize_pending=pending))
            for q, w, u, phase, pending in GRID]
    assert decisions["port"] == decisions["jax"]
    assert {"up", "down", "hold"} <= set(decisions["port"]) or policy


def scripted_signals(mod, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(15):  # each draw holds for 4 ticks
        out += 4 * [mod.AutoscaleSignals(
            queue_depth=int(rng.choice([0, 0, 2, 12])),
            doing=int(rng.integers(0, 3)),
            live_workers=int(rng.integers(1, 5)),
            step_utilization=float(rng.choice([0.1, 0.5, 0.9])),
            p99_task_secs=float(rng.random()),
            p99_dominant_phase=str(rng.choice(["device_step", "fetch"])))]
    return out


@pytest.mark.parametrize("seed,hysteresis,cooldown", [
    (6, 1, 0.0), (1, 3, 60.0), (6, 2, 5.0)])
def test_autoscaler_ticks_as_jax(seed, hysteresis, cooldown):
    runs = {}
    for tag, (mod, reg_cls) in PKGS.items():
        clock = {"t": 0.0}
        signals = iter(scripted_signals(mod, seed))
        acted = []
        registry = reg_cls()
        scaler = mod.Autoscaler(
            mod.AutoscalePolicy(hysteresis_ticks=hysteresis,
                                cooldown_secs=cooldown, max_workers=4),
            lambda: next(signals),
            scale_up=lambda s: acted.append(("up", s.queue_depth)),
            scale_down=lambda s: acted.append(("down", s.queue_depth)),
            metrics_registry=registry, clock=lambda: clock["t"])
        ticks = []
        for _ in range(60):
            clock["t"] += 2.0
            ticks.append(scaler.tick())
        counts = {d: registry.counter(
            "master_autoscale_decisions_total", "", ["direction"]
        ).labels(d).value for d in ("up", "down")}
        runs[tag] = (ticks, acted, scaler.decisions, counts,
                     scaler._m_streak.labels().value)
    assert runs["port"] == runs["jax"]
    assert {"up", "down"} & set(runs["port"][0])


class FakeMap:
    def __init__(self, shards):
        self.shards = list(shards)


class FakeController:
    """A shard-map authority: split appends the new address, merge drops
    the source at the next retire()."""

    def __init__(self, shards, traffic, fail_split=False):
        self.map = FakeMap(shards)
        self.traffic = traffic
        self.fail_split = fail_split
        self.calls = []
        self._merged = []

    def poll_stats(self):
        return {s: {"pulled_rows": t, "pushed_rows": t // 2}
                for s, t in enumerate(self.traffic)}

    def split(self, source, new_addr):
        self.calls.append(("split", source, new_addr))
        if self.fail_split:
            raise RuntimeError("target never answered")
        self.map.shards.append(new_addr)
        self.traffic.append(0)

    def merge(self, source, target):
        self.calls.append(("merge", source, target))
        self._merged.append(self.map.shards[source])

    def retire(self):
        for addr in self._merged:
            i = self.map.shards.index(addr)
            del self.map.shards[i]
            del self.traffic[i]
        self._merged = []


class FakeManager:
    def __init__(self, shards):
        self.shards = dict(shards)
        self.calls = []

    def row_service_shards(self):
        return dict(self.shards)

    def add_row_service_shard(self):
        shard = max(self.shards) + 1
        self.shards[shard] = f"pod-{shard}"
        self.calls.append(("add", shard))
        return shard

    def drain_row_service_shard(self, shard):
        self.calls.append(("drain", shard))
        return self.shards.pop(shard, None) is not None


def addr(shard):
    return f"svc-{shard}:6100"


def pod_scaler_run(mod, reg_cls, fail_split=False):
    ctrl = FakeController([addr(0), addr(1)], [50, 400],
                          fail_split=fail_split)
    im = FakeManager({0: "pod-0", 1: "pod-1"})
    scaler = mod.RowServicePodScaler(ctrl, im, addr,
                                     metrics_registry=reg_cls())
    seen = [scaler.grow(), scaler.tick()]
    if not fail_split:
        ctrl.traffic[2] = 5
        seen += [scaler.shrink(), scaler.tick(), scaler.shrink()]
        ctrl.retire()
        seen += [scaler.tick(), scaler.tick(), scaler.shrink()]
    return seen, ctrl.calls, im.calls, scaler.events, ctrl.map.shards


@pytest.mark.parametrize("fail_split", [False, True])
def test_row_pod_scaler_acts_as_jax(fail_split):
    runs = {tag: pod_scaler_run(mod, reg, fail_split)
            for tag, (mod, reg) in PKGS.items()}
    assert runs["port"] == runs["jax"]
    seen, ctrl_calls, im_calls, events, shards = runs["port"]
    if fail_split:
        assert seen[0] is None and im_calls == [("add", 2), ("drain", 2)]
    else:
        # Pod first, then the split of the hottest shard onto it; the
        # merged pod drains only after the controller retired its slot.
        assert seen[0] == {"action": "add", "im_shard": 2,
                           "addr": addr(2), "source": 1}
        assert ctrl_calls == [("split", 1, addr(2)), ("merge", 2, 1),
                              ("merge", 0, 1)]
        assert seen[3] is None  # not retired yet: the pod keeps serving
        assert im_calls == [("add", 2), ("drain", 0), ("drain", 2)]
        assert [e["action"] for e in events] == ["add", "merge", "merge",
                                                 "drain", "drain"]
        assert shards == [addr(1)]


def test_signal_functions_agree():
    snaps = {0: {"families": [{"name": "edl_tpu_worker_step_utilization",
                               "series": [{"value": 0.8}]}]},
             1: {"families": [{"name": "edl_tpu_worker_step_utilization",
                               "series": [{"value": 0.3},
                                          {"value": 0.1}]}]},
             2: {"families": [{"name": "other", "series": []}]}}

    class Store:
        def __init__(self, values):
            self.values = values

        def gauge_values(self, name, window):
            return self.values

    for snapshots in ({}, {2: snaps[2]}, snaps):
        assert pas.utilization_from_snapshots(snapshots) == \
            jas.utilization_from_snapshots(snapshots)
    for values in ([], [0.9, 0.1]):
        assert pas.utilization_from_timeseries(Store(values), 60) == \
            jas.utilization_from_timeseries(Store(values), 60)
    spans = span_trees(3)
    assert pas.p99_attribution(spans) == jas.p99_attribution(spans)
    assert pas.p99_attribution([]) == jas.p99_attribution([]) == (0.0,
                                                                  None)

    class Disp:
        def queue_depths(self):
            return (7, 2)

    class Servicer:
        def resize_status(self):
            return {"resize_id": 1}

    class Cluster:
        def snapshots(self):
            return snaps

    class Plane:
        cluster = Cluster()

        def trace_spans(self):
            return spans

    got = pas.master_signals(Disp(), Servicer(), Plane(), lambda: 0)()
    want = jas.master_signals(Disp(), Servicer(), Plane(), lambda: 0)()
    assert vars(got) == vars(want)


def span_trees(seed, tasks=40):
    """Task spans with phase children (fetch, device_step, report) and
    device_step spans with their own children, durations seeded."""
    rng = np.random.default_rng(seed)
    spans, ids = [], itertools.count(1)
    for t in range(tasks):
        tid = f"s{next(ids)}"
        dur = float(rng.uniform(0.05, 0.3) * (8 if t % 13 == 0 else 1))
        spans.append({"name": "task", "span_id": tid, "trace_id": f"t{t}",
                      "dur": dur, "role": "worker", "instance": t % 3,
                      "attrs": {"task_id": t}})
        left = dur
        for name in ("get_task", "fetch", "device_step", "report"):
            part = float(rng.uniform(0, left * 0.6))
            left -= part
            sid = f"s{next(ids)}"
            spans.append({"name": name, "span_id": sid, "parent_id": tid,
                          "trace_id": f"t{t}", "dur": part})
            if name == "device_step":
                spans.append({"name": "kernel", "span_id": f"s{next(ids)}",
                              "parent_id": sid, "trace_id": f"t{t}",
                              "dur": part * float(rng.random())})
    return spans


@pytest.mark.parametrize("seed,top_k", [(0, 3), (1, 1), (2, 5)])
def test_critical_path_reports_as_jax(seed, top_k):
    spans = span_trees(seed)
    got, want = pcp.analyze(spans, top_k=top_k), jcp.analyze(spans,
                                                            top_k=top_k)
    assert got == want
    assert got["tasks"]["count"] == 40 and got["steps"]["count"] == 40
    assert pcp.render_report(got) == jcp.render_report(want)
    empty = [{"name": "other", "span_id": "x", "trace_id": "t"}]
    assert pcp.analyze(empty) == jcp.analyze(empty)
    assert pcp.render_report(pcp.analyze(empty)) == \
        jcp.render_report(jcp.analyze(empty))
    for values, q in (([], 50), ([3.0], 99), ([5.0, 1.0, 2.0, 4.0], 50)):
        assert pcp.percentile(values, q) == jcp.percentile(values, q)


class Pods:
    def __init__(self):
        self.created, self.deleted = [], []

    def get_pod(self, name):
        return None

    def create_pod(self, manifest):
        self.created.append(manifest["metadata"]["name"])

    create_service = create_pod

    def delete_pod(self, name, **kw):
        self.deleted.append(name)
        return True

    def watch_job_pods(self, job_name, callback, stop):
        pass


def test_master_scales_worker_pods(tmp_path):
    from elasticdl_tpu_torch.common.args import parse_master_args
    from elasticdl_tpu_torch.master.main import Master
    from elasticdl_tpu_torch.testing import data as tdata

    train = tdata.create_mnist_record_file(str(tmp_path / "t.rec"), 256,
                                           seed=1)
    flags = ["--model_zoo", tdata.model_zoo_dir(), "--model_def",
             "mnist.mnist_functional.custom_model", "--training_data",
             train, "--minibatch_size", "16", "--num_minibatches_per_task",
             "1", "--master_addr", "localhost:0", "--job_name", "as",
             "--image_name", "img", "--autoscale",
             "--autoscale_max_workers", "2",
             "--autoscale_hysteresis_ticks", "1",
             "--autoscale_cooldown_secs", "0.001"]
    # The trend signal reads the master's time-series store (an empty
    # window falls back to the snapshot, so the ticks below are the
    # same as without the flag).
    pods = Pods()
    master = Master(parse_master_args(
        flags + ["--autoscale_from_timeseries"]), k8s_client=pods)
    try:
        assert master.metrics_plane.timeseries is not None
        master.prepare()
        assert master.autoscaler.policy.max_workers == 2
        assert master.autoscaler.tick() == "up"  # 16 tasks queued
        assert pods.created == ["elasticdl-tpu-as-worker-0",
                                "elasticdl-tpu-as-worker-1"]
        assert master.autoscaler.tick() is None  # at the ceiling
        # Drained queue, idle fleet: the youngest worker is drained.
        while master.task_dispatcher.get(worker_id=0) is not None:
            pass
        sig = pas.AutoscaleSignals(queue_depth=0, live_workers=2,
                                   step_utilization=0.1)
        master.autoscaler._signals_fn = lambda: sig
        time.sleep(0.01)  # past the cooldown
        assert master.autoscaler.tick() == "down"
        assert pods.deleted == ["elasticdl-tpu-as-worker-1"]
        assert set(master.instance_manager.live_workers) == {0}
    finally:
        master.stop()
