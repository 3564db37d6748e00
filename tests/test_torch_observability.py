"""The port's metrics registry and tracing
(``elasticdl_tpu_torch/observability``) against the JAX package's.

- The same sequence of registry calls (counters, gauges with a
  pull-time function, labeled families, histograms with custom buckets,
  exemplars stamped by an open span, idempotent re-declaration, reset)
  gives equal ``snapshot()``s in both packages, once the fields that
  carry time or random ids are taken out (the instance token, the
  exemplars' trace ids and wall times).
- Misuse raises the same errors in both.
- Spans the port records (``span``, ``Tracer``, ``child_span``,
  ``server_span``, ``record_span``) carry the JAX spans' fields with the
  same parenthood, and the flight recorder's ring and cursor behave the
  same.
"""

import pytest

from elasticdl_tpu.observability import registry as jax_registry
from elasticdl_tpu.observability import tracing as jax_tracing
from elasticdl_tpu_torch.observability import registry as port_registry
from elasticdl_tpu_torch.observability import tracing as port_tracing

PACKAGES = {"jax": (jax_registry, jax_tracing),
            "port": (port_registry, port_tracing)}


def _script(registry_mod, tracing_mod):
    """One fixed sequence of registry calls; returns the snapshots."""
    reg = registry_mod.MetricsRegistry(namespace="edl_tpu")
    snaps = []
    c = reg.counter("checkpoint_saves_total", "Checkpoint versions written")
    c.inc()
    c.inc(2.5)
    by_kind = reg.counter("checkpoint_bytes_written_total", "bytes",
                          ["kind"])
    by_kind.labels("full").inc(100)
    by_kind.labels(kind="delta").inc(7)
    g = reg.gauge("checkpoint_writer_queue_depth", "depth")
    g.set(3)
    g.dec()
    g.inc(0.5)
    live = reg.gauge("live_rows", "rows", ["table"])
    live.labels("emb").set_function(lambda: 42.0)
    h = reg.histogram("checkpoint_save_seconds", "save")
    for v in (0.00005, 0.003, 0.2, 7.0, 500.0):
        h.observe(v)
    custom = reg.histogram("sizes", "bytes", ["kind"],
                           buckets=(10, 1, 100))
    custom.labels("a").observe(5)
    custom.labels("b").observe(1000)
    snaps.append(reg.snapshot())
    # idempotent re-declaration returns the same family
    assert reg.counter("checkpoint_saves_total") is c
    stall = reg.histogram("checkpoint_stall_seconds", "stall",
                          exemplars=True)
    rec = tracing_mod.install_recorder(tracing_mod.FlightRecorder(8))
    try:
        with tracing_mod.span("ckpt_write", label="v1"):
            stall.observe(0.02)
        stall.observe(0.3)                  # no open span: no exemplar
        stall.observe(0.4, trace_id="abc")  # explicit id
    finally:
        tracing_mod.uninstall_recorder()
    assert len(rec) == 1
    snaps.append(reg.snapshot())
    reg.reset()
    assert reg.generation == 1
    reg.counter("after_reset").inc()
    snaps.append(reg.snapshot())
    return snaps


def _scrub(snapshot):
    out = {k: v for k, v in snapshot.items() if k != "instance"}
    families = []
    for family in snapshot["families"]:
        family = dict(family)
        series = []
        for s in family["series"]:
            s = dict(s)
            if "exemplars" in s:
                s["exemplars"] = {
                    k: [v[0], "explicit" if v[1] == "abc" else "span"]
                    for k, v in s["exemplars"].items()}
            series.append(s)
        family["series"] = series
        families.append(family)
    out["families"] = families
    return out


def test_snapshots_equal_the_jax_registry():
    jax_snaps = [_scrub(s) for s in _script(*PACKAGES["jax"])]
    port_snaps = [_scrub(s) for s in _script(*PACKAGES["port"])]
    assert port_snaps == jax_snaps
    stall = [f for f in port_snaps[1]["families"]
             if f["name"] == "edl_tpu_checkpoint_stall_seconds"][0]
    assert sorted(v[1] for v in stall["series"][0]["exemplars"].values()) \
        == ["explicit", "span"]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("misuse,error", [
    (lambda r: r.counter("c").inc(-1), ValueError),
    (lambda r: r.counter("c").dec(), ValueError),
    (lambda r: r.counter("c").set(1), ValueError),
    (lambda r: r.gauge("g").observe(1), ValueError),
    (lambda r: (r.counter("m"), r.gauge("m")), ValueError),
    (lambda r: (r.counter("m", "", ["a"]), r.counter("m", "", ["b"])),
     ValueError),
    (lambda r: (r.histogram("h", buckets=(1,)), r.histogram("h")),
     ValueError),
    (lambda r: r.counter("l", "", ["a", "b"]).labels("x"), ValueError),
    (lambda r: r.counter("l2", "", ["a"]).labels("x", a="y"), ValueError),
])
def test_misuse_raises_as_in_jax(pkg, misuse, error):
    reg = PACKAGES[pkg][0].MetricsRegistry()
    with pytest.raises(error):
        misuse(reg)


def _spans(tracing_mod):
    rec = tracing_mod.install_recorder(tracing_mod.FlightRecorder(3))
    tracing_mod.set_process_role("worker", "2")
    try:
        with tracing_mod.span("task", task=1) as root:
            with tracing_mod.Tracer("worker", "2").span("step", n=1):
                ctx = tracing_mod.current_ctx()
            with tracing_mod.child_span("pull", root.ctx(), table="t"):
                pass
        with tracing_mod.server_span("rpc", ctx, "row_service", "0"):
            pass
        tracing_mod.record_span("queue_wait", 1.0, 0.25, role="serving")
        try:
            with tracing_mod.span("boom"):
                raise KeyError("x")
        except KeyError:
            pass
        with tracing_mod.span("dropped") as dropped:
            dropped.discard()
        cursor_spans, cursor = rec.since(0)
    finally:
        tracing_mod.uninstall_recorder()
        tracing_mod.set_process_role("process", "0")
    assert tracing_mod.span("off") is tracing_mod.NULL_SPAN
    return rec.snapshot(), cursor_spans, cursor


def test_spans_carry_the_jax_fields():
    want, want_since, want_cursor = _spans(jax_tracing)
    got, got_since, got_cursor = _spans(port_tracing)
    assert got_cursor == want_cursor == 6
    assert [s["seq"] for s in got_since] == [s["seq"] for s in want_since]
    assert len(got) == len(want) == 3        # the ring keeps the newest 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in ("name", "role", "instance", "attrs", "seq"):
            assert g[key] == w[key], key
        assert (g["parent_id"] is None) == (w["parent_id"] is None)
        assert len(g["span_id"]) == len(w["span_id"]) == 16
    assert [s["name"] for s in got] == ["rpc", "queue_wait", "boom"]
    assert got[2]["attrs"] == {"error": "KeyError"}
