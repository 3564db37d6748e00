"""The port's gang-scheduler and streaming drills
(``elasticdl_tpu_torch/chaos/sched_drill.py``, ``stream_drill.py``) and
its copies of the ``check_sched``, ``check_stream`` and ``check_probe``
fsck tools, on the CPU.

Both drills run and hold their gates; the sched drill's schedule (tick
events, revoked leases, journal fold, byte-equal jobs) is the JAX
drill's. The port's tools pass the committed ``SCHED_DRILL.json``,
``STREAM_DRILL.json`` and ``PROBE_DRILL.json`` and the port drills'
reports, and flag the tampered copies that ``tests/test_stream.py`` and
``tests/test_probe.py`` flag, with the JAX tools' messages.
"""

import copy
import json
import os
import sys

import pytest

from elasticdl_tpu_torch.chaos import sched_drill, stream_drill
from elasticdl_tpu_torch.tools import check_probe, check_sched, check_stream

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO_ROOT, "tools"))

import check_probe as jax_check_probe  # noqa: E402
import check_sched as jax_check_sched  # noqa: E402
import check_stream as jax_check_stream  # noqa: E402

TOOLS = {
    "sched": (check_sched.check_sched, jax_check_sched.check_sched,
              "SCHED_DRILL.json"),
    "stream": (check_stream.check_stream, jax_check_stream.check_stream,
               "STREAM_DRILL.json"),
    "probe": (check_probe.check_probe, jax_check_probe.check_probe,
              "PROBE_DRILL.json"),
}


def committed(kind):
    with open(os.path.join(REPO_ROOT, TOOLS[kind][2])) as fh:
        return json.load(fh)


def both_tools(tmp_path, kind, report):
    """(port errors, JAX errors) for ``report`` written to a file."""
    path = tmp_path / TOOLS[kind][2]
    path.write_text(json.dumps(report))
    return TOOLS[kind][0](str(path))[0], TOOLS[kind][1](str(path))[0]


def test_sched_drill_holds_its_gates_as_the_jax_drill(tmp_path):
    from elasticdl_tpu.chaos import sched_drill as jax_drill

    report = sched_drill.run_drill(str(tmp_path / "port"))
    assert report["passed"], report["problems"]
    want = jax_drill.run_drill(str(tmp_path / "jax"))
    assert want["passed"]
    for key in ("config", "byte_equal", "accounting", "replay"):
        assert report[key] == want[key], key
    for key in ("events", "steps", "dropped_leases", "finished_seen"):
        assert report["scheduler"][key] == want["scheduler"][key], key
    assert report["scheduler"]["dropped_leases"] >= 1
    assert report["replay"] == {
        "jobs": {"batch-lo": "done", "prio-hi": "done"},
        "preemptions": 1}
    path = tmp_path / "SCHED_DRILL.json"
    path.write_text(json.dumps(report, default=str))
    assert check_sched.check_sched(str(path))[0] == []
    assert check_sched.main([str(tmp_path)]) == 0


def test_stream_drill_holds_its_gates(tmp_path):
    workdir = str(tmp_path / "drill")
    out = str(tmp_path / "STREAM_DRILL.json")
    assert stream_drill.main(["run", "--workdir", workdir,
                              "--report", out]) == 0
    with open(out) as fh:
        report = json.load(fh)
    assert report["passed"] and report["problems"] == []
    kill = report["kill"]
    assert kill["byte_equal"]
    assert kill["killed"]["push_counts"] == kill["twin"]["push_counts"]
    assert kill["killed"]["read_your_writes"]["missing"] == 0
    assert kill["killed"]["read_your_writes"]["checked"] >= (
        stream_drill.KILL_AT_COMMITTED)
    for partition, snap in kill["killed"]["committed_at_kill"].items():
        assert kill["killed"]["resumed_progress"][partition][
            "committed"] >= snap["committed"]
    coexist = report["coexist"]
    assert coexist["preemptions"] == 1 and coexist["resumes"] == 1
    assert coexist["watermark_monotone"]
    assert coexist["backpressure_seconds"] > 0
    port_errors, jax_errors = both_tools(tmp_path, "stream", report)
    assert port_errors == jax_errors == []


@pytest.mark.parametrize("kind", sorted(TOOLS))
def test_tools_pass_the_committed_reports(kind):
    path = os.path.join(REPO_ROOT, TOOLS[kind][2])
    errors, report = TOOLS[kind][0](path)
    assert errors == [] and report["passed"]
    assert TOOLS[kind][0](REPO_ROOT)[0] == []
    module = {"sched": check_sched, "stream": check_stream,
              "probe": check_probe}[kind]
    assert module.main([path]) == 0
    assert module.main([]) == 2


def _gap(r):
    part = r["kill"]["twin"]["final_progress"]
    part[sorted(part)[0]]["committed"] -= 1


def _reack(r):
    resumed = r["kill"]["killed"]["resumed_progress"]
    partition = sorted(resumed)[0]
    resumed[partition]["committed"] = 0
    r["kill"]["killed"]["committed_at_kill"][partition]["committed"] = 5


STREAM_TAMPERS = {
    "verdict": (lambda r: r.__setitem__("passed", False), "did not pass"),
    "offset_gap": (_gap, "committed"),
    "reacked_watermark": (_reack, "re-acked"),
    "dead_wal_unaudited": (
        lambda r: r["kill"]["killed"].pop("dead_wal_fsck", None),
        "never audited"),
}


@pytest.mark.parametrize("name", sorted(STREAM_TAMPERS))
def test_check_stream_flags_what_jax_flags(tmp_path, name):
    report = committed("stream")
    mutate, needle = STREAM_TAMPERS[name]
    mutate(report)
    port_errors, jax_errors = both_tools(tmp_path, "stream", report)
    assert port_errors == jax_errors
    assert any(needle in e for e in port_errors), port_errors


PROBE_TAMPERS = {
    "twin_false_positive": (
        lambda r: r["twin"].__setitem__("failures", 1), "false positive"),
    "window_undetected": (
        lambda r: r["faulted"]["windows"][0].__setitem__(
            "within_bound", False), "row_shard_kill"),
    "incident_trace_id": (
        lambda r: r["faulted"]["incidents"]["row_ryw"].__setitem__(
            "trace_id", ""), "trace id"),
    "keyspace": (
        lambda r: r["config"].__setitem__("canary_id_base", 0),
        "canary_id_base"),
}


@pytest.mark.parametrize("name", sorted(PROBE_TAMPERS))
def test_check_probe_flags_what_jax_flags(tmp_path, name):
    report = committed("probe")
    mutate, needle = PROBE_TAMPERS[name]
    mutate(report)
    port_errors, jax_errors = both_tools(tmp_path, "probe", report)
    assert port_errors == jax_errors
    assert any(needle in e for e in port_errors), port_errors


SCHED_TAMPERS = {
    "rows_diverged": (
        lambda r: r["byte_equal"]["batch-lo"].__setitem__("rows", False),
        "diverged"),
    "no_revoked_lease": (
        lambda r: r["scheduler"].__setitem__("dropped_leases", 0),
        "no in-flight lease revoked"),
    "two_preemptions": (
        lambda r: r["replay"].__setitem__("preemptions", 2),
        "want exactly 1"),
    "double_apply": (
        lambda r: r["accounting"]["prio-hi"].__setitem__(
            "dupes", {"3": 2}), "more than once"),
    "resume_first": (
        lambda r: r["scheduler"].__setitem__(
            "events", sorted(r["scheduler"]["events"],
                             key=lambda e: not e.startswith("resume"))),
        "resume precedes preempt"),
}


@pytest.mark.parametrize("name", sorted(SCHED_TAMPERS))
def test_check_sched_flags_what_jax_flags(tmp_path, name):
    report = copy.deepcopy(committed("sched"))
    mutate, needle = SCHED_TAMPERS[name]
    mutate(report)
    port_errors, jax_errors = both_tools(tmp_path, "sched", report)
    assert port_errors == jax_errors
    assert any(needle in e for e in port_errors), port_errors
