"""The port's row-plane drills (``elasticdl_tpu_torch/chaos/{tiered,quake,
usage,brownout}_drill.py``) and checkers (``tools/check_{usage,
overload}.py``) on the CPU.

- tiered: the port's drill and the JAX drill at one seed end in the
  same bytes (rows, Adam slots and step counters, at the twin and after
  each relaunch) and write the same report;
- quake: the shard quake scenario (a shard SIGKILLed mid-storm,
  relaunched, no acked push re-driven) lands byte-equal to its twin;
- usage: one attributed run over a live 2 -> 3 split bills migration
  and replica-refresh bytes to their own purposes only, and attributes
  the handler time;
- brownout: a controlled run, its windows shortened, sheds background
  purposes first (never a serving read) and caps retry amplification.

The wall-clock gates (the durable-ack p99 ratio, the usage overhead,
the brownout serving p99) are read on the card; no test here asserts a
ratio of times.
"""

import json
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _captures(monkeypatch, module):
    """Record every ``_capture`` the drill takes, in order."""
    seen = []
    real = module._capture

    def capture(svc):
        state = real(svc)
        seen.append({name: (np.asarray(ids).tobytes(),
                            np.asarray(rows, np.float32).tobytes())
                     for name, (ids, rows) in state.items()})
        return state

    monkeypatch.setattr(module, "_capture", capture)
    return seen


def test_tiered_drill_ends_byte_equal_to_jax(tmp_path, monkeypatch):
    from elasticdl_tpu.chaos import tiered_drill as jdrill
    from elasticdl_tpu_torch.chaos import tiered_drill as tdrill

    want_states = _captures(monkeypatch, jdrill)
    got_states = _captures(monkeypatch, tdrill)
    want = jdrill.run_drill(str(tmp_path / "jax"), 7)
    got = tdrill.run_drill(str(tmp_path / "port"), 7)
    assert want["passed"] and got["passed"], got
    assert got == want
    assert len(got_states) == len(want_states) >= 3
    for got_state, want_state in zip(got_states, want_states):
        assert got_state == want_state
    names = set(got_states[0])
    assert {"drill_rows", "drill_rows-m", "drill_rows-v",
            "__row_optimizer_steps__"} <= names


def test_tiered_drill_cli_writes_into_its_workdir(tmp_path, monkeypatch):
    from elasticdl_tpu_torch.chaos import tiered_drill

    monkeypatch.chdir(tmp_path)
    assert tiered_drill.main(["--workdir", "w"]) == 0
    assert os.path.exists(tmp_path / "w" / "TIERED_DRILL.json")
    assert sorted(os.listdir(tmp_path)) == ["w"]


def test_quake_shard_quake_converges_without_replay(tmp_path):
    from elasticdl_tpu_torch.chaos import quake_drill

    result = quake_drill.scenario_shard_quake(str(tmp_path))
    assert result["passed"], result["problems"]
    assert result["problems"] == []


def test_usage_attribution_is_pure_and_covers_the_handlers(tmp_path):
    from elasticdl_tpu_torch.chaos import usage_drill
    from elasticdl_tpu_torch.observability import principal
    from elasticdl_tpu_torch.observability.registry import default_registry
    from elasticdl_tpu_torch.observability.usage import summarize_usage

    hot, schedule = usage_drill._schedule(7)
    # The registry is process-wide: the share is read over this run's
    # handler time alone (the drill runs in a process of its own).
    before = _handler_seconds(default_registry().snapshot())
    principal.set_enabled(True)
    principal.set_process_principal(job="drill", component="worker",
                                    purpose="training")
    try:
        samples = usage_drill._run_once(str(tmp_path), "attributed", hot,
                                        schedule)
    finally:
        principal.set_process_principal()
    assert len(samples) == usage_drill.PUSHES - usage_drill.WARMUP
    snapshot = default_registry().snapshot()
    purity = usage_drill._purity_gate(snapshot)
    assert purity["ok"], purity["problems"]
    assert purity["purposes_by_method"]["ingest_rows"] == ["migration"]
    assert purity["purposes_by_method"]["replica_refresh"] == [
        "replica_refresh"]
    usage = summarize_usage({"proc": snapshot}, top_k=5)
    assert usage["totals"]["handler_seconds"] > 0
    after = _handler_seconds(snapshot)
    run = {p: secs - before.get(p, 0.0) for p, secs in after.items()}
    share = 1.0 - run.get("unknown", 0.0) / sum(run.values())
    assert share >= usage_drill.SHARE_GATE, run


def _handler_seconds(snapshot):
    """Handler seconds by purpose, as ``summarize_usage`` sums them."""
    out = {}
    for family in snapshot["families"]:
        if family["name"] != "edl_tpu_usage_handler_seconds":
            continue
        for series in family["series"]:
            labels = dict(zip(family["labelnames"], series["labels"]))
            purpose = labels["purpose"]
            out[purpose] = out.get(purpose, 0.0) + series["sum"]
    return out


@pytest.mark.parametrize("tool,name,field", [
    ("check_usage", "USAGE_DRILL.json", ("purity", "ok")),
    ("check_overload", "BROWNOUT_DRILL.json", ("passed",)),
])
def test_checkers_match_jax_on_the_committed_reports(tool, name, field,
                                                     tmp_path):
    import importlib

    port = importlib.import_module(f"elasticdl_tpu_torch.tools.{tool}")
    jax_tool = importlib.import_module(f"tools.{tool}")
    check = getattr(port, tool)
    committed = os.path.join(REPO, name)
    assert check(committed) == getattr(jax_tool, tool)(committed)
    assert check(committed)[0] == []
    bad = json.load(open(committed))
    node = bad
    for key in field[:-1]:
        node = node[key]
    node[field[-1]] = False
    path = tmp_path / name
    path.write_text(json.dumps(bad))
    errors = check(str(path))[0]
    assert errors and errors == getattr(jax_tool, tool)(str(path))[0]
    assert check(str(tmp_path))[0] == errors
    assert port.main([str(path)]) == 1


def test_brownout_controlled_run_sheds_background_first(tmp_path,
                                                       monkeypatch):
    from elasticdl_tpu_torch.chaos import brownout_drill as drill
    from elasticdl_tpu_torch.comm.overload import BACKGROUND_PURPOSES

    for name, secs in (("WARMUP_SECS", 0.5), ("BASELINE_SECS", 1.0),
                       ("BROWNOUT_SECS", 3.0), ("SETTLE_SECS", 1.5),
                       ("RECOVERY_SECS", 1.5)):
        monkeypatch.setattr(drill, name, secs)
    run = drill._run_mode(str(tmp_path), 7, controlled=True)
    assert run["problems"] == []
    sheds = run["sheds"]
    total = sum(sheds.values())
    background = sum(n for p, n in sheds.items()
                     if p in BACKGROUND_PURPOSES)
    assert total > 0
    assert sheds.get("serving_read", 0) == 0
    assert background / total >= drill.MIN_BACKGROUND_SHED_FRAC
    assert (run["brownout"]["_total"]["amplification"]
            <= drill.MAX_AMPLIFICATION)
