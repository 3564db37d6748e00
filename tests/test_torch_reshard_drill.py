"""The port's live-reshard chaos drill (``elasticdl_tpu_torch/chaos/
reshard_drill.py``) on the CPU: the source shard killed mid-migration
and the authority killed mid-cutover converge byte-equal to the
fault-free twin, with every id on one home, every replica equal to its
home and the state file clean; the port's twin is byte-equal to the JAX
drill's twin on the same seed; and the drill fails a fleet that keeps
moved rows on their old home.
"""

import json

import numpy as np

from elasticdl_tpu.chaos import reshard_drill as jdrill
from elasticdl_tpu_torch.chaos import reshard_drill as pdrill
from elasticdl_tpu_torch.embedding.row_service import HostRowService


def test_reshard_drill_passes(tmp_path):
    report = pdrill.run_drill(str(tmp_path), seed=7)
    assert report["passed"], report["problems"]
    assert [s["scenario"] for s in report["scenarios"]] == [
        "kill_source_mid_migration", "kill_authority_mid_cutover"]
    assert all(s["fsck_at_kill"] == [] for s in report["scenarios"])
    assert report["final_map_version"] == 6
    assert report["twin_problems"] == []


def test_drill_twin_is_byte_equal_to_the_jax_twin(tmp_path):
    """The same seeded schedule and splits through the port's fleet and
    the JAX drill's fleet: every view (rows, Adam slots) byte-equal, the
    same final map."""
    hot, schedule = pdrill._schedule(11)
    jhot, jschedule = jdrill._schedule(11)
    np.testing.assert_array_equal(hot, jhot)
    port_state, port_map, port_problems = pdrill._run_twin(
        str(tmp_path / "port"), 11, hot, schedule)
    jax_state, jax_map, jax_problems = jdrill._run_twin(
        str(tmp_path / "jax"), 11, jhot, jschedule)
    assert port_problems == jax_problems == []
    assert sorted(port_state) == sorted(jax_state)
    for name in port_state:
        (pi, pr), (ji, jr) = port_state[name], jax_state[name]
        assert pi.tobytes() == ji.tobytes(), name
        assert np.asarray(pr).tobytes() == np.asarray(jr).tobytes(), name
    assert port_map["ranges"] == jax_map["ranges"]
    assert port_map["version"] == jax_map["version"]
    assert port_map["replicas"] == jax_map["replicas"]


def test_drill_catches_rows_left_on_their_old_home(tmp_path, monkeypatch):
    """A fleet whose shards keep the rows they gave away fails the
    drill's one-home check (and so its twin comparison)."""
    monkeypatch.setattr(HostRowService, "_erase_unowned_locked",
                        lambda self: 0)
    report = pdrill.run_drill(str(tmp_path), seed=7)
    assert not report["passed"]
    assert any("homed on shards" in p for p in report["problems"])


def test_drill_main_writes_its_report(tmp_path):
    out = tmp_path / "report.json"
    rc = pdrill.main(["--workdir", str(tmp_path / "w"), "--seed", "3",
                      "--report", str(out)])
    report = json.loads(out.read_text())
    assert rc == 0 and report["passed"], report["problems"]
    assert report["config"]["split_at"] == list(pdrill.SPLIT_AT)
