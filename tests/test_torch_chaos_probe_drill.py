"""The port's probe drill (``elasticdl_tpu_torch/chaos/probe_drill.py``)
on the CPU: real row-shard and serving-replica processes, an in-process
stream master and the prober. Each fault window reds exactly its
matching probe within the drill's tick bound and re-greens after the
repair, the kill-free twin stays green, every red transition leaves one
incident bundle carrying the failing run's trace id, and the canary
traffic meters under the ``canary`` purpose alone. The report passes
the port's ``check_probe`` and the JAX one.
"""

import json

from elasticdl_tpu_torch.chaos import probe_drill


def test_probe_drill_reds_each_matching_probe_and_twin_stays_green(
        tmp_path):
    from elasticdl_tpu_torch.tools.check_probe import check_probe
    from tools.check_probe import check_probe as jax_check_probe

    out = tmp_path / "report.json"
    assert probe_drill.main(["--workdir", str(tmp_path / "w"),
                             "--report", str(out), "--device", "cpu"]) == 0
    report = json.loads(out.read_text())
    assert report["passed"] and report["problems"] == []
    windows = {w["window"]: w for w in report["faulted"]["windows"]}
    assert set(windows) == {w for w, _ in probe_drill.WINDOWS}
    for window, probe in probe_drill.WINDOWS:
        entry = windows[window]
        assert entry["probe"] == probe
        assert entry["within_bound"]
        assert entry["detect_ticks"] <= probe_drill.DETECT_BOUND_TICKS
        assert entry["recover_ticks"] is not None
    assert report["twin"]["failures"] == 0
    assert report["twin"]["ticks"] >= probe_drill.TWIN_TICKS
    assert report["usage"]["violations"] == []
    assert report["usage"]["canary_requests"] > 0
    assert check_probe(str(out))[0] == []
    assert jax_check_probe(str(out))[0] == []
