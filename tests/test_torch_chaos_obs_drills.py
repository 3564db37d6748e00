"""The port's observability and serving drills (``elasticdl_tpu_torch/
chaos/{slo,profile,serving,autoscale}_drill.py``) on the CPU.

- slo: the faulted half (a server-side ``rpc_delay`` on every
  ``pull_rows``) fires the burn-rate rule and leaves a bundle the
  port's ``check_incident`` accepts; the healthy twin fires nothing;
- profile: the injected hot function holds at least the drill's share
  of the row service's handler samples, and the alert's bundle passes
  ``check_incident --require-profile --require-exemplars``;
- serving: a replica hard-killed mid-load, every non-shed request
  answered, the router marks the dead replica;
- autoscale: the port's drill on a CPU mesh of 4 and 2 entries on one
  device against the JAX drill on 4 and 2 CPU devices, both from the
  JAX run's initial weights (f32 mnist twins): the same resizes, kill,
  final version and accounting, and each parameter within
  ``AUTOSCALE_TOL`` relative L2 of JAX's. 12 SGD-momentum steps at lr
  0.1 through two reshards and a restore: the mnist executor parity
  holds 4 steps at 1e-4 relative, and the per-step differences of float
  order compound here to 3e-4..2.1e-3 (the worst a conv bias, whose
  gradient is near 0 through the BatchNorm); every parameter moves by
  4x to 27x its initial norm over the run, ~0.3x or more a step, so a
  lost or repeated step sits two orders of magnitude above 1e-2.

No test here asserts a ratio of times: the profiler's overhead pin and
the hot function's heaviest-leaf rank (which an idle handler thread can
take on a loaded host) are read on the card.
"""

import os
import textwrap

import jax
import numpy as np
import pytest

AUTOSCALE_TOL = 1e-2


def test_slo_drill_fires_on_the_stall_and_not_on_the_twin(tmp_path):
    from elasticdl_tpu_torch.chaos import slo_drill
    from elasticdl_tpu_torch.tools.check_incident import check_incident

    faulted = slo_drill.run_half(str(tmp_path), faulted=True, records=64,
                                 device="cpu")
    assert faulted["finished"]
    assert faulted["fired_count"] >= 1
    assert faulted["injected"] > 0
    assert faulted["bundles"]
    assert check_incident(faulted["bundles"][0]) == []
    healthy = slo_drill.run_half(str(tmp_path), faulted=False, records=64,
                                 device="cpu")
    assert healthy["finished"]
    assert healthy["fired_count"] == 0
    assert healthy["injected"] == 0


def test_profile_drill_hot_function_dominates_by_share(tmp_path):
    from elasticdl_tpu_torch.chaos import profile_drill

    verdict = profile_drill.run_two_process(str(tmp_path),
                                            timeout_secs=120.0)
    assert verdict["fired"]
    assert verdict["bundle_errors"] == []
    assert verdict["exemplar_resolved"]
    assert verdict["hot_in_bundle_profile"]
    dominance = verdict["dominance"]
    assert dominance["share"] >= profile_drill.DOMINANCE_GATE
    assert dominance["hot_samples"] > 0


def test_serving_drill_rides_out_a_replica_kill():
    from elasticdl_tpu_torch.chaos import serving_drill

    report = serving_drill.run_drill(seed=7, requests_per_client=30,
                                     clients=3, kill_after=20,
                                     device="cpu")
    names = {inv["name"]: inv["passed"] for inv in report["invariants"]}
    assert names["availability_across_replica_kill"]
    assert names["router_detected_dead_replica"]
    assert report["replica_unhealthy_transitions"] >= 1
    assert report["availability"] >= 0.98
    assert report["passed"], report["invariants"]


JAX_F32_MNIST = '''
import jax.numpy as jnp

from elasticdl_tpu.core.model_spec import load_module

_ref = load_module(REF)
loss, optimizer = _ref.loss, _ref.optimizer
dataset_fn, eval_metrics_fn = _ref.dataset_fn, _ref.eval_metrics_fn


def custom_model():
    return _ref.MnistModel(compute_dtype=jnp.float32)
'''

PORT_F32_MNIST = '''
import torch

from elasticdl_tpu_torch.model_zoo.mnist import mnist_functional as twin
from elasticdl_tpu_torch.model_zoo.mnist.mnist_functional import (
    dataset_fn, eval_metrics_fn, loss, optimizer)


def custom_model(device=None):
    return twin.MnistModel(compute_dtype=torch.float32).to(device)
'''


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-12))


def test_autoscale_drill_matches_the_jax_drill(tmp_path, monkeypatch):
    from elasticdl_tpu.chaos import autoscale_drill as jdrill
    from elasticdl_tpu.core.model_spec import get_model_spec
    from elasticdl_tpu.core.train_state import init_train_state
    from elasticdl_tpu.testing import data as jdata
    from elasticdl_tpu_torch import bridge
    from elasticdl_tpu_torch.chaos import autoscale_drill as tdrill
    from elasticdl_tpu_torch.testing import cluster as tcluster
    from elasticdl_tpu_torch.testing import data as tdata

    if len(jax.devices()) < 4:
        pytest.skip("the JAX drill needs 4 CPU devices")
    zoo = tmp_path / "zoo"
    ref = os.path.join(jdata.model_zoo_dir(), "mnist", "mnist_functional.py")
    for pkg, src in (("jax_f32", JAX_F32_MNIST),
                     ("port_f32", PORT_F32_MNIST)):
        (zoo / pkg).mkdir(parents=True)
        (zoo / pkg / "mnist.py").write_text(
            textwrap.dedent(src.replace("REF", repr(ref))))
    monkeypatch.setattr(jdata, "model_zoo_dir", lambda: str(zoo))
    monkeypatch.setattr(tdata, "model_zoo_dir", lambda: str(zoo))
    monkeypatch.setattr(jdrill, "MODEL_DEF", "jax_f32.mnist.custom_model")
    monkeypatch.setattr(tdrill, "MODEL_DEF", "port_f32.mnist.custom_model")

    spec = get_model_spec(str(zoo), jdrill.MODEL_DEF)
    batch = {"features": np.zeros((8, 28, 28), np.float32),
             "labels": np.zeros((8,), np.int32),
             "mask": np.ones((8,), np.float32)}
    start = init_train_state(spec.model, spec.make_optimizer(), batch,
                             seed=0)
    start = jax.tree.map(np.asarray, {"params": start.params,
                                      "batch_stats": start.batch_stats})

    class FromJaxStart(tcluster.MiniCluster):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.spec.model.load_state_dict(bridge.flax_state_dict(start))

    monkeypatch.setattr(tcluster, "MiniCluster", FromJaxStart)
    finals = {}
    for name, mod in (("jax", jdrill), ("port", tdrill)):
        real = mod._final_summary

        def summary(worker, _real=real, _name=name):
            out = _real(worker)
            finals[_name] = out
            return out

        monkeypatch.setattr(mod, "_final_summary", summary)
    want = jdrill.run_drill(str(tmp_path / "jax"), records=96)
    jax_final = finals["jax"]
    got = tdrill.run_drill(str(tmp_path / "port"), records=96,
                           device="cpu")
    assert want["passed"] and got["passed"], got["invariants"]
    for key in ("resizes", "kills", "config"):
        if key == "config":
            want["config"].pop("model_def")
            got["config"].pop("model_def")
        assert got[key] == want[key], key
    assert got["job"]["final_version"] == want["job"]["final_version"]
    assert got["job"]["final_mesh"] == want["job"]["final_mesh"] == {
        "dp": 4}
    assert got["invariants"][0] == want["invariants"][0]
    np.testing.assert_allclose(got["job"]["final_loss"],
                               want["job"]["final_loss"],
                               rtol=AUTOSCALE_TOL, atol=AUTOSCALE_TOL)
    want_sd = bridge.flax_state_dict(_unflatten(
        {name: arr for name, arr in jax_final["leaves"].items()
         if name.startswith("params")}, "params"))
    port_leaves = finals["port"]["leaves"]
    assert want_sd
    start_sd = bridge.flax_state_dict(start)
    worst = max(_rel(port_leaves[f"params.{key}"], value.numpy())
                for key, value in want_sd.items())
    moved = min(_rel(value.numpy(), start_sd[key].numpy())
                for key, value in want_sd.items())
    assert moved > 100 * AUTOSCALE_TOL
    assert worst <= AUTOSCALE_TOL


def _unflatten(leaves, root):
    """JAX's named leaves (``params['Conv_0']['kernel']``) back into the
    nested dict ``bridge.flax_state_dict`` reads."""
    import re

    out = {}
    for name, arr in leaves.items():
        keys = re.findall(r"\['([^']+)'\]", name[len(root):])
        node = out
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = np.asarray(arr)
    return out
