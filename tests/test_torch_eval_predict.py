"""The port's ``evaluate`` and ``predict`` jobs
(``api/eval_predict_executor.py``) against the JAX package's.

Both packages train the same f32 twin (mnist_functional; census_wide_deep
under its LearningRateScheduler) for 4 Local steps at B 16, the port
from the JAX executor's initial variables carried through
``bridge.flax_state_dict`` before its first step, each package with its
own ``--checkpoint_dir``. Then each package's ``EvalPredictExecutor``
runs ``evaluate`` and ``predict`` from its own directory on the same
records, the predictions going to the zoo module's
``PredictionOutputsProcessor``.

Tolerances, the twins' existing trajectory tolerances (f32): 4 steps
carry a per-step gradient difference of ~1e-6 relative through the
optimizer (tests/test_torch_vision_zoo.py holds the mnist losses at
1e-4 relative, tests/test_torch_tabular_zoo.py census's parameter
changes at 1e-4 L2), so the predictions agree within 1e-4 relative L2
and each metric within 1e-4 relative, except accuracy, an argmax count
that one near-tied row may flip: within one row of the eval set.

Also: ``python -m elasticdl_tpu_torch evaluate|predict --device cpu``
end to end in a subprocess, and the restore's own contract: predictions
bit-equal to the trained state's eval forward, metrics equal to the
training executor's final eval.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.api.eval_predict_executor import (
    EvalPredictExecutor as JaxEvalPredict,
)
from elasticdl_tpu.api.local_executor import LocalExecutor as JaxExecutor
from elasticdl_tpu.common.args import build_parser as jax_parser
from elasticdl_tpu.testing import data as jdata
from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.api.eval_predict_executor import EvalPredictExecutor
from elasticdl_tpu_torch.api.local_executor import LocalExecutor
from elasticdl_tpu_torch.callbacks import Callback
from elasticdl_tpu_torch.common.args import build_parser
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.testing import data as tdata

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 16
PRED_TOL, METRIC_TOL = 1e-4, 1e-4

PROCESSOR = '''

class PredictionOutputsProcessor:
    """Keeps every batch of predictions it is handed."""

    def __init__(self):
        self.batches = []

    def process(self, predictions, worker_id):
        self.batches.append(np_.asarray(predictions))
'''
JAX_ZOO = '''
import jax.numpy as jnp
import numpy as np_

from elasticdl_tpu.core.model_spec import load_module

_ref = load_module(REF)
loss, optimizer = _ref.loss, _ref.optimizer
dataset_fn, eval_metrics_fn = _ref.dataset_fn, _ref.eval_metrics_fn
callbacks = getattr(_ref, "callbacks", None)


def custom_model():
    return _ref.MODEL(compute_dtype=jnp.float32)
''' + PROCESSOR
PORT_ZOO = '''
import numpy as np_
import torch

from elasticdl_tpu_torch.model_zoo.FAMILY import NAME as twin
from elasticdl_tpu_torch.model_zoo.FAMILY.NAME import (  # noqa
    dataset_fn, eval_metrics_fn, loss, optimizer)

callbacks = getattr(twin, "callbacks", None)


def custom_model(device=None):
    return twin.MODEL(compute_dtype=torch.float32).to(device)
''' + PROCESSOR
# name -> (family, model class, records(path, n, seed))
TWINS = {
    "mnist_functional": ("mnist", "MnistModel",
                         tdata.create_mnist_record_file),
    "census_wide_deep": ("census", "WideAndDeep",
                         tdata.create_census_record_file),
}


def _zoo(tmp_path, name):
    family, model, _ = TWINS[name]
    zoo = tmp_path / "zoo"
    ref = repr(os.path.join(REPO, "model_zoo", family, f"{name}.py"))
    for pkg, src in (("jax_f32", JAX_ZOO), ("port_f32", PORT_ZOO)):
        (zoo / pkg).mkdir(parents=True)
        (zoo / pkg / "m.py").write_text(textwrap.dedent(
            src.replace("REF", ref).replace("FAMILY", family)
            .replace("NAME", name).replace("MODEL", model)))
    return str(zoo)


def _jax_train(zoo, train, valid, ckpt):
    """The JAX executor's run, its initial variables kept."""
    args = jdata.make_local_args(
        zoo, "jax_f32.m.custom_model", train, os.path.dirname(ckpt),
        validation_data=valid, minibatch_size=BATCH,
        extra=["--checkpoint_dir", ckpt, "--checkpoint_steps", "2"])
    executor = JaxExecutor(args)
    start = {}
    init = executor._maybe_init_state

    def keep_initial(batch):
        if executor.state is None:
            init(batch)
            start["variables"] = jax.tree.map(np.asarray, {
                "params": executor.state.params,
                "batch_stats": executor.state.batch_stats})

    executor._maybe_init_state = keep_initial
    result = executor.run()
    return result, start["variables"]


class Carry(Callback):
    """The JAX executor's initial variables, into the port's model before
    its first step."""

    def __init__(self, variables):
        self.variables = variables

    def on_train_batch_begin(self, owner=None):
        if owner.state.step == 0:
            owner.state.model.load_state_dict(
                bridge.flax_state_dict(self.variables))


def _port_train(zoo, train, valid, ckpt, variables):
    args = tdata.make_local_args(
        zoo, "port_f32.m.custom_model", train, validation_data=valid,
        minibatch_size=BATCH,
        extra=["--device", "cpu", "--checkpoint_dir", ckpt,
               "--checkpoint_steps", "2"])
    executor = LocalExecutor(args, callbacks=[Carry(variables)])
    return executor, executor.run()


def _job_args(parser, zoo, model_def, mode, data, ckpt, extra=()):
    flag = "--validation_data" if mode == "evaluate" else "--prediction_data"
    return parser(mode).parse_args([
        "--model_zoo", zoo, "--model_def", model_def, flag, data,
        "--checkpoint_dir_for_init", ckpt, "--minibatch_size", str(BATCH),
        *extra])


def _jobs(executor_cls, parser, zoo, model_def, valid, ckpt, extra=()):
    metrics = executor_cls(_job_args(parser, zoo, model_def, "evaluate",
                                     valid, ckpt, extra), "evaluate").run()
    job = executor_cls(_job_args(parser, zoo, model_def, "predict", valid,
                                 ckpt, extra), "predict")
    summary = job.run()
    preds = np.concatenate(job._spec.prediction_outputs_processor.batches)
    return metrics, summary, preds, job


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("name", sorted(TWINS))
def test_eval_and_predict_jobs_match_jax(name, tmp_path):
    make = TWINS[name][2]
    train = make(str(tmp_path / "train.rec"), 4 * BATCH, seed=1)
    valid = make(str(tmp_path / "valid.rec"), 40, seed=2)   # a ragged batch
    zoo = _zoo(tmp_path, name)
    jckpt, pckpt = str(tmp_path / "jax" / "ckpt"), str(tmp_path / "port_ck")
    jresult, variables = _jax_train(zoo, train, valid, jckpt)
    trained, presult = _port_train(zoo, train, valid, pckpt, variables)
    assert jresult["steps"] == presult["steps"] == 4

    jmetrics, jsummary, jpreds, _ = _jobs(
        JaxEvalPredict, jax_parser, zoo, "jax_f32.m.custom_model", valid,
        jckpt)
    pmetrics, psummary, ppreds, job = _jobs(
        EvalPredictExecutor, build_parser, zoo, "port_f32.m.custom_model",
        valid, pckpt, ["--device", "cpu"])
    assert job.state.step == 4
    assert psummary == jsummary == {"batches": 3}
    assert ppreds.shape == jpreds.shape and ppreds.shape[0] == 40
    assert rel(ppreds, jpreds) <= PRED_TOL
    assert sorted(pmetrics) == sorted(jmetrics)
    for key, want in jmetrics.items():
        if key == "accuracy":
            assert abs(pmetrics[key] - want) <= 1 / 40 + 1e-12
        else:
            assert rel(pmetrics[key], want) <= METRIC_TOL, key
    # the port's jobs against its own trained state: the same numbers
    assert pmetrics == presult["eval_metrics"]
    model = trained.state.model.eval()
    with torch.no_grad():
        want = []
        for batch in trained._task_batches(trained._eval_reader,
                                           Mode.EVALUATION):
            real = int(batch["mask"].sum())
            out = model(tree(batch["features"]))
            want.append(out.float().numpy()[:real])
    np.testing.assert_array_equal(ppreds, np.concatenate(want))


def tree(features):
    if isinstance(features, dict):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in
                features.items()}
    return torch.from_numpy(np.asarray(features))


def test_evaluate_and_predict_cli_run_end_to_end(tmp_path):
    train = tdata.create_mnist_record_file(str(tmp_path / "t.rec"), 32,
                                           seed=1)
    valid = tdata.create_mnist_record_file(str(tmp_path / "v.rec"), 24,
                                           seed=2)
    zoo = _zoo(tmp_path, "mnist_functional")
    ckpt = str(tmp_path / "ckpt")
    common = ["--model_zoo", zoo, "--model_def", "port_f32.m.custom_model",
              "--minibatch_size", str(BATCH), "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO)
    runs = {}
    for role, extra in (
            ("train", ["--training_data", train, "--validation_data", valid,
                       "--checkpoint_dir", ckpt]),
            ("evaluate", ["--validation_data", valid,
                          "--checkpoint_dir_for_init", ckpt]),
            ("predict", ["--prediction_data", valid,
                         "--checkpoint_dir_for_init", ckpt])):
        proc = subprocess.run(
            [sys.executable, "-m", "elasticdl_tpu_torch", role, *common,
             *extra], cwd=str(tmp_path), env=env, capture_output=True,
            text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        runs[role] = proc.stderr
    assert "Job finished" in runs["train"]
    assert "Restored state at version 2" in runs["evaluate"]
    line = [x for x in runs["evaluate"].splitlines()
            if "evaluate finished: " in x][0]
    metrics = json.loads(line.split("evaluate finished: ", 1)[1])
    assert 0.0 <= metrics["accuracy"] <= 1.0
    assert 'predict finished: {"batches": 2}' in runs["predict"]


HOST_ZOO = '''
import numpy as np_

from elasticdl_tpu_torch.embedding.host_engine import HostStepRunner
from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin
from elasticdl_tpu_torch.model_zoo.deepfm.deepfm_host import (  # noqa
    custom_model, dataset_fn, eval_metrics_fn, loss, optimizer)


def make_host_runner():
    return HostStepRunner(twin.make_host_runner().engine, async_apply=False)
''' + PROCESSOR


def test_host_tier_jobs_restore_the_host_tables(tmp_path):
    """deepfm_host (host tables behind the row store): the jobs refill the
    runner's tables from the checkpoint, so evaluate's metrics equal the
    training executor's final eval and predict's outputs its eval
    forward, bit for bit; the JAX executor supports the host runner the
    same way."""
    zoo = tmp_path / "zoo" / "host"
    zoo.mkdir(parents=True)
    (zoo / "m.py").write_text(textwrap.dedent(HOST_ZOO))
    train = tdata.create_frappe_record_file(
        str(tmp_path / "t.rec"), 4 * BATCH, seed=1, input_length=10,
        max_id=5500)
    valid = tdata.create_frappe_record_file(
        str(tmp_path / "v.rec"), 40, seed=2, input_length=10, max_id=5500)
    ckpt = str(tmp_path / "ckpt")
    args = tdata.make_local_args(
        str(tmp_path / "zoo"), "host.m.custom_model", train,
        validation_data=valid, minibatch_size=BATCH,
        extra=["--device", "cpu", "--checkpoint_dir", ckpt])
    trained = LocalExecutor(args)
    result = trained.run()
    metrics, summary, preds, job = _jobs(
        EvalPredictExecutor, build_parser, str(tmp_path / "zoo"),
        "host.m.custom_model", valid, ckpt, ["--device", "cpu"])
    assert job.state.step == 4 and summary == {"batches": 3}
    assert metrics == result["eval_metrics"]
    step = trained._eval_step
    want = [step(trained.state, b).float().numpy()[:int(b["mask"].sum())]
            for b in trained._task_batches(trained._eval_reader,
                                           Mode.EVALUATION)]
    np.testing.assert_array_equal(preds, np.concatenate(want))


def test_jobs_need_a_checkpoint_and_data(tmp_path):
    zoo = _zoo(tmp_path, "mnist_functional")
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    valid = tdata.create_mnist_record_file(str(tmp_path / "v.rec"), 8,
                                           seed=2)
    args = _job_args(build_parser, zoo, "port_f32.m.custom_model",
                     "evaluate", valid, empty, ["--device", "cpu"])
    with pytest.raises(FileNotFoundError):
        EvalPredictExecutor(args, "evaluate").run()
    with pytest.raises(ValueError, match="evaluate|predict"):
        EvalPredictExecutor(args, "train")
    with pytest.raises(SystemExit):
        build_parser("predict").parse_args(
            ["--model_zoo", zoo, "--model_def", "x.y", "--minibatch_size",
             "4", "--checkpoint_dir_for_init", empty])
    with pytest.raises(ValueError, match="not ported yet"):
        build_parser("clean")
