"""The port's Local-strategy training path against the JAX package's:
records, the LocalExecutor's loss and eval metrics from the same initial
params, the ``--output`` bundle, and the ``train`` CLI.

Tolerances (f32): after 8 Adam steps the final loss and the eval
perplexity at rtol 1e-4 (per-step gradients agree to ~1e-6 relative,
test_torch_step.py, and Adam's 8 steps let that grow), token accuracy
within 2 of the eval tokens (an argmax between two near-equal logits may
flip).
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.api.local_executor import LocalExecutor as JaxExecutor
from elasticdl_tpu.core.model_spec import get_model_spec as jax_spec
from elasticdl_tpu.core.train_state import init_train_state as jax_init
from elasticdl_tpu.testing import data as jdata
from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.api.local_executor import LocalExecutor
from elasticdl_tpu_torch.callbacks import Callback
from elasticdl_tpu_torch.serving.export import load_predictor
from elasticdl_tpu_torch.testing import data as tdata

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, VOCAB, BATCH = 32, 256, 16
TWIN = "transformer.transformer_lm.custom_model"

# A tiny f32 config of each package's zoo module: the JAX one reuses the
# repo's model_zoo/transformer/transformer_lm.py for everything but the
# model.
JAX_ZOO = '''
import jax.numpy as jnp

from elasticdl_tpu.core.model_spec import load_module
from elasticdl_tpu.models.transformer import TransformerConfig, TransformerLM

_ref = load_module(REF_PATH)
loss, optimizer = _ref.loss, _ref.optimizer
dataset_fn, eval_metrics_fn = _ref.dataset_fn, _ref.eval_metrics_fn
CONFIG = TransformerConfig(vocab_size=256, d_model=64, n_heads=2,
                           n_layers=2, d_ff=128, max_len=32,
                           compute_dtype=jnp.float32)


def custom_model(mesh=None):
    return TransformerLM(CONFIG)
'''.replace("REF_PATH", repr(os.path.join(
    REPO, "model_zoo", "transformer", "transformer_lm.py")))

PORT_ZOO = '''
import torch

from elasticdl_tpu_torch.model_zoo.transformer import transformer_lm as twin
from elasticdl_tpu_torch.model_zoo.transformer.transformer_lm import (
    dataset_fn, eval_metrics_fn, loss, optimizer)
from elasticdl_tpu_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(vocab_size=256, d_model=64, n_heads=2,
                           n_layers=2, d_ff=128, max_len=32,
                           compute_dtype=torch.float32)


def custom_model(device=None):
    return twin.custom_model(config=CONFIG, device=device)
'''


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm")
    zoo = root / "zoo"
    for name, src in (("jax_tiny", JAX_ZOO), ("port_tiny", PORT_ZOO)):
        (zoo / name).mkdir(parents=True)
        (zoo / name / "lm.py").write_text(textwrap.dedent(src))
    train = tdata.create_lm_record_file(str(root / "train.rec"), 128,
                                        seed=1, seq_len=SEQ, vocab=VOCAB)
    evalf = tdata.create_lm_record_file(str(root / "eval.rec"), 32,
                                        seed=2, seq_len=SEQ, vocab=VOCAB)
    return root, str(zoo), train, evalf


@pytest.mark.parametrize("seed,n,seq_len", [(0, 5, 32), (3, 7, 128)])
def test_record_files_are_byte_equal(tmp_path, seed, n, seq_len):
    port = tdata.create_lm_record_file(str(tmp_path / "p.rec"), n, seed=seed,
                                       seq_len=seq_len)
    ref = jdata.create_lm_record_file(str(tmp_path / "j.rec"), n, seed=seed,
                                      seq_len=seq_len)
    with open(port, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_executor_matches_jax_executor(data):
    root, zoo, train, evalf = data
    jargs = jdata.make_local_args(zoo, "jax_tiny.lm.custom_model", train,
                                  str(root / "jax"), validation_data=evalf,
                                  minibatch_size=BATCH, num_epochs=1)
    want = JaxExecutor(jargs).run()
    # The JAX executor's initial params, carried into the port's model
    # before its first step.
    spec = jax_spec(zoo, "jax_tiny.lm.custom_model")
    batch = {"features": np.zeros((BATCH, SEQ), np.int32)}
    params = jax.tree.map(np.asarray, jax_init(
        spec.model, optax.adam(1e-3), batch, seed=0).params)
    args = tdata.make_local_args(zoo, "port_tiny.lm.custom_model", train,
                                 validation_data=evalf, minibatch_size=BATCH,
                                 extra=["--device", "cpu"])
    executor = LocalExecutor(args)
    executor._spec.model.load_state_dict(bridge.state_dict_from_flax(params))
    got = executor.run()
    assert got["steps"] == want["steps"] == 8
    assert got["examples"] == want["examples"] == 128
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-4)
    gm, wm = got["eval_metrics"], want["eval_metrics"]
    np.testing.assert_allclose(gm["perplexity"], wm["perplexity"], rtol=1e-4)
    assert abs(gm["token_accuracy"] - wm["token_accuracy"]) <= 2 / (32 * SEQ)


def test_output_bundle_serves_the_trained_logits(data, tmp_path):
    root, _, train, evalf = data
    out = str(tmp_path / "bundle")
    args = tdata.make_local_args(
        tdata.model_zoo_dir(), TWIN, train, minibatch_size=BATCH,
        num_epochs=2, extra=["--device", "cpu", "--output", out])
    executor = LocalExecutor(args)
    result = executor.run()
    # The +1-chain data is learnable: from ~ln(256) the loss falls.
    assert result["final_loss"] < 0.8 * np.log(VOCAB)
    tokens = np.arange(SEQ, dtype=np.int32)[None] * 3 % VOCAB
    model = executor.state.model.eval()
    with torch.inference_mode():
        want = model(torch.from_numpy(tokens)).numpy()
    got = load_predictor(out, device="cpu")(tokens)
    np.testing.assert_array_equal(got, want)


def test_batch_hooks_run_around_every_train_step(data):
    _, _, train, _ = data
    seen = []

    class Recorder(Callback):
        def on_train_batch_begin(self, owner=None):
            seen.append(("begin", owner.state.step))

        def on_train_batch_end(self, owner=None, metrics=None):
            seen.append(("end", owner.state.step, metrics["loss"].dim()))

    args = tdata.make_local_args(
        tdata.model_zoo_dir(), TWIN, train, minibatch_size=BATCH,
        extra=["--device", "cpu", "--max_steps", "3"])
    assert LocalExecutor(args, callbacks=[Recorder()]).run()["steps"] == 3
    assert seen == [("begin", 0), ("end", 1, 0), ("begin", 1), ("end", 2, 0),
                    ("begin", 2), ("end", 3, 0)]


def test_train_cli_on_the_cpu(data, tmp_path):
    _, _, train, _ = data
    out = str(tmp_path / "cli_bundle")
    proc = subprocess.run(
        [sys.executable, "-m", "elasticdl_tpu_torch", "train",
         "--model_zoo", tdata.model_zoo_dir(), "--model_def", TWIN,
         "--training_data", train, "--minibatch_size", "32",
         "--max_steps", "2", "--device", "cpu", "--output", out],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Job finished" in proc.stderr
    assert os.path.exists(os.path.join(out, "metadata.json"))


def test_train_cli_needs_cuda_unless_cpu_is_asked_for(data, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from elasticdl_tpu_torch.__main__ import main

    _, _, train, _ = data
    argv = ["train", "--model_zoo", tdata.model_zoo_dir(), "--model_def",
            TWIN, "--training_data", train, "--minibatch_size", "4"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
    # Another strategy submits a master pod; without the kubernetes
    # package its manifests are printed.
    assert main(argv + ["--distribution_strategy", "MeshStrategy"]) == 0
    out = capsys.readouterr().out
    assert "kind: Pod" in out and "elasticdl_tpu_torch.master.main" in out
