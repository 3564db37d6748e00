"""The pipeline with ``pp`` across two processes of the port over
``torch.distributed`` on the CPU, against the port's one-process run on
the same global mesh, weights and batches.

Two subprocesses import only the port (and torch, numpy), wired by a
``FileStore`` under ``tmp_path`` (gloo), each under a time limit that
kills both. The mesh is (pp 2, dp 2) over ``("pp", "dp")``, as JAX's
``make_mesh`` lays it over two processes: process p holds stage p (both
its dp entries), both read the whole batch. Process 0 runs the
embedding into stage 0 and sends its activations on; process 1 runs
stage 1, and its outputs are broadcast, so both compute the head and
the loss. The backward is the reverse pipeline.

Tolerances: the losses 1e-5 relative; the ends (replicated) equal in
both processes; each stage's blocks and the ends within a hundredth of
one Adam step (lr / 100) of the one-process run's (the microbatches'
gradients are summed in another order), the attention key biases
(true gradient 0, Adam steps them by noise) within their steps' reach.
A mesh with ``dp`` across the processes is refused.
Also ``pipeline_apply`` alone, forward and gradients, against one
process.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
CPU = torch.device("cpu")
STEPS = 3
LR = 1e-2
CFG = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=4, d_ff=64,
           max_len=32)

_SCRIPT = """
    import json, os, sys
    import torch
    torch.set_num_threads(2)
    sys.path.insert(0, {repo!r})
    from elasticdl_tpu_torch.parallel import multihost
    pid, store, data, case = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                              sys.argv[4])
    sys.path.insert(0, os.path.dirname({test!r}))
    import test_torch_pipeline_procs as case_mod

    multihost.initialize_multihost(store, 2, pid, device="cpu")
    out = case_mod.RUNS[case](data, pid)
    out["pid"] = pid
    print("RESULT " + json.dumps(out), flush=True)
"""


def _batches():
    rng = np.random.RandomState(7)
    out = []
    for _ in range(STEPS):
        seq = (rng.randint(0, 32, (16, 1)) + np.arange(17)[None, :]) % 32
        out.append({"features": seq[:, :-1].astype(np.int32),
                    "labels": seq[:, 1:].astype(np.int32),
                    "mask": np.ones((16,), np.float32)})
    return out


def _mesh(pid):
    from elasticdl_tpu_torch.parallel.mesh import make_mesh

    return make_mesh((2, 2), ("pp", "dp"),
                     [CPU] * (4 if pid is None else 2))


def run_lm(data, pid=None):
    """PipelineLM trained STEPS Adam steps; writes the whole final
    parameters (the stages gathered) and the first step's gradients."""
    from elasticdl_tpu_torch.models.pipeline_lm import PipelineLM
    from elasticdl_tpu_torch.models.transformer import TransformerConfig
    from elasticdl_tpu_torch.ops.losses import (
        masked_next_token_cross_entropy,
    )

    mesh = _mesh(pid)
    model = PipelineLM(TransformerConfig(compute_dtype=torch.float32, **CFG),
                       mesh, num_microbatches=4, layers_per_stage=2)
    model.load_state_dict(torch.load(os.path.join(data, "init.pt")))
    step = model.make_train_step(masked_next_token_cross_entropy,
                                 lambda p: torch.optim.Adam(p, lr=LR))
    shardings = model.param_shardings()
    rows = {n: p.shape[0] for n, p in model.named_parameters()}
    losses, grads = [], None
    for batch in _batches():
        losses.append(float(step(batch)))
        if grads is None:
            grads = _whole(model, shardings, lambda p: p.grad)
    tag = "one" if pid is None else f"p{pid}"
    torch.save({"params": _whole(model, shardings, lambda p: p),
                "grads": grads}, os.path.join(data, f"lm_{tag}.pt"))
    refused = None
    if pid is not None:
        # dp across the processes (pp within each): refused, its step
        # sums no gradient over processes.
        from elasticdl_tpu_torch.parallel.mesh import make_mesh

        try:
            PipelineLM(TransformerConfig(compute_dtype=torch.float32,
                                         **CFG),
                       make_mesh((2, 2), ("dp", "pp"), [CPU] * 2),
                       layers_per_stage=2)
        except NotImplementedError as exc:
            refused = str(exc)
    return {"losses": losses, "rows": rows, "spans": mesh.spans_processes,
            "dp_across_refused": refused}


def _whole(model, shardings, of):
    out = {}
    for name, p in model.named_parameters():
        value = of(p).detach()
        sharding = shardings[name]
        out[name] = (sharding.gather_block(value)
                     if sharding.spans_processes else value).clone()
    return out


def _stage_fn(params, x):
    return x + torch.tanh(x @ params["w1"] + params["b1"]) @ params["w2"]


def run_apply(data, pid=None):
    """``pipeline_apply`` over 2 stages: the outputs and the gradients
    of sum(y²) by the stacked leaves (this process's block)."""
    from elasticdl_tpu_torch.parallel.pipeline import pipeline_apply

    mesh = _mesh(pid)
    init = torch.load(os.path.join(data, "apply.pt"))
    lo = 0 if pid is None else pid
    hi = 2 if pid is None else pid + 1
    stacked = {k: v[lo:hi].clone().requires_grad_()
               for k, v in init["stacked"].items()}
    x = init["x"].clone().requires_grad_()
    y = pipeline_apply(_stage_fn, stacked, x, mesh, axis="pp")
    (y ** 2).sum().backward()
    tag = "one" if pid is None else f"p{pid}"
    torch.save({"y": y.detach(), "x_grad": x.grad,
                "grads": {k: v.grad for k, v in stacked.items()}},
               os.path.join(data, f"apply_{tag}.pt"))
    return {}


RUNS = {"lm": run_lm, "apply": run_apply}


def _run_pair(tmp_path, case):
    script = tmp_path / "proc.py"
    script.write_text(textwrap.dedent(_SCRIPT.format(
        repo=REPO, test=os.path.abspath(__file__))))
    store = f"file://{tmp_path / 'store'}"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), store, str(tmp_path), case],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path)) for pid in (0, 1)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        for q in procs:
            q.communicate()
        pytest.fail("two-process pipeline hung (a send/recv or collective)")
    found = {}
    for pid, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"process {pid}:\n{out}"
        for line in out.splitlines():
            if line.startswith("RESULT "):
                res = json.loads(line[len("RESULT "):])
                found[res["pid"]] = res
    assert sorted(found) == [0, 1], outputs
    return found


def test_pipeline_apply_across_processes(tmp_path):
    gen = torch.Generator().manual_seed(3)
    torch.save({
        "stacked": {"w1": torch.randn(2, 16, 32, generator=gen) * 0.1,
                    "b1": torch.zeros(2, 32),
                    "w2": torch.randn(2, 32, 16, generator=gen) * 0.1},
        "x": torch.randn(8, 4, 16, generator=gen)}, tmp_path / "apply.pt")
    _run_pair(tmp_path, "apply")
    run_apply(str(tmp_path))
    one = torch.load(tmp_path / "apply_one.pt")
    for pid in (0, 1):
        got = torch.load(tmp_path / f"apply_p{pid}.pt")
        # Every process holds the outputs and the input's gradient.
        torch.testing.assert_close(got["y"], one["y"], rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(got["x_grad"], one["x_grad"],
                                   rtol=1e-5, atol=1e-5)
        for name, g in got["grads"].items():
            torch.testing.assert_close(g[0], one["grads"][name][pid],
                                       rtol=1e-5, atol=1e-5, msg=name)


def test_pipeline_lm_across_processes_matches_one(tmp_path):
    from elasticdl_tpu_torch.models.pipeline_lm import PipelineLM
    from elasticdl_tpu_torch.models.transformer import TransformerConfig

    torch.manual_seed(11)
    model = PipelineLM(TransformerConfig(compute_dtype=torch.float32, **CFG),
                       _mesh(None), num_microbatches=4, layers_per_stage=2)
    torch.save(model.state_dict(), tmp_path / "init.pt")
    res = _run_pair(tmp_path, "lm")
    want = run_lm(str(tmp_path))
    one = torch.load(tmp_path / "lm_one.pt")
    got = [torch.load(tmp_path / f"lm_p{pid}.pt") for pid in (0, 1)]
    assert res[0]["spans"] and not want["spans"]
    assert all("only 'pp' may span" in (res[p]["dp_across_refused"] or "")
               for p in (0, 1))
    # A process holds its stage of every block leaf, the ends whole.
    for name, rows in want["rows"].items():
        expect = rows // 2 if name.startswith("blocks.") else rows
        assert res[0]["rows"][name] == res[1]["rows"][name] == expect, name
    assert res[0]["losses"] == res[1]["losses"]
    np.testing.assert_allclose(res[0]["losses"], want["losses"], rtol=1e-5)
    for name, value in one["params"].items():
        torch.testing.assert_close(got[0]["params"][name],
                                   got[1]["params"][name], rtol=0, atol=0,
                                   msg=name)
        torch.testing.assert_close(got[0]["grads"][name],
                                   one["grads"][name], rtol=1e-4,
                                   atol=1e-5, msg=name)
        if name.endswith("attn.key.bias"):   # true gradient 0: Adam noise
            assert (got[0]["params"][name] - value).abs().max() <= (
                2 * STEPS * LR)
            continue
        torch.testing.assert_close(got[0]["params"][name], value, rtol=0,
                                   atol=LR / 100, msg=name)
