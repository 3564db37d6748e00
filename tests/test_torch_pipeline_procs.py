"""The pipeline with processes of the port over ``torch.distributed`` on
the CPU, against the port's one-process run on the same global mesh,
weights and batches, and against JAX's one-process PipelineLM.

Subprocesses import only the port (and torch, numpy), wired by a
``FileStore`` under ``tmp_path`` (gloo), each under a time limit that
kills them all. The global mesh is (pp 2, dp 2) in three layouts:

- ``pp`` across two processes (``("pp", "dp")``, as JAX's ``make_mesh``
  lays it over two processes): process p holds stage p (both its dp
  entries), both read the whole batch. Process 0 runs the embedding
  into stage 0 and sends its activations on; process 1 runs stage 1,
  and its outputs are broadcast, so both compute the head and the loss.
  The backward is the reverse pipeline.
- ``dp`` across two processes (``("dp", "pp")``): process p holds both
  stages and reads its 8 rows of the global 16; the stages run in tick
  order in each, and the step weighs each loss by its share of the
  global batch and sums the gradients over the data group.
- both across four processes: each holds one stage for one dp block;
  each dp coordinate's pair pipelines over its own pp group, then the
  gradients are summed over the dp pairs.

Tolerances: the losses 1e-5 relative (to one process and to JAX); the
processes' losses and whole parameters equal; each stage's blocks and
the ends within a hundredth of one Adam step (lr / 100) of the
one-process run's and of JAX's (the microbatches' gradients are summed
in another order), the attention key biases (true gradient 0, Adam
steps them by noise) within their steps' reach; the first step's
gradients 1e-4 relative. A mesh with another axis across processes is
refused. Also ``pipeline_apply`` alone, forward and gradients, against
one process.
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
TIMEOUT_S = 180
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

    case, _, layout = case.partition(":")
    multihost.initialize_multihost(store, case_mod.procs(layout), pid,
                                   device="cpu")
    out = case_mod.RUNS[case](data, pid, layout or "pp")
    out["pid"] = pid
    print("RESULT " + json.dumps(out), flush=True)
"""


# layout -> (processes, the mesh's axes); the mesh is (2, 2) in each.
LAYOUTS = {"pp": (2, ("pp", "dp")), "dp": (2, ("dp", "pp")),
           "pp_dp": (4, ("pp", "dp"))}


def procs(layout):
    return LAYOUTS[layout or "pp"][0]


def _batches():
    rng = np.random.RandomState(7)
    out = []
    for _ in range(STEPS):
        seq = (rng.randint(0, 32, (16, 1)) + np.arange(17)[None, :]) % 32
        out.append({"features": seq[:, :-1].astype(np.int32),
                    "labels": seq[:, 1:].astype(np.int32),
                    "mask": np.ones((16,), np.float32)})
    return out


def _mesh(pid, layout="pp"):
    from elasticdl_tpu_torch.parallel.mesh import make_mesh

    n, axes = LAYOUTS[layout]
    if pid is None:
        return make_mesh((2, 2), ("pp", "dp"), [CPU] * 4)
    return make_mesh((2, 2), axes, [CPU] * (4 // n))


def _local(batch, mesh):
    """This process's rows of the global batch (its dp block)."""
    count, index = mesh.block_of("dp")
    rows = len(batch["mask"]) // count
    return {k: v[index * rows:(index + 1) * rows] for k, v in batch.items()}


def run_lm(data, pid=None, layout="pp"):
    """PipelineLM trained STEPS Adam steps; writes the whole final
    parameters (the stages gathered) and the first step's gradients."""
    from elasticdl_tpu_torch.models.pipeline_lm import PipelineLM
    from elasticdl_tpu_torch.models.transformer import TransformerConfig
    from elasticdl_tpu_torch.ops.losses import (
        masked_next_token_cross_entropy,
    )

    mesh = _mesh(pid, layout)
    model = PipelineLM(TransformerConfig(compute_dtype=torch.float32, **CFG),
                       mesh, num_microbatches=4, layers_per_stage=2)
    model.load_state_dict(torch.load(os.path.join(data, "init.pt")))
    step = model.make_train_step(masked_next_token_cross_entropy,
                                 lambda p: torch.optim.Adam(p, lr=LR))
    shardings = model.param_shardings()
    rows = {n: p.shape[0] for n, p in model.named_parameters()}
    losses, grads = [], None
    for batch in _batches():
        losses.append(float(step(_local(batch, mesh))))
        if grads is None:
            grads = _whole(model, shardings, lambda p: p.grad)
    tag = "one" if pid is None else f"{layout}_p{pid}"
    torch.save({"params": _whole(model, shardings, lambda p: p),
                "grads": grads}, os.path.join(data, f"lm_{tag}.pt"))
    refused = None
    if pid is not None and layout == "dp":
        # Another axis across the processes: refused, the step sums
        # gradients over the data group alone.
        from elasticdl_tpu_torch.parallel.mesh import make_mesh

        try:
            PipelineLM(TransformerConfig(compute_dtype=torch.float32,
                                         **CFG),
                       make_mesh((2, 2), ("tp", "pp"), [CPU] * 2),
                       layers_per_stage=2)
        except NotImplementedError as exc:
            refused = str(exc)
    return {"losses": losses, "rows": rows, "spans": mesh.spans_processes,
            "other_across_refused": refused}


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


def run_apply(data, pid=None, layout="pp"):
    """``pipeline_apply`` over 2 stages: the outputs and the gradients
    of sum(y²) by the stacked leaves (this process's block)."""
    from elasticdl_tpu_torch.parallel.pipeline import pipeline_apply

    mesh = _mesh(pid, layout)
    init = torch.load(os.path.join(data, "apply.pt"))
    lo = 0 if pid is None else pid
    hi = 2 if pid is None else pid + 1
    stacked = {k: v[lo:hi].clone().requires_grad_()
               for k, v in init["stacked"].items()}
    x = init["x"].clone().requires_grad_()
    y = pipeline_apply(_stage_fn, stacked, x, mesh, axis="pp")
    (y ** 2).sum().backward()
    tag = "one" if pid is None else f"{layout}_p{pid}"
    torch.save({"y": y.detach(), "x_grad": x.grad,
                "grads": {k: v.grad for k, v in stacked.items()}},
               os.path.join(data, f"apply_{tag}.pt"))
    return {}


RUNS = {"lm": run_lm, "apply": run_apply}


def _run_procs(tmp_path, case, layout="pp"):
    n = procs(layout)
    script = tmp_path / "proc.py"
    script.write_text(textwrap.dedent(_SCRIPT.format(
        repo=REPO, test=os.path.abspath(__file__))))
    store = f"file://{tmp_path / ('store_' + layout)}"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    workers = [subprocess.Popen(
        [sys.executable, str(script), str(pid), store, str(tmp_path),
         f"{case}:{layout}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path)) for pid in range(n)]
    outputs = []
    try:
        for p in workers:
            outputs.append(p.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for q in workers:
            q.kill()
        for q in workers:
            q.communicate()
        pytest.fail(f"{n}-process pipeline hung (a send/recv or "
                    "collective)")
    found = {}
    for pid, (p, out) in enumerate(zip(workers, outputs)):
        assert p.returncode == 0, f"process {pid}:\n{out}"
        for line in out.splitlines():
            if line.startswith("RESULT "):
                res = json.loads(line[len("RESULT "):])
                found[res["pid"]] = res
    assert sorted(found) == list(range(n)), outputs
    return found


_JAX = {}


def _jax_reference():
    """JAX's one-process PipelineLM on (pp 2, dp 2) over 4 of the
    conftest's CPU devices: its initial parameters in the port's names,
    its losses and its final parameters (the port's names), over the
    same global batches."""
    if _JAX:
        return _JAX
    import jax
    import jax.numpy as jnp
    import optax

    from elasticdl_tpu.models.pipeline_lm import PipelineLM as JaxLM
    from elasticdl_tpu.models.transformer import (
        TransformerConfig as JaxConfig,
    )
    from elasticdl_tpu.ops import masked_next_token_cross_entropy as loss
    from elasticdl_tpu.parallel.mesh import make_mesh as jax_mesh
    from elasticdl_tpu_torch import bridge

    mesh = jax_mesh((2, 2), ("pp", "dp"), devices=jax.devices()[:4])
    lm = JaxLM(JaxConfig(compute_dtype=jnp.float32, **CFG), mesh,
               num_microbatches=4, layers_per_stage=2)
    batches = _batches()
    params = lm.init(jax.random.PRNGKey(0), batches[0]["features"])
    params = jax.device_put(params, lm.param_shardings(params))

    def port(tree):
        return bridge.pipeline_state_dict_from_flax(
            jax.tree.map(np.asarray, tree), pp=2, layers_per_stage=2)

    _JAX["init"] = port(params)
    tx = optax.adam(LR)
    opt_state, step = tx.init(params), lm.make_train_step(loss, tx)
    losses = []
    for batch in batches:
        params, opt_state, value = step(params, opt_state, batch)
        losses.append(float(value))
    _JAX["losses"], _JAX["params"] = losses, port(params)
    return _JAX


def _close_to(got, want, name):
    if name.endswith("attn.key.bias"):   # true gradient 0: Adam noise
        assert (got - want).abs().max() <= 2 * STEPS * LR, name
        return
    torch.testing.assert_close(got, want, rtol=0, atol=LR / 100, msg=name)


def _check_lm(tmp_path, layout):
    """``layout``'s processes against one process and against JAX."""
    ref = _jax_reference()
    torch.save(ref["init"], tmp_path / "init.pt")
    res = _run_procs(tmp_path, "lm", layout)
    want = run_lm(str(tmp_path))
    one = torch.load(tmp_path / "lm_one.pt")
    n = procs(layout)
    got = [torch.load(tmp_path / f"lm_{layout}_p{pid}.pt")
           for pid in range(n)]
    assert all(res[p]["spans"] for p in range(n)) and not want["spans"]
    # A process holds its block of the stages, the ends whole.
    stage_split = layout != "dp"
    for name, rows in want["rows"].items():
        expect = (rows // 2 if stage_split and name.startswith("blocks.")
                  else rows)
        assert {res[p]["rows"][name] for p in range(n)} == {expect}, name
    assert all(res[p]["losses"] == res[0]["losses"] for p in range(n))
    np.testing.assert_allclose(res[0]["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(res[0]["losses"], ref["losses"], rtol=1e-5)
    for name, value in one["params"].items():
        for p in range(1, n):
            torch.testing.assert_close(got[p]["params"][name],
                                       got[0]["params"][name], rtol=0,
                                       atol=0, msg=name)
        torch.testing.assert_close(got[0]["grads"][name],
                                   one["grads"][name], rtol=1e-4,
                                   atol=1e-5, msg=name)
        _close_to(got[0]["params"][name], value, name)
        _close_to(got[0]["params"][name], ref["params"][name], name)
    return res


def test_pipeline_apply_across_processes(tmp_path):
    gen = torch.Generator().manual_seed(3)
    torch.save({
        "stacked": {"w1": torch.randn(2, 16, 32, generator=gen) * 0.1,
                    "b1": torch.zeros(2, 32),
                    "w2": torch.randn(2, 32, 16, generator=gen) * 0.1},
        "x": torch.randn(8, 4, 16, generator=gen)}, tmp_path / "apply.pt")
    _run_procs(tmp_path, "apply")
    run_apply(str(tmp_path))
    one = torch.load(tmp_path / "apply_one.pt")
    for pid in (0, 1):
        got = torch.load(tmp_path / f"apply_pp_p{pid}.pt")
        # Every process holds the outputs and the input's gradient.
        torch.testing.assert_close(got["y"], one["y"], rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(got["x_grad"], one["x_grad"],
                                   rtol=1e-5, atol=1e-5)
        for name, g in got["grads"].items():
            torch.testing.assert_close(g[0], one["grads"][name][pid],
                                       rtol=1e-5, atol=1e-5, msg=name)


def test_pipeline_lm_across_processes_matches_one(tmp_path):
    """dp across the two processes, pp within each."""
    res = _check_lm(tmp_path, "dp")
    assert all("only 'pp' and 'dp' may span" in (
        res[p]["other_across_refused"] or "") for p in (0, 1))


def test_pipeline_lm_pp_across_processes_matches_one(tmp_path):
    _check_lm(tmp_path, "pp")


def test_pipeline_lm_pp_and_dp_across_four_processes_matches_one(tmp_path):
    _check_lm(tmp_path, "pp_dp")
