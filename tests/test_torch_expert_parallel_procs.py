"""Expert parallel and the scatter dispatch across two processes of the
port over ``torch.distributed`` on the CPU, each against the port's
one-process run on the same global mesh, weights and batches.

Each test starts two subprocesses that import only the port (and torch,
numpy), wired by a ``FileStore`` under ``tmp_path`` (gloo); a subprocess
has a time limit, on whose expiry both are killed and the test fails.
The layouts, as JAX's ``make_mesh`` lays the meshes over two processes:

- ``ep`` across the processes (``(1, 2, 2)`` over ``("dp", "ep",
  "tp")``): each process holds two of the four experts, their hidden
  dim split over its two local ``tp`` entries (the experts' two-dim
  split spans the processes along ``ep``); both read the whole batch;
  the partial outputs meet in ``reduce_from`` over the ``ep`` x ``tp``
  group, the input's and the gates' gradients in ``copy_to``'s. Dense
  and scatter dispatch.
- ``dp`` across them (``(2, 2)`` over ``("dp", "ep")``) with scatter
  dispatch at a capacity that drops (factor 0.5): each process holds
  half of the batch's rows, ranks its choices after the per-expert
  counts of the rows before its own (exchanged over the data group),
  and drops exactly the choices the one-process run drops.

f32 with dropout 0.1 (the masks drawn for the global batch). Tolerances,
as tests/test_torch_tensor_parallel_procs.py's: losses 1e-5 relative,
every parameter within a hundredth of one Adam step (lr / 100) of the
one-process run's, the key biases (true gradient 0: Adam steps them by
noise) within the steps' reach, the two processes' parameters equal;
the dropped choices' count equal to the one-process run's.
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

_SCRIPT = """
    import json, os, sys
    import torch
    torch.set_num_threads(2)
    sys.path.insert(0, {repo!r})
    from elasticdl_tpu_torch.parallel import multihost
    pid, store, data, layout = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                sys.argv[4])
    sys.path.insert(0, os.path.dirname({test!r}))
    import test_torch_expert_parallel_procs as case

    multihost.initialize_multihost(store, 2, pid, device="cpu")
    out = case.run_layout(layout, data, pid)
    out["pid"] = pid
    print("RESULT " + json.dumps(out), flush=True)
"""

LM_CFG = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_len=32, dropout_rate=0.1, moe_experts=4, moe_every=2)
LAYOUTS = {
    "ep_dense": (((1, 2, 2), ("dp", "ep", "tp")),
                 dict(moe_dispatch="dense"), False),
    "ep_scatter": (((1, 2, 2), ("dp", "ep", "tp")),
                   dict(moe_dispatch="scatter", moe_capacity_factor=1.0),
                   False),
    "dp_scatter": (((2, 2), ("dp", "ep")),
                   dict(moe_dispatch="scatter", moe_capacity_factor=0.5,
                        moe_top_k=2), True),
}


def _cfg(layout):
    from elasticdl_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(compute_dtype=torch.float32,
                             **LM_CFG, **LAYOUTS[layout][1])


def _batches():
    rng = np.random.RandomState(3)
    out = []
    for _ in range(STEPS):
        seq = (rng.randint(0, 32, (4, 1)) + np.arange(17)[None, :]) % 32
        out.append({"features": seq[:, :-1].astype(np.int32),
                    "labels": seq[:, 1:].astype(np.int32),
                    "mask": np.ones((4,), np.float32)})
    return out


def _rows(batch, pid):
    """Process ``pid``'s rows of a global batch."""
    return {k: v[pid * (v.shape[0] // 2):(pid + 1) * (v.shape[0] // 2)]
            for k, v in batch.items()}


def run_layout(layout, data, pid=None):
    """Train ``layout`` for STEPS steps; ``pid`` None is the one-process
    run on the global batches (4 entries in the process). Returns the
    losses and the dropped choices, writes the final parameters (whole)
    to ``data``."""
    from elasticdl_tpu_torch.models.transformer import (
        TransformerLM,
        transformer_sharding_rules,
    )
    from elasticdl_tpu_torch.ops.losses import (
        masked_next_token_cross_entropy,
    )
    from elasticdl_tpu_torch.parallel import rules
    from elasticdl_tpu_torch.parallel.mesh import make_mesh
    from elasticdl_tpu_torch.parallel.mesh_runner import MeshRunner

    (shape, axes), _, rows_split = LAYOUTS[layout]
    mesh = make_mesh(shape, axes, [CPU] * (4 if pid is None else 2))
    model = TransformerLM(_cfg(layout), mesh=mesh)
    model.load_state_dict(torch.load(os.path.join(data, "init.pt")))
    runner = MeshRunner(mesh, param_rule=rules.regex_param_rule(
        transformer_sharding_rules(), mesh=mesh),
        batch_rule=lambda path, leaf: rules.PartitionSpec(
            "dp", "sp") if getattr(leaf, "ndim", 0) == 2
        else rules.PartitionSpec("dp"))
    state = runner.init_state(model, lambda p: torch.optim.Adam(p, lr=LR),
                              seed=0)
    step = runner.train_step(masked_next_token_cross_entropy)
    held = {n: list(p.shape) for n, p in state.model.named_parameters()}
    losses, dropped = [], []
    for batch in _batches():
        if pid is not None and rows_split:
            batch = _rows(batch, pid)
        state, metrics = step(state, runner.place_batch(batch))
        losses.append(metrics["loss"].item())
        moe = state.model.blocks[1].moe
        dropped.append(None if moe.dropped is None else int(moe.dropped))
    shardings = runner.param_shardings(state.model)
    params = {name: shardings[name].gather_block(p.detach())
              if shardings[name].spans_processes else p.detach()
              for name, p in state.model.named_parameters()}
    tag = "one" if pid is None else f"p{pid}"
    torch.save(params, os.path.join(data, f"{layout}_{tag}.pt"))
    return {"losses": losses, "dropped": dropped, "held": held,
            "spans": mesh.spans_processes}


def _run_pair(tmp_path, layout):
    script = tmp_path / "proc.py"
    script.write_text(textwrap.dedent(_SCRIPT.format(
        repo=REPO, test=os.path.abspath(__file__))))
    store = f"file://{tmp_path / 'store'}"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), store, str(tmp_path),
         layout], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=str(tmp_path)) for pid in (0, 1)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        for q in procs:
            q.communicate()
        pytest.fail("two-process run hung (a collective)")
    found = {}
    for pid, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"process {pid}:\n{out}"
        for line in out.splitlines():
            if line.startswith("RESULT "):
                res = json.loads(line[len("RESULT "):])
                found[res["pid"]] = res
    assert sorted(found) == [0, 1], outputs
    return found


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_two_processes_match_one(layout, tmp_path):
    from elasticdl_tpu_torch.models.transformer import TransformerLM

    torch.manual_seed(13)
    torch.save(TransformerLM(_cfg(layout)).state_dict(),
               tmp_path / "init.pt")
    res = _run_pair(tmp_path, layout)
    want = run_layout(layout, str(tmp_path))
    one = torch.load(tmp_path / f"{layout}_one.pt")
    got = [torch.load(tmp_path / f"{layout}_p{pid}.pt") for pid in (0, 1)]
    assert res[0]["spans"] and not want["spans"]
    wi = "blocks.1.moe.wi"
    if layout.startswith("ep"):
        # Two of the four experts a process, whole on one process.
        assert res[0]["held"][wi] == [2, 32, 64]
        assert want["held"][wi] == [4, 32, 64]
        assert res[0]["dropped"] == res[1]["dropped"]
    if layout.endswith("scatter"):
        procs = [a + b for a, b in zip(res[0]["dropped"],
                                       res[1]["dropped"])]
        if layout.startswith("ep"):
            procs = res[0]["dropped"]
        assert procs == want["dropped"] and min(want["dropped"]) > 0
    assert res[0]["losses"] == res[1]["losses"]
    np.testing.assert_allclose(res[0]["losses"], want["losses"], rtol=1e-5)
    for name, value in one.items():
        torch.testing.assert_close(got[0][name], got[1][name], rtol=0,
                                   atol=0, msg=name)
        if name.endswith("attn.key.bias"):   # true gradient 0: Adam noise
            assert (got[0][name] - value).abs().max() <= 2 * STEPS * LR
            continue
        torch.testing.assert_close(got[0][name], value, rtol=0,
                                   atol=LR / 100, msg=name)
