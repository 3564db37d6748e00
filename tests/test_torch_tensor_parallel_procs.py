"""Tensor parallel, the sp ring and a table split as a parameter across
two processes of the port over ``torch.distributed`` on the CPU, each
against the port's one-process run on the same global mesh, weights
and batches.

Each test starts two subprocesses that import only the port (and
torch, numpy), wired by a ``FileStore`` under ``tmp_path`` (gloo). A
subprocess has a time limit: on expiry both are killed and the test
fails. The layouts, as JAX's ``make_mesh`` lays a (1, 2, 2) mesh over
two processes:

- ``tp`` across the processes (``("dp", "tp", "sp")``): each process
  holds half of every tp-split kernel, its half of the heads, half of
  the vocabulary's embedding rows and logits; both read the whole
  batch;
- ``sp`` across them (``("dp", "sp", "tp")``): each holds the first or
  second half of every sequence, K/V chunks and their gradients cross
  by send/recv, both tp entries local;
- the DenseFeatures model of tests/test_feature_column.py:238 on dp2,
  its 4 MB table split by rows over the processes, each with half of
  the batch's rows.

The transformers are f32 with dropout 0.1 (the masks drawn for the
global batch, a process keeping its block). Tolerances: losses 1e-5
relative, every parameter within a hundredth of one Adam step (lr /
100) of the one-process run's (summed in another order: the
all-reduces add the processes' partial products and gradients, and
Adam's m/sqrt(v) turns a gradient's f32 error near 0 into lr times its
relative size, tests/test_torch_mesh_runner.py), the two processes'
parameters
equal to each other; the split table's run equal to one process's
within 1e-7. The key biases' true gradient is 0, so Adam steps them by
noise on both sides: they are held to the steps' reach, 3 lr each way
(tests/test_torch_mesh_runner.py).
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

_SCRIPT = """
    import json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(2)
    sys.path.insert(0, {repo!r})
    from elasticdl_tpu_torch.parallel import multihost
    from elasticdl_tpu_torch.parallel.mesh import make_mesh
    pid, store, data, layout = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                sys.argv[4])
    sys.path.insert(0, os.path.dirname({test!r}))
    import test_torch_tensor_parallel_procs as case

    multihost.initialize_multihost(store, 2, pid, device="cpu")
    out = case.run_layout(layout, data, pid)
    out["pid"] = pid
    print("RESULT " + json.dumps(out), flush=True)
"""

LM_CFG = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_len=32, dropout_rate=0.1)
LAYOUTS = {"tp": ("dp", "tp", "sp"), "sp": ("dp", "sp", "tp")}


def _lm_batches():
    rng = np.random.RandomState(3)
    out = []
    for _ in range(STEPS):
        seq = (rng.randint(0, 32, (4, 1)) + np.arange(17)[None, :]) % 32
        out.append({"features": seq[:, :-1].astype(np.int32),
                    "labels": seq[:, 1:].astype(np.int32),
                    "mask": np.ones((4,), np.float32)})
    return out


def _table_batches():
    rng = np.random.RandomState(5)
    return [{"features": {"x": rng.rand(8, 1).astype(np.float32),
                          "c": rng.randint(0, 1 << 15, (8, 2))
                          .astype(np.int32)},
             "labels": rng.rand(8).astype(np.float32),
             "mask": np.ones((8,), np.float32)} for _ in range(STEPS)]


def _block(batch, pid, rows_split, seq_split):
    """Process ``pid``'s block of a global batch."""
    if isinstance(batch, dict):
        return {k: _block(v, pid, rows_split, seq_split)
                for k, v in batch.items()}
    if rows_split:
        n = batch.shape[0] // 2
        batch = batch[pid * n:(pid + 1) * n]
    if seq_split and batch.ndim == 2:
        n = batch.shape[1] // 2
        batch = batch[:, pid * n:(pid + 1) * n]
    return batch


def _lm(mesh, init):
    from elasticdl_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        transformer_sharding_rules,
    )
    from elasticdl_tpu_torch.parallel import rules
    from elasticdl_tpu_torch.parallel.mesh_runner import MeshRunner

    model = TransformerLM(TransformerConfig(
        compute_dtype=torch.float32, **LM_CFG), mesh=mesh)
    model.load_state_dict(init)
    runner = MeshRunner(mesh, param_rule=rules.regex_param_rule(
        transformer_sharding_rules(), mesh=mesh),
        batch_rule=lambda path, leaf: rules.PartitionSpec(
            "dp", "sp") if getattr(leaf, "ndim", 0) == 2
        else rules.PartitionSpec("dp"))
    return runner, model


class _TableModel(torch.nn.Module):
    def __init__(self):
        from elasticdl_tpu_torch.preprocessing import feature_column as fc

        super().__init__()
        self.features = fc.DenseFeatures([
            fc.numeric_column("x"),
            fc.embedding_column(fc.categorical_column_with_identity(
                "c", 1 << 15), 32)])
        self.Dense_0 = torch.nn.Linear(33, 1)

    def forward(self, features):
        return self.Dense_0(self.features(features))[..., 0]


def _sq_loss(labels, preds, mask):
    return torch.mean(torch.square(preds - labels) * mask)


def _whole_params(state, runner):
    """Every parameter whole: a placed one's blocks gathered."""
    shardings = runner.param_shardings(state.model)
    return {name: shardings[name].gather_block(p.detach())
            if shardings[name].spans_processes else p.detach()
            for name, p in state.model.named_parameters()}


def run_layout(layout, data, pid=None, devices=2):
    """Train ``layout`` for STEPS steps on a mesh of ``devices`` entries
    a process (4 on one process: the reference); ``pid`` None is the
    one-process run on the global batches. Returns the losses, and
    writes the final parameters to ``data``."""
    from elasticdl_tpu_torch.ops.losses import (
        masked_next_token_cross_entropy,
    )
    from elasticdl_tpu_torch.parallel import multihost
    from elasticdl_tpu_torch.parallel.mesh import make_mesh
    from elasticdl_tpu_torch.parallel.mesh_runner import MeshRunner

    init = torch.load(os.path.join(data, f"{layout}_init.pt"))
    if layout == "table":
        mesh = make_mesh((2,), ("dp",), [CPU] * (devices // 2))
        model = _TableModel()
        model.load_state_dict(init)
        runner = MeshRunner(mesh)
        state = runner.init_state(model, lambda p: torch.optim.SGD(
            p, lr=0.1))
        step, batches = runner.train_step(_sq_loss), _table_batches()
        rows_split, seq_split = True, False
    else:
        mesh = make_mesh((1, 2, 2), LAYOUTS[layout], [CPU] * devices)
        runner, model = _lm(mesh, init)
        state = runner.init_state(model, lambda p: torch.optim.Adam(
            p, lr=1e-2), seed=0)
        step = runner.train_step(masked_next_token_cross_entropy)
        batches = _lm_batches()
        rows_split, seq_split = False, layout == "sp"
    placed = {n: p.shape[0] for n, p in state.model.named_parameters()}
    losses = []
    for batch in batches:
        if pid is not None:
            batch = _block(batch, pid, rows_split, seq_split)
        state, metrics = step(state, runner.place_batch(batch))
        losses.append(metrics["loss"].item())
    params = _whole_params(state, runner)
    tag = "one" if pid is None else f"p{pid}"
    torch.save(params, os.path.join(data, f"{layout}_{tag}.pt"))
    return {"losses": losses, "rows": placed,
            "spans": mesh.spans_processes,
            "groups": multihost.process_count()}


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
        pytest.fail("two-process run hung (the ring or a collective)")
    found = {}
    for pid, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"process {pid}:\n{out}"
        for line in out.splitlines():
            if line.startswith("RESULT "):
                res = json.loads(line[len("RESULT "):])
                found[res["pid"]] = res
    assert sorted(found) == [0, 1], outputs
    return found


def _init(layout, tmp_path):
    torch.manual_seed(11)
    if layout == "table":
        model = _TableModel()
    else:
        from elasticdl_tpu_torch.models.transformer import (
            TransformerConfig,
            TransformerLM,
        )

        model = TransformerLM(TransformerConfig(
            compute_dtype=torch.float32, **LM_CFG))
    torch.save(model.state_dict(), tmp_path / f"{layout}_init.pt")


@pytest.mark.parametrize("layout", ["tp", "sp", "table"])
def test_two_processes_match_one(layout, tmp_path):
    _init(layout, tmp_path)
    res = _run_pair(tmp_path, layout)
    want = run_layout(layout, str(tmp_path), None, devices=4)
    one = torch.load(tmp_path / f"{layout}_one.pt")
    got = [torch.load(tmp_path / f"{layout}_p{pid}.pt") for pid in (0, 1)]
    assert res[0]["spans"] and not want["spans"]
    if layout == "tp":
        # Half of each tp-split kernel a process (Q/K/V rows, the
        # vocabulary's rows), whole on one process.
        for name in ("blocks.0.attn.query.weight", "token_embed.weight",
                     "lm_head.weight", "blocks.1.mlp.wi.weight"):
            assert res[0]["rows"][name] * 2 == want["rows"][name], name
    if layout == "table":
        name = "features.c_embedding.embedding"
        assert res[0]["rows"][name] * 2 == want["rows"][name] == 1 << 15
    assert res[0]["losses"] == res[1]["losses"]
    np.testing.assert_allclose(res[0]["losses"], want["losses"],
                               rtol=1e-7 if layout == "table" else 1e-5)
    for name, value in one.items():
        torch.testing.assert_close(got[0][name], got[1][name], rtol=0,
                                   atol=0, msg=name)
        if name.endswith("attn.key.bias"):   # true gradient 0: Adam noise
            assert (got[0][name] - value).abs().max() <= 2 * STEPS * 1e-2
            continue
        torch.testing.assert_close(
            got[0][name], value, rtol=0,
            atol=1e-7 if layout == "table" else 1e-2 / 100, msg=name)
