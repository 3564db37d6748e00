"""Two worker processes of the port over ``torch.distributed`` on the
CPU (elasticdl_tpu_torch/parallel/multihost.py, the process-spanning
mesh, MeshRunner, ZeroOptimizer, BatchNorm, the row-sharded sparse
plane and the worker's barrier), against the JAX package run in this
test's own process: tests/test_multihost_2proc.py and
tests/test_multihost_job.py through the port.

Each test starts two subprocesses that import only the port (and
torch, numpy), wired by a ``FileStore`` under ``tmp_path`` (gloo; the
data group is gloo too, since they run on the CPU). Each subprocess
has a time limit: on expiry both are killed and the test fails, so a
broken barrier fails here and never stalls the suite. Inputs cross as
``.npz``/``.pt`` files.

Tolerances:

- the drain barrier: process 0 takes 3 real steps, process 1 one, then
  2 zero-mask dummies. Final parameters within 1e-5 relative L2 of
  JAX's single-process MeshRunner fed the same global batches (zero-mask
  rows for the dummies): the global loss is one all-reduce of each
  process's ``max(M_p, 1)``-weighted loss and gradients over f32, a
  different summation order from XLA's over the 8 rows.
- the row-sharded table (2 processes x 2 entries): each process's rows
  bit-equal to the same rows of the one-process seed-0 table (drawn
  whole on the host, then split); losses within rtol 1e-4, atol 1e-5 of
  JAX's single-process run, the JAX test's own bound; the two
  processes' losses equal (one all-reduce gives both the same sum).
- BatchNorm (mnist_functional, f32, 2 processes x 2 entries against the
  port's one-process dp4 run over the global batch and JAX's dp4):
  losses within 1e-4 relative, each parameter's change and each running
  statistic within 1e-2 relative L2 floored at 1e-3 of the whole tree,
  tests/test_torch_mesh_dp.py's bounds: the statistics are the global
  batch's sums, all-reduced from two halves, a summation order that
  BatchNorm's chain amplifies as it does XLA's against PyTorch's.
- the job: both processes end at one version, eval metrics reported,
  a finite loss, every training batch trained once.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120

_PRELUDE = """
    import json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(2)
    sys.path.insert(0, {repo!r})
    from elasticdl_tpu_torch.parallel import multihost
    pid = int(sys.argv[1]); store = sys.argv[2]; data = sys.argv[3]
"""


def _run_pair(tmp_path, body, extra_args=(), timeout=TIMEOUT_S):
    """Run ``body`` (after the prelude) in two processes; returns their
    outputs, after checking both exited 0."""
    script = tmp_path / "proc.py"
    script.write_text(textwrap.dedent(_PRELUDE.format(repo=REPO))
                      + textwrap.dedent(body))
    store = f"file://{tmp_path / 'store'}"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), store, str(tmp_path),
         *extra_args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path)) for pid in (0, 1)]
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outputs.append(out)
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        for q in procs:
            q.communicate()
        pytest.fail("two-process run hung (the barrier or a collective)")
    for pid, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"process {pid}:\n{out}"
    return outputs


def _results(outputs):
    """{pid: the JSON after "RESULT "} of each process."""
    import json

    found = {}
    for out in outputs:
        for line in out.splitlines():
            if line.startswith("RESULT "):
                res = json.loads(line[len("RESULT "):])
                found[res["pid"]] = res
    assert sorted(found) == [0, 1], outputs
    return found


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


# ---- (a) the drain barrier -------------------------------------------------

_DRAIN = """
    from elasticdl_tpu_torch.parallel.mesh import make_mesh
    from elasticdl_tpu_torch.parallel.mesh_runner import MeshRunner

    multihost.initialize_multihost(store, 2, pid, device="cpu")
    mesh = make_mesh((4,), ("dp",), [torch.device("cpu")] * 2)
    assert mesh.spans_processes and mesh.shape == {"dp": 4}
    runner = MeshRunner(mesh)
    init = np.load(os.path.join(data, "init.npz"))
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(init["kernel"].T))
        model.bias.copy_(torch.from_numpy(init["bias"]))

    def loss(labels, preds, mask):
        err = ((preds - labels) ** 2).sum(-1)
        return (err * mask).sum() / mask.sum().clamp_min(1.0)

    rng = np.random.RandomState(pid)
    def local_batch():
        return {"features": rng.rand(4, 3).astype(np.float32),
                "labels": rng.rand(4, 2).astype(np.float32),
                "mask": np.ones((4,), np.float32)}

    local_batch()  # the JAX script's example batch for init_state
    state = runner.init_state(model, lambda p: torch.optim.SGD(p, lr=0.1))
    step = runner.train_step(loss)
    n_real = 3 if pid == 0 else 1
    batch = None
    for _ in range(n_real):
        batch = local_batch()
        multihost.exchange_continue(mesh, "dp", True)
        state, m = step(state, batch)
    drains = 0
    dummy = multihost.zero_mask_like(batch)
    while multihost.exchange_continue(mesh, "dp", False):
        state, _ = step(state, dummy)
        drains += 1
    print("RESULT " + json.dumps({
        "pid": pid, "steps": state.step, "drains": drains,
        "weight": model.weight.detach().numpy().tolist(),
        "bias": model.bias.detach().numpy().tolist(),
        "backend": multihost.data_backend()}), flush=True)
"""


def test_two_process_drain_barrier_matches_jax(tmp_path):
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import optax

    from elasticdl_tpu.parallel.mesh import make_mesh
    from elasticdl_tpu.parallel.mesh_runner import MeshRunner as JaxRunner

    class Lin(nn.Module):
        @nn.compact
        def __call__(self, x, training=False):
            return nn.Dense(2)(x)

    def loss(labels, preds, mask):
        err = ((preds - labels) ** 2).sum(-1)
        return (err * mask).sum() / jnp.maximum(mask.sum(), 1.0)

    draws = {}
    for pid, n in ((0, 4), (1, 2)):
        rng = np.random.RandomState(pid)
        draws[pid] = [(rng.rand(4, 3).astype(np.float32),
                       rng.rand(4, 2).astype(np.float32)) for _ in range(n)]
    zeros = (np.zeros((4, 3), np.float32), np.zeros((4, 2), np.float32))
    globals_ = []
    for i in range(1, 4):
        other = draws[1][i] if i < 2 else zeros
        globals_.append({
            "features": np.concatenate([draws[0][i][0], other[0]]),
            "labels": np.concatenate([draws[0][i][1], other[1]]),
            "mask": np.concatenate([np.ones(4, np.float32),
                                    np.full(4, float(i < 2), np.float32)])})
    runner = JaxRunner(mesh=make_mesh((4,), ("dp",),
                                      devices=jax.devices()[:4]),
                       donate_state=False)
    state = runner.init_state(Lin(), optax.sgd(0.1), globals_[0], seed=0)
    kernel = np.asarray(state.params["Dense_0"]["kernel"])
    bias = np.asarray(state.params["Dense_0"]["bias"])
    np.savez(tmp_path / "init.npz", kernel=kernel, bias=bias)
    step = runner.train_step(loss)
    for batch in globals_:
        state, _ = step(state, batch)
    want_w = np.asarray(state.params["Dense_0"]["kernel"]).T
    want_b = np.asarray(state.params["Dense_0"]["bias"])

    res = _results(_run_pair(tmp_path, _DRAIN))
    assert (res[0]["steps"], res[0]["drains"]) == (3, 0)
    assert (res[1]["steps"], res[1]["drains"]) == (3, 2)
    assert res[0]["backend"] == res[1]["backend"] == "gloo"
    for pid in (0, 1):
        got = np.concatenate([np.ravel(res[pid]["weight"]), res[pid]["bias"]])
        want = np.concatenate([np.ravel(want_w), want_b])
        assert _rel(got, want) <= 1e-5, (pid, got, want)
    assert res[0]["weight"] == res[1]["weight"]
    assert res[0]["bias"] == res[1]["bias"]


# ---- (b) the row-sharded table ---------------------------------------------

_SPARSE = """
    from torch import nn
    from elasticdl_tpu_torch.embedding.device_sparse import (
        DeviceSparseRunner, SparseEmbed, TableSpec,
    )
    from elasticdl_tpu_torch.embedding.optimizer import Adagrad
    from elasticdl_tpu_torch.ops import pallas_embedding as pe
    from elasticdl_tpu_torch.ops.losses import masked_sigmoid_cross_entropy
    from elasticdl_tpu_torch.parallel.mesh import ShardedTensor, make_mesh

    multihost.initialize_multihost(store, 2, pid, device="cpu")
    mesh = make_mesh((4,), ("dp",), [torch.device("cpu")] * 2)

    class TinySparse(nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = SparseEmbed("items", 16)
            self.layers = nn.ModuleList([nn.Linear(16, 8), nn.Linear(8, 1)])

        def forward(self, features, sparse_emb=None):
            x = torch.relu(self.layers[0](self.emb(sparse_emb)))
            return self.layers[1](x)[..., 0]

    runner = DeviceSparseRunner(
        (TableSpec("items", vocab=64, dim=16, feature_key="ids"),),
        Adagrad(lr=0.05), use_pallas="always", mesh=mesh,
        partition_threshold_bytes=0)
    data_ = np.load(os.path.join(data, "sparse.npz"))
    rows = slice(pid * 4, (pid + 1) * 4)

    def local(i):
        return {"features": {"ids": data_[f"ids{i}"][rows]},
                "labels": data_[f"labels{i}"][rows],
                "mask": np.ones(4, np.float32)}

    state = runner.init_state(TinySparse(),
                              lambda p: torch.optim.SGD(p, lr=0.1),
                              local(0), seed=0)
    # This process's rows are those of the one-process seed-0 table.
    alone = DeviceSparseRunner(runner.specs, runner.row_opt,
                               use_pallas="always").init_state(
        TinySparse(), lambda p: torch.optim.SGD(p, lr=0.1), local(0),
        seed=0)
    init_equal = bool(torch.equal(
        torch.cat(state.tables["items"].shards),
        alone.tables["items"][pid * 32:(pid + 1) * 32]))
    carried = torch.load(os.path.join(data, "carry.pt"))
    state.model.load_state_dict(carried["model"])
    table = state.tables["items"]
    acc = state.slot_tables["items"]["accumulator"]
    assert isinstance(table, ShardedTensor) and table.shape == (64, 16)
    table.copy_(carried["table"])
    acc.copy_(carried["accumulator"])
    local_rows = sum(s.shape[0] for s in table.shards)
    step = runner.train_step(masked_sigmoid_cross_entropy)
    # The kernel routes' calls (on the CPU their plain versions run,
    # which count no launch).
    calls = {"lookup": 0, "update": 0}
    lookup_pallas, row_update = pe.lookup_combine_pallas, pe.row_update

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    pe.lookup_combine_pallas = counted("lookup", lookup_pallas)
    pe.row_update = counted("update", row_update)
    losses = []
    for i in range(3):
        state, m = step(state, local(i))
        losses.append(float(m["loss"]))
    print("RESULT " + json.dumps({
        "pid": pid, "losses": losses, "local_rows": local_rows,
        "init_equal": init_equal,
        "shards": table.sharding.local_shards,
        "lookups": calls["lookup"], "updates": calls["update"],
        "whole_equal": bool(torch.equal(
            table.gather()[pid * 32:(pid + 1) * 32],
            torch.cat(table.shards)))}), flush=True)
"""


def test_two_process_sparse_row_sharded_matches_jax(tmp_path):
    import optax

    from elasticdl_tpu_torch import bridge
    from tests.sparse_common import (
        SPARSE_VOCAB, global_batch, make_model, make_runner, sparse_loss,
    )

    runner = make_runner(None)
    state = runner.init_state(make_model(), optax.sgd(0.1), global_batch(0),
                              seed=0)
    import jax

    carry = bridge.sparse_state_from_flax(
        jax.tree.map(np.asarray, state.params),
        {k: np.asarray(v) for k, v in state.tables.items()},
        {k: {s: np.asarray(a) for s, a in v.items()}
         for k, v in state.slot_tables.items()},
        {k: np.asarray(v) for k, v in state.table_steps.items()})
    torch.save({"model": carry["model"], "table": carry["tables"]["items"],
                "accumulator": carry["slot_tables"]["items"]["accumulator"]},
               tmp_path / "carry.pt")
    arrays = {}
    for i in range(3):
        b = global_batch(i)
        arrays[f"ids{i}"] = b["features"]["ids"]
        arrays[f"labels{i}"] = b["labels"]
    np.savez(tmp_path / "sparse.npz", **arrays)
    step = runner.train_step(sparse_loss)
    want = []
    for i in range(3):
        state, m = step(state, global_batch(i))
        want.append(float(m["loss"]))

    res = _results(_run_pair(tmp_path, _SPARSE))
    for pid in (0, 1):
        assert res[pid]["local_rows"] == SPARSE_VOCAB // 2
        assert res[pid]["shards"] == [2 * pid, 2 * pid + 1]
        # Kernel #6 and #7 (their plain versions here) once a local
        # shard a step.
        assert res[pid]["lookups"] == res[pid]["updates"] == 2 * 3
        assert res[pid]["whole_equal"] and res[pid]["init_equal"]
    assert res[0]["losses"] == res[1]["losses"]
    np.testing.assert_allclose(res[0]["losses"], want, rtol=1e-4, atol=1e-5)


# ---- (c) BatchNorm: mnist_functional ---------------------------------------

LR, B = 0.01, 16

_MNIST = """
    from elasticdl_tpu_torch.model_zoo.mnist import mnist_functional as twin
    from elasticdl_tpu_torch.parallel.mesh import make_mesh
    from elasticdl_tpu_torch.parallel.mesh_runner import MeshRunner
    from elasticdl_tpu_torch.parallel.zero import ZeroOptimizer

    multihost.initialize_multihost(store, 2, pid, device="cpu")
    mesh = make_mesh((4,), ("dp",), [torch.device("cpu")] * 2)
    model = twin.MnistModel(compute_dtype=torch.float32)
    model.load_state_dict(torch.load(os.path.join(data, "mnist_init.pt")))
    runner = MeshRunner(mesh)
    state = runner.init_state(model, twin.optimizer(lr=float(sys.argv[4])))
    assert isinstance(state.optimizer, ZeroOptimizer)
    assert state.optimizer.num_entries == 4
    assert state.optimizer.num_local == 2
    step = runner.train_step(twin.loss)
    batches = np.load(os.path.join(data, "mnist.npz"))
    half = batches["features"].shape[1] // 2
    rows = slice(pid * half, (pid + 1) * half)
    losses = []
    for i in range(batches["features"].shape[0]):
        batch = {k: batches[k][i][rows] for k in ("features", "labels",
                                                   "mask")}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    torch.save({k: v.detach().clone() for k, v in
                state.model.state_dict().items()},
               os.path.join(data, f"mnist_out{pid}.pt"))
    print("RESULT " + json.dumps({"pid": pid, "losses": losses}), flush=True)
"""


def _close(got, want, tol=1e-2):
    whole = np.linalg.norm(np.concatenate(
        [np.ravel(w).astype(np.float64) for w in want.values()]))
    for key, w in want.items():
        w = np.asarray(w, np.float64)
        err = np.linalg.norm(np.asarray(got[key], np.float64) - w)
        assert err <= tol * max(np.linalg.norm(w), 1e-3 * whole), key


def test_two_process_batch_norm_matches_one_process_and_jax(tmp_path):
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    import optax

    from elasticdl_tpu.core.model_spec import load_module
    from elasticdl_tpu.parallel.mesh import make_mesh as jax_mesh
    from elasticdl_tpu.parallel.mesh_runner import MeshRunner as JaxRunner
    from elasticdl_tpu_torch import bridge
    from elasticdl_tpu_torch.model_zoo.mnist import mnist_functional as twin
    from elasticdl_tpu_torch.parallel.mesh import make_mesh
    from elasticdl_tpu_torch.parallel.mesh_runner import MeshRunner

    rng = np.random.default_rng(5)
    steps = 3
    feats = rng.standard_normal((steps, B, 28, 28)).astype(np.float32)
    labels = rng.integers(0, 10, (steps, B)).astype(np.int32)
    mask = np.ones((steps, B), np.float32)
    mask[-1, -3:] = 0.0        # padded rows in process 1's half
    np.savez(tmp_path / "mnist.npz", features=feats, labels=labels,
             mask=mask)
    batches = [{"features": feats[i], "labels": labels[i], "mask": mask[i]}
               for i in range(steps)]
    jmod = load_module(os.path.join(REPO, "model_zoo", "mnist",
                                    "mnist_functional.py"))
    jrunner = JaxRunner(mesh=jax_mesh((4,), ("dp",),
                                      devices=jax.devices()[:4]),
                        donate_state=False)
    jstate = jrunner.init_state(jmod.MnistModel(compute_dtype=jnp.float32),
                                optax.sgd(LR, momentum=0.9), batches[0],
                                seed=1)
    initial = {"params": jax.tree.map(np.array, jstate.params),
               "batch_stats": jax.tree.map(np.array, jstate.batch_stats)}
    start = bridge.flax_state_dict(initial)
    torch.save(start, tmp_path / "mnist_init.pt")
    jstep = jrunner.train_step(jmod.loss)
    jlosses = []
    for b in batches:
        jstate, m = jstep(jstate, b)
        jlosses.append(float(m["loss"]))
    jax_final = bridge.flax_state_dict(
        {"params": jax.tree.map(np.asarray, jstate.params),
         "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)})
    del fnn

    model = twin.MnistModel(compute_dtype=torch.float32)
    model.load_state_dict(start)
    runner = MeshRunner(make_mesh((4,), ("dp",), [torch.device("cpu")] * 4))
    state = runner.init_state(model, twin.optimizer(lr=LR))
    step = runner.train_step(twin.loss)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    one = {k: v.detach().numpy() for k, v in model.state_dict().items()}

    res = _results(_run_pair(tmp_path, _MNIST, extra_args=(str(LR),)))
    assert res[0]["losses"] == res[1]["losses"]
    np.testing.assert_allclose(res[0]["losses"], losses, rtol=1e-4)
    np.testing.assert_allclose(res[0]["losses"], jlosses, rtol=1e-4)
    begin = {k: v.numpy() for k, v in start.items()}
    outs = [torch.load(tmp_path / f"mnist_out{pid}.pt") for pid in (0, 1)]
    for key in one:
        np.testing.assert_array_equal(outs[0][key].numpy(),
                                      outs[1][key].numpy(), err_msg=key)
    got = {k: v.numpy() for k, v in outs[0].items()}

    def change(tree):
        return {k: np.asarray(tree[k], np.float64) - begin[k] for k in begin
                if not k.endswith(("mean", "var"))}

    def stats(tree):
        return {k: np.asarray(tree[k]) for k in begin
                if k.endswith(("mean", "var"))}

    _close(change(got), change(one))
    _close(change(got), change({k: v.numpy() for k, v in jax_final.items()}))
    _close(stats(got), stats(one))
    _close(stats(got), stats({k: v.numpy() for k, v in jax_final.items()}))


# ---- (d) the job -----------------------------------------------------------

_JOB = """
    import time
    from elasticdl_tpu_torch.common.args import parse_worker_args
    from elasticdl_tpu_torch.worker.main import build_worker

    zoo = sys.argv[4]
    port_file = os.path.join(data, "master_port")
    server = dispatcher = eval_service = None
    if pid == 0:
        from elasticdl_tpu_torch.comm.rpc import RpcServer
        from elasticdl_tpu_torch.core.model_spec import get_model_spec
        from elasticdl_tpu_torch.data.factory import create_data_reader
        from elasticdl_tpu_torch.master.evaluation_service import (
            EvaluationService,
        )
        from elasticdl_tpu_torch.master.servicer import (
            SERVICE_NAME, MasterServicer,
        )
        from elasticdl_tpu_torch.master.task_dispatcher import (
            TaskDispatcher,
        )

        spec = get_model_spec(zoo, "mnist.mnist_functional.custom_model",
                              device="cpu")
        dispatcher = TaskDispatcher(
            training_shards=create_data_reader(
                os.path.join(data, "train.rec")).create_shards(),
            evaluation_shards=create_data_reader(
                os.path.join(data, "eval.rec")).create_shards(),
            records_per_task=32, num_epochs=1)
        eval_service = EvaluationService(dispatcher, spec.eval_metrics_fn(),
                                         eval_steps=3)
        servicer = MasterServicer(dispatcher, eval_service)
        server = RpcServer("localhost:0",
                           {SERVICE_NAME: servicer.handlers()}).start()
        with open(port_file + ".tmp", "w") as f:
            f.write(str(server.port))
        os.replace(port_file + ".tmp", port_file)
    deadline = time.time() + 60
    while not os.path.exists(port_file) and time.time() < deadline:
        time.sleep(0.05)
    with open(port_file) as f:
        master_port = f.read()
    args = parse_worker_args([
        "--worker_id", str(pid), "--model_zoo", zoo,
        "--model_def", "mnist.mnist_functional.custom_model",
        "--training_data", os.path.join(data, "train.rec"),
        "--minibatch_size", "16", "--device", "cpu",
        "--master_addr", f"localhost:{master_port}",
        "--distribution_strategy", "MeshStrategy", "--mesh_shape", "2",
        "--mesh_axes", "dp", "--num_jax_processes", "2",
        "--coordinator_addr", store, "--jax_process_id", str(pid)])
    worker = build_worker(args)
    assert worker._step_runner.mesh.spans_processes
    result = worker.run()
    print("RESULT " + json.dumps({
        "pid": pid, "version": result["final_version"],
        "batches": result["trained_batches"],
        "loss": result["final_loss"]}), flush=True)
    if pid == 0:
        deadline = time.time() + 60
        while not dispatcher.finished() and time.time() < deadline:
            time.sleep(0.2)
        print("MASTER " + json.dumps({
            "finished": dispatcher.finished(),
            "evals": len(eval_service.completed_results)}), flush=True)
        server.stop(0)
    multihost.shutdown()
"""


def test_two_process_job_with_eval_through_worker_main(tmp_path):
    import json

    from elasticdl_tpu_torch.testing.data import (
        create_mnist_record_file,
        model_zoo_dir,
    )

    create_mnist_record_file(str(tmp_path / "train.rec"), 192, seed=1)
    create_mnist_record_file(str(tmp_path / "eval.rec"), 32, seed=2)
    outputs = _run_pair(tmp_path, _JOB, extra_args=(model_zoo_dir(),))
    res = _results(outputs)
    master = [json.loads(line[len("MASTER "):]) for out in outputs
              for line in out.splitlines() if line.startswith("MASTER ")]
    assert master and master[0]["finished"] and master[0]["evals"] >= 1
    # One global state: both processes end at the same version.
    assert res[0]["version"] == res[1]["version"] >= 1
    assert np.isfinite(res[0]["loss"]) and np.isfinite(res[1]["loss"])
    # Every training batch trained once, split between the workers
    # (12 batches of 16 over 192 records).
    assert res[0]["batches"] + res[1]["batches"] == 12

