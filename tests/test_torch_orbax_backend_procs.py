"""Multi-host checkpoints across two processes of the port
(``checkpoint/orbax_backend``, ``torch.distributed.checkpoint``) on the
CPU over gloo, wired by a ``FileStore`` under ``tmp_path``, each
subprocess under a time limit that kills both.

- The f32 transformer on a (1, 2, 2) mesh with ``tp`` across the
  processes (each holds half of every tp-split kernel and of its ZeRO
  slots): every process saves through ``CheckpointHook(backend=
  "orbax")``, then restores into a fresh state of the same layout and
  of another (``sp`` across instead), bit-equal; process 0 alone
  restores the same version onto an unplaced model, bit-equal to the
  gathered state; a run resumed from the checkpoint takes two more
  steps bit-equal to the unbroken run's.
- A device-sparse state whose table (64 x 16, and its Adagrad slot
  table) is row-split over a dp4 mesh of two entries a process: each
  process writes its rows (``ShardedTensor`` parts); restored bit-equal
  onto the same layout, onto dp2 (one entry a process, rows in halves),
  and by process 0 alone onto one unsharded state.
- The MoE transformer with ``ep`` across the processes (each holds two
  of the four experts, their hidden dim split over its two local ``tp``
  entries: a leaf split over two dims): restored bit-equal onto the
  same layout, onto ``tp`` across instead (every expert, half of its
  hidden dim), and by process 0 alone onto an unplaced model.
- A job through ``worker.main.build_worker`` with ``--checkpoint_dir``
  (mnist over dp across the processes, the master in process 0): the
  newest version is the final version in both processes
  (tests/test_multihost_job.py:180 in JAX), and a second job with
  ``--checkpoint_dir_for_init`` in the same processes resumes at it.
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
TIMEOUT_S = 150
CPU = torch.device("cpu")
LM_CFG = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_len=32)

_PRELUDE = """
    import json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(2)
    sys.path.insert(0, {repo!r})
    sys.path.insert(0, os.path.dirname({test!r}))
    from elasticdl_tpu_torch.parallel import multihost
    pid = int(sys.argv[1]); store = sys.argv[2]; data = sys.argv[3]
"""


MOE_CFG = dict(LM_CFG, moe_experts=4, moe_every=2, moe_dispatch="dense")
SPARSE_BATCH = 8


class TinySparse(torch.nn.Module):
    """One sparse feature through a 16-wide table, then two dense
    layers."""

    def __init__(self):
        from elasticdl_tpu_torch.embedding.device_sparse import SparseEmbed

        super().__init__()
        self.emb = SparseEmbed("items", 16)
        self.layers = torch.nn.ModuleList([torch.nn.Linear(16, 8),
                                           torch.nn.Linear(8, 1)])

    def forward(self, features, sparse_emb=None):
        x = torch.relu(self.layers[0](self.emb(sparse_emb)))
        return self.layers[1](x)[..., 0]


def _sparse_batch(step, pid=None):
    """Global batch ``step`` (ids in [0, 64)), or process ``pid``'s half
    of its rows."""
    rng = np.random.RandomState(100 + step)
    batch = {"features": {"ids": rng.randint(0, 64, (SPARSE_BATCH, 3))},
             "labels": rng.randint(0, 2, (SPARSE_BATCH,)).astype(
                 np.float32),
             "mask": np.ones((SPARSE_BATCH,), np.float32)}
    if pid is None:
        return batch
    rows = slice(pid * SPARSE_BATCH // 2, (pid + 1) * SPARSE_BATCH // 2)
    return {"features": {"ids": batch["features"]["ids"][rows]},
            "labels": batch["labels"][rows], "mask": batch["mask"][rows]}


def sparse_state(mesh, seed=0, steps=0, pid=None):
    """A ``DeviceSparseRunner`` state of ``TinySparse`` with Adagrad
    rows, its table row-split over ``mesh`` (None: whole), trained
    ``steps`` steps (on process ``pid``'s rows where the mesh spans
    processes)."""
    from elasticdl_tpu_torch.embedding.device_sparse import (
        DeviceSparseRunner,
        TableSpec,
    )
    from elasticdl_tpu_torch.embedding.optimizer import Adagrad
    from elasticdl_tpu_torch.ops.losses import masked_sigmoid_cross_entropy

    runner = DeviceSparseRunner(
        (TableSpec("items", vocab=64, dim=16, feature_key="ids"),),
        Adagrad(lr=0.05), mesh=mesh, partition_threshold_bytes=0)
    torch.manual_seed(seed)
    state = runner.init_state(TinySparse(),
                              lambda p: torch.optim.Adam(p, lr=1e-2),
                              _sparse_batch(0, pid), seed=seed)
    step = runner.train_step(masked_sigmoid_cross_entropy)
    for i in range(steps):
        state, _ = step(state, _sparse_batch(i, pid))
    return state


def _lm_batch(seed):
    rng = np.random.RandomState(seed)
    seq = (rng.randint(0, 32, (4, 1)) + np.arange(17)[None, :]) % 32
    return {"features": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32),
            "mask": np.ones((4,), np.float32)}


def lm_state(axes, init, seed=0, devices=2, cfg=LM_CFG):
    """A MeshRunner state of the f32 transformer (``cfg``) on (1, 2, 2)
    over ``axes``, with ``init`` loaded (None: drawn from ``seed``)."""
    from elasticdl_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        transformer_sharding_rules,
    )
    from elasticdl_tpu_torch.ops.losses import (
        masked_next_token_cross_entropy,
    )
    from elasticdl_tpu_torch.parallel import rules
    from elasticdl_tpu_torch.parallel.mesh import make_mesh
    from elasticdl_tpu_torch.parallel.mesh_runner import MeshRunner

    mesh = make_mesh((1, 2, 2), axes, [CPU] * devices)
    torch.manual_seed(seed)
    model = TransformerLM(TransformerConfig(compute_dtype=torch.float32,
                                            **cfg), mesh=mesh)
    if init is not None:
        model.load_state_dict(init)
    runner = MeshRunner(mesh, param_rule=rules.regex_param_rule(
        transformer_sharding_rules(), mesh=mesh),
        batch_rule=lambda path, leaf: rules.PartitionSpec(
            "dp", "sp") if getattr(leaf, "ndim", 0) == 2
        else rules.PartitionSpec("dp"))
    state = runner.init_state(model, lambda p: torch.optim.Adam(
        p, lr=1e-2), seed=0)
    step = runner.train_step(masked_next_token_cross_entropy)
    return runner, state, step


def whole_leaves(state):
    """Every leaf of ``state`` whole on the host: the native capture,
    with each parameter held as its process's block gathered."""
    from elasticdl_tpu_torch.checkpoint.state_io import (
        named_leaves_from_state,
    )
    from elasticdl_tpu_torch.common import dtypes

    out = named_leaves_from_state(state)
    for prefix, module in state.model.named_modules():
        for leaf, sharding in module.__dict__.get("_placed", {}).items():
            if sharding.spans_processes:
                whole = sharding.gather_block(getattr(module, leaf).detach())
                name = f"params.{prefix}.{leaf}" if prefix else (
                    f"params.{leaf}")
                out[name] = (dtypes.bf16_to_numpy(whole)
                             if whole.dtype == torch.bfloat16
                             else whole.numpy())
    return out


_ROUNDTRIP = """
    from elasticdl_tpu_torch.checkpoint import CheckpointHook, restore_from_dir
    from elasticdl_tpu_torch.checkpoint.orbax_backend import (
        OrbaxSaver, restore_state)
    from elasticdl_tpu_torch.checkpoint.state_io import (
        named_leaves_from_state)
    from elasticdl_tpu_torch.core.train_state import init_train_state
    from elasticdl_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    import test_torch_orbax_backend_procs as case

    multihost.initialize_multihost(store, 2, pid, device="cpu")
    init = torch.load(os.path.join(data, "init.pt"))
    TP, SP = ("dp", "tp", "sp"), ("dp", "sp", "tp")
    ckpt = os.path.join(data, "ckpt")
    runner, state, step = case.lm_state(TP, init)
    for i in range(2):
        state, _ = step(state, runner.place_batch(case._lm_batch(i)))
    hook = CheckpointHook(ckpt, checkpoint_steps=2, backend="orbax")
    hook.maybe_save(state)
    hook.flush()
    want = case.whole_leaves(state)
    split = sum(p.shape[0] < want["params." + n].shape[0]
                for n, p in state.model.named_parameters())

    def same(got):
        assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
        for name, value in want.items():
            np.testing.assert_array_equal(got[name], value, err_msg=name)

    _, fresh, fresh_step = case.lm_state(TP, None, seed=5)
    fresh = restore_from_dir(fresh, ckpt)
    same(case.whole_leaves(fresh))
    _, other, _ = case.lm_state(SP, None, seed=6)
    same(case.whole_leaves(restore_from_dir(other, ckpt)))
    if pid == 0:
        torch.manual_seed(9)
        plain = init_train_state(
            TransformerLM(TransformerConfig(compute_dtype=torch.float32,
                                            **case.LM_CFG)),
            lambda p: torch.optim.Adam(p, lr=1e-2))
        same(named_leaves_from_state(restore_state(
            OrbaxSaver(ckpt, collective=False), plain)))
    # The resumed run against the unbroken one.
    for i in range(2, 4):
        batch = runner.place_batch(case._lm_batch(i))
        state, _ = step(state, batch)
        fresh, _ = fresh_step(fresh, batch)
    unbroken = case.whole_leaves(state)
    resumed = case.whole_leaves(fresh)
    for name, value in unbroken.items():
        np.testing.assert_array_equal(resumed[name], value, err_msg=name)
    print("RESULT " + json.dumps({
        "pid": pid, "split": int(split), "step": int(fresh.step),
        "versions": OrbaxSaver(ckpt, collective=False).versions()}),
        flush=True)
"""


_SPLIT = """
    from elasticdl_tpu_torch.checkpoint.orbax_backend import (
        OrbaxSaver, restore_state, save_state)
    from elasticdl_tpu_torch.checkpoint.state_io import (
        named_leaves_from_state)
    from elasticdl_tpu_torch.core.train_state import init_train_state
    from elasticdl_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from elasticdl_tpu_torch.parallel.mesh import make_mesh
    import test_torch_orbax_backend_procs as case

    multihost.initialize_multihost(store, 2, pid, device="cpu")
    kind = sys.argv[4]
    ckpt = os.path.join(data, "ckpt")
    cpu = [torch.device("cpu")] * 2
    if kind == "table":
        state = case.sparse_state(make_mesh((4,), ("dp",), cpu), steps=2,
                                  pid=pid)
        leaf = state.tables["items"]
        held = [list(s.shape) for s in leaf.shards]
        spans = leaf.sharding.spans_processes
        want = named_leaves_from_state(state)
        targets = [
            lambda: case.sparse_state(make_mesh((4,), ("dp",), cpu), seed=5),
            lambda: case.sparse_state(make_mesh((2,), ("dp",), cpu[:1]),
                                      seed=6)]
        whole = named_leaves_from_state

        def unsharded():
            return case.sparse_state(None, seed=7)
    else:
        EP, TP = ("dp", "ep", "tp"), ("dp", "tp", "ep")
        init = torch.load(os.path.join(data, "init.pt"))
        runner, state, step = case.lm_state(EP, init, cfg=case.MOE_CFG)
        for i in range(2):
            state, _ = step(state, runner.place_batch(case._lm_batch(i)))
        wi = state.model.blocks[1].moe.wi
        held = [list(wi.shape)]
        spans = wi.shape[0] < case.MOE_CFG["moe_experts"]
        want = case.whole_leaves(state)
        targets = [
            lambda: case.lm_state(EP, None, seed=5, cfg=case.MOE_CFG)[1],
            lambda: case.lm_state(TP, None, seed=6, cfg=case.MOE_CFG)[1]]
        whole = case.whole_leaves

        def unsharded():
            torch.manual_seed(9)
            return init_train_state(
                TransformerLM(TransformerConfig(compute_dtype=torch.float32,
                                                **case.MOE_CFG)),
                lambda p: torch.optim.Adam(p, lr=1e-2))
    saver = OrbaxSaver(ckpt)
    save_state(saver, state)
    saver.wait()

    def same(got):
        assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
        for name, value in want.items():
            np.testing.assert_array_equal(got[name], value, err_msg=name)

    for make in targets:
        same(whole(restore_state(OrbaxSaver(ckpt), make())))
    if pid == 0:
        same(named_leaves_from_state(restore_state(
            OrbaxSaver(ckpt, collective=False), unsharded())))
    print("RESULT " + json.dumps({
        "pid": pid, "held": held, "spans": bool(spans),
        "restored": len(targets) + (pid == 0)}), flush=True)
"""


_JOB = """
    import time
    from elasticdl_tpu_torch.common.args import parse_worker_args
    from elasticdl_tpu_torch.worker.main import build_worker

    zoo = sys.argv[4]
    ckpt = os.path.join(data, "ckpt")

    def master(tag, train):
        from elasticdl_tpu_torch.comm.rpc import RpcServer
        from elasticdl_tpu_torch.data.factory import create_data_reader
        from elasticdl_tpu_torch.master.evaluation_service import (
            EvaluationService)
        from elasticdl_tpu_torch.master.servicer import (
            SERVICE_NAME, MasterServicer)
        from elasticdl_tpu_torch.master.task_dispatcher import (
            TaskDispatcher)

        dispatcher = TaskDispatcher(
            training_shards=create_data_reader(train).create_shards(),
            evaluation_shards={}, records_per_task=32, num_epochs=1)
        servicer = MasterServicer(dispatcher,
                                  EvaluationService(dispatcher, {}))
        server = RpcServer("localhost:0",
                           {SERVICE_NAME: servicer.handlers()}).start()
        port_file = os.path.join(data, f"port_{tag}")
        with open(port_file + ".tmp", "w") as f:
            f.write(str(server.port))
        os.replace(port_file + ".tmp", port_file)
        return dispatcher, server

    def run(tag, train, extra):
        server = dispatcher = None
        if pid == 0:
            dispatcher, server = master(tag, train)
        port_file = os.path.join(data, f"port_{tag}")
        deadline = time.time() + 60
        while not os.path.exists(port_file) and time.time() < deadline:
            time.sleep(0.05)
        with open(port_file) as f:
            port = f.read()
        args = parse_worker_args([
            "--worker_id", str(pid), "--model_zoo", zoo,
            "--model_def", "mnist.mnist_functional.custom_model",
            "--training_data", train, "--minibatch_size", "16",
            "--device", "cpu", "--master_addr", f"localhost:{port}",
            "--distribution_strategy", "MeshStrategy", "--mesh_shape", "4",
            "--mesh_axes", "dp", "--num_jax_processes", "2",
            "--coordinator_addr", store, "--jax_process_id", str(pid),
            *extra])
        worker = build_worker(args)
        result = worker.run()
        if pid == 0:
            deadline = time.time() + 60
            while not dispatcher.finished() and time.time() < deadline:
                time.sleep(0.2)
            server.stop(0)
        return result

    first = run("a", os.path.join(data, "train.rec"),
                ["--checkpoint_dir", ckpt, "--checkpoint_steps", "4"])
    from elasticdl_tpu_torch.checkpoint.orbax_backend import OrbaxSaver

    versions = OrbaxSaver(ckpt, collective=False).versions()
    second = run("b", os.path.join(data, "more.rec"),
                 ["--checkpoint_dir_for_init", ckpt])
    print("RESULT " + json.dumps({
        "pid": pid, "first": first["final_version"],
        "batches": first["trained_batches"], "versions": versions,
        "second": second["final_version"],
        "second_batches": second["trained_batches"]}), flush=True)
    multihost.shutdown()
"""


def _run_pair(tmp_path, body, extra_args=()):
    script = tmp_path / "proc.py"
    script.write_text(textwrap.dedent(_PRELUDE.format(
        repo=REPO, test=os.path.abspath(__file__))) + textwrap.dedent(body))
    store = f"file://{tmp_path / 'store'}"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), store, str(tmp_path),
         *extra_args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
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
        pytest.fail("two-process checkpoint run hung (a collective)")
    found = {}
    for pid, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"process {pid}:\n{out}"
        for line in out.splitlines():
            if line.startswith("RESULT "):
                res = json.loads(line[len("RESULT "):])
                found[res["pid"]] = res
    assert sorted(found) == [0, 1], outputs
    return found


def test_two_processes_save_and_restore_onto_any_layout(tmp_path):
    from elasticdl_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )

    torch.manual_seed(11)
    torch.save(TransformerLM(TransformerConfig(
        compute_dtype=torch.float32, **LM_CFG)).state_dict(),
        tmp_path / "init.pt")
    res = _run_pair(tmp_path, _ROUNDTRIP)
    # tp across: each process held blocks of the split kernels.
    assert res[0]["split"] == res[1]["split"] > 0
    assert res[0]["versions"] == [2]
    assert res[0]["step"] == res[1]["step"] == 4
    files = sorted(os.listdir(tmp_path / "ckpt" / "orbax-2"))
    # Each process wrote its own parts, and the coordinator the index.
    assert ".metadata" in files and len(
        [f for f in files if f.endswith(".distcp")]) == 2


@pytest.mark.parametrize("kind", ["table", "moe"])
def test_two_processes_restore_split_leaves_onto_any_layout(tmp_path, kind):
    from elasticdl_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )

    torch.manual_seed(13)
    torch.save(TransformerLM(TransformerConfig(
        compute_dtype=torch.float32, **MOE_CFG)).state_dict(),
        tmp_path / "init.pt")
    res = _run_pair(tmp_path, _SPLIT, extra_args=(kind,))
    assert res[0]["spans"] and res[1]["spans"]
    # Each process held and wrote only its part of the split leaves.
    want = ([[16, 16], [16, 16]] if kind == "table"
            else [[2, MOE_CFG["d_model"], MOE_CFG["d_ff"]]])
    assert res[0]["held"] == res[1]["held"] == want
    assert [res[0]["restored"], res[1]["restored"]] == [3, 2]
    files = os.listdir(tmp_path / "ckpt" / "orbax-2")
    assert len([f for f in files if f.endswith(".distcp")]) == 2


def test_two_process_job_checkpoints_and_resumes(tmp_path):
    from elasticdl_tpu_torch.testing.data import (
        create_mnist_record_file,
        model_zoo_dir,
    )

    create_mnist_record_file(str(tmp_path / "train.rec"), 160, seed=1)
    create_mnist_record_file(str(tmp_path / "more.rec"), 64, seed=2)
    res = _run_pair(tmp_path, _JOB, extra_args=(model_zoo_dir(),))
    first = res[0]["first"]
    assert res[1]["first"] == first >= 1
    # Every batch trained once, split between the processes.
    assert res[0]["batches"] + res[1]["batches"] == 160 // 16
    # The newest version is the final one (interval 4, then the final
    # save), in both processes' view of the one directory.
    assert res[0]["versions"][-1] == first
    assert res[0]["versions"] == res[1]["versions"]
    # The second job resumed at the first job's final version.
    assert res[0]["second"] == res[1]["second"] > first
    steps = res[0]["second"] - first
    assert steps >= (res[0]["second_batches"] + res[1]["second_batches"]) // 2
