"""The port's multi-host helpers (elasticdl_tpu_torch/parallel/
multihost.py) against the JAX package's in one process: the eight cases
of tests/test_multihost.py, each function of the port held to its JAX
counterpart on the same numpy inputs.

JAX runs on the conftest's virtual CPU devices, the port on ``[cpu] *
n`` meshes. One process is the no-op case of both packages: nothing is
initialised, the barrier returns its own code, a batch is placed as it
is. Every comparison is exact (no arithmetic happens): equal arrays,
dtypes and codes. The two-process runs are in
tests/test_torch_multihost_procs.py.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JaxSharding
from jax.sharding import PartitionSpec as JP

from elasticdl_tpu.parallel import multihost as jmh
from elasticdl_tpu.parallel.mesh import make_mesh as jax_mesh
from elasticdl_tpu.parallel.mesh_runner import MeshRunner as JaxRunner
from elasticdl_tpu_torch.parallel import mesh as tmesh
from elasticdl_tpu_torch.parallel import multihost as tmh
from elasticdl_tpu_torch.parallel.mesh_runner import MeshRunner
from elasticdl_tpu_torch.parallel.rules import PartitionSpec

CPU = torch.device("cpu")


def _meshes(n):
    return (jax_mesh((n,), ("dp",), devices=jax.devices()[:n]),
            tmesh.make_mesh((n,), ("dp",), [CPU] * n))


def test_initialize_noop_single_process():
    for mh in (jmh, tmh):
        assert not mh.initialize_multihost("ignored:1234", 1, 0)
        assert mh.process_count() == 1
        assert mh.process_index() == 0
    assert tmh.data_backend() is None
    assert not tmesh.make_mesh((2,), ("dp",), [CPU] * 2).spans_processes


def test_coordinator_from_args():
    class Single:
        coordinator_addr = ""
        num_jax_processes = 1

    class Explicit:
        coordinator_addr = "10.0.0.5:4444"

    class MultiNoAddr:
        coordinator_addr = ""
        num_jax_processes = 4

    for args in (Single(), Explicit()):
        assert (tmh.coordinator_from_args(args)
                == jmh.coordinator_from_args(args))
    assert tmh.coordinator_from_args(Explicit()) == "10.0.0.5:4444"
    for mh in (jmh, tmh):
        with pytest.raises(ValueError, match="coordinator_addr"):
            mh.coordinator_from_args(MultiNoAddr())


def test_exchange_continue_single_process():
    jm, tm = _meshes(4)
    for flag in (True, False):
        assert (tmh.exchange_continue(tm, "dp", flag)
                is jmh.exchange_continue(jm, "dp", flag) is flag)
    for code in (tmh.STEP_DONE, tmh.STEP_IDLE, tmh.STEP_TRAIN,
                 tmh.STEP_FORWARD):
        assert tmh.exchange_code(tm, code) == jmh.exchange_code(jm, code)
    assert ((tmh.STEP_DONE, tmh.STEP_IDLE, tmh.STEP_TRAIN,
             tmh.STEP_FORWARD)
            == (jmh.STEP_DONE, jmh.STEP_IDLE, jmh.STEP_TRAIN,
                jmh.STEP_FORWARD))
    assert tmh.host_sum(2.5) == 2.5


def test_zero_mask_like():
    batch = {
        "features": np.ones((4, 3), np.float32),
        "labels": np.ones((4,), np.int32),
        "mask": np.ones((4,), np.float32),
    }
    got, want = tmh.zero_mask_like(batch), jmh.zero_mask_like(batch)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == want[key].dtype
    assert got["mask"].sum() == 0
    # A sparse model's nested features (the recsys ranker's {"ids"}).
    nested = tmh.zero_mask_like({"features": {"ids": np.ones((4, 2),
                                                             np.int32)},
                                 "mask": np.ones(4, np.float32)})
    assert nested["features"]["ids"].dtype == np.int32
    assert not nested["features"]["ids"].any()


def test_host_local_slice_dedups_replicated():
    jm, tm = _meshes(4)
    value = np.arange(6, dtype=np.float32).reshape(3, 2)
    want = jmh.host_local_slice(jax.device_put(value, JaxSharding(jm, JP())))
    sharded = tmesh.ShardedTensor.from_whole(
        tmesh.NamedSharding(tm, PartitionSpec()), torch.from_numpy(value))
    np.testing.assert_array_equal(tmh.host_local_slice(sharded).numpy(),
                                  want)
    # A tensor is this process's rows already.
    plain = torch.from_numpy(value)
    assert tmh.host_local_slice(plain) is plain


def test_make_global_batch_single_process():
    jm, tm = _meshes(4)
    batch = {
        "features": np.arange(32, dtype=np.float32).reshape(8, 4),
        "mask": np.ones((8,), np.float32),
    }
    shardings = jax.tree.map(lambda _: JaxSharding(jm, JP("dp")), batch)
    want = jmh.make_global_batch(batch, jm, shardings)
    got = tmh.make_global_batch(batch, tm)
    for key in batch:
        assert isinstance(got[key], torch.Tensor)
        assert got[key].device == tm.device
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    assert tmh.global_batch_size(8) == jmh.global_batch_size(8) == 8


def test_host_local_slice_roundtrip():
    jm, tm = _meshes(4)
    value = np.arange(16, dtype=np.float32).reshape(8, 2)
    want = jmh.host_local_slice(jax.device_put(value,
                                               JaxSharding(jm, JP("dp"))))
    sharded = tmesh.ShardedTensor.from_whole(
        tmesh.batch_sharding(tm), torch.from_numpy(value))
    assert len(sharded.shards) == 4
    np.testing.assert_array_equal(tmh.host_local_slice(sharded).numpy(),
                                  want)
    np.testing.assert_array_equal(want, value)
    across = tmesh.ShardedTensor.from_whole(
        tmesh.NamedSharding(tm, PartitionSpec(None, "dp")),
        torch.zeros(2, 8))
    with pytest.raises(ValueError, match="leading-dim"):
        tmh.host_local_slice(across)


def test_mesh_runner_place_batch_goes_through_multihost(monkeypatch):
    """place_batch routes through make_global_batch (single process:
    the values unchanged, on the mesh's device), as the JAX runner's
    does."""
    jm, tm = jax_mesh((8,), ("dp",), devices=jax.devices()[:8]), \
        tmesh.make_mesh((8,), ("dp",), [CPU] * 8)
    batch = {
        "features": np.random.rand(16, 4).astype(np.float32),
        "labels": np.zeros((16,), np.int32),
        "mask": np.ones((16,), np.float32),
    }
    want = JaxRunner(mesh=jm).place_batch(batch)
    calls = []
    real = tmh.make_global_batch
    monkeypatch.setattr(tmh, "make_global_batch",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    runner = MeshRunner(tm)
    placed = runner.place_batch(batch)
    assert len(calls) == 1 and calls[0][1] is tm
    assert runner.batch_shardings(batch)["features"].spec == \
        PartitionSpec("dp")
    assert want["features"].sharding.spec == JP("dp")
    for key in batch:
        np.testing.assert_array_equal(placed[key].numpy(),
                                      np.asarray(want[key]))
    runner.place_task({k: v[None] for k, v in batch.items()})
    assert len(calls) == 2


def test_initialize_multihost_without_cuda_raises(monkeypatch):
    """Several processes and no device asked for on a host without a
    card: RuntimeError before any process group exists (the CPU is had
    only by ``device="cpu"``)."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmh.initialize_multihost("localhost:1", 2, 0)
    assert not dist.is_initialized()
    assert tmh.process_count() == 1 and tmh.data_backend() is None


def _mnist_state(mesh):
    from elasticdl_tpu_torch.model_zoo.mnist import mnist_functional as twin

    torch.manual_seed(0)
    return MeshRunner(mesh).init_state(twin.custom_model(device=CPU),
                                       twin.optimizer(lr=0.1))


def test_attach_is_local_on_one_process():
    """A mesh of one process gives the state and its layers no global
    batch: no global rows for dropout, no collective for the loss or the
    statistics."""
    _, tm = _meshes(2)
    state = _mnist_state(tm)
    assert state.global_batch is None
    layers = [m for m in state.model.modules() if hasattr(m, "global_batch")]
    assert layers and all(m.global_batch is None for m in layers)


def test_attach_gives_every_layer_the_global_batch():
    """A mesh that spans processes: the state and every layer that reads
    the global batch (each BatchNorm, the transformer's blocks) share
    one ``GlobalBatch``; its rows are this process's of the global
    batch."""
    from elasticdl_tpu_torch.models.transformer import Block, TransformerConfig

    class Spanning:
        spans_processes = True

    state = _mnist_state(_meshes(2)[1])
    state.model.add_module("block", Block(TransformerConfig(
        vocab_size=8, d_model=8, n_heads=2, n_layers=1, d_ff=16,
        max_len=4)))
    tmh.attach(state, Spanning())
    hook = state.global_batch
    assert isinstance(hook, tmh.GlobalBatch)
    layers = [m for m in state.model.modules() if hasattr(m, "global_batch")]
    assert len(layers) == 2 and all(m.global_batch is hook for m in layers)
    assert hook.rows(4) == (4 * tmh.process_count(),
                            4 * tmh.process_index())
    tmh.attach(state, None)
    assert all(m.global_batch is None for m in layers)
    state.model.add_module("torch_bn", torch.nn.BatchNorm1d(4))
    with pytest.raises(NotImplementedError, match="BatchNorm1d"):
        tmh.attach(state, Spanning())
    assert state.global_batch is None


def test_dropout_draws_the_global_batch_and_keeps_its_rows():
    """Process 1 of 2 (a stand-in ``GlobalBatch`` on one process): its
    dropout mask is rows 4-7 of the one-process draw over the global
    batch of 8, from the same generator state."""
    from elasticdl_tpu_torch.models.transformer import dropout

    class SecondOfTwo(tmh.GlobalBatch):
        def __init__(self):
            self.count, self.index = 2, 1

    x = torch.ones(8, 3, 5)
    whole = dropout(x, 0.5, torch.Generator().manual_seed(7))
    local = dropout(x[:4], 0.5, torch.Generator().manual_seed(7),
                    SecondOfTwo())
    torch.testing.assert_close(local, whole[4:], rtol=0, atol=0)
    assert not torch.equal(whole[:4], whole[4:])
