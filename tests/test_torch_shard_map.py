"""The port's shard map (``embedding/shard_map.py``) against the JAX
package's, on the CPU: the same seeded ids and the same sequence of
moves give the same buckets, homes, ranges and JSON, byte for byte (a
port client and a JAX service exchange maps in ``get_shard_map`` and in
a REDIRECT).
"""

import json

import numpy as np
import pytest

from elasticdl_tpu.embedding import shard_map as jsm
from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.embedding import shard_map as psm


def _same(port_map, jax_map):
    want = jax_map.to_json()
    got = port_map.to_json()
    assert got == want
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                          sort_keys=True)
    assert psm.dump_map(port_map) == jsm.dump_map(jax_map)
    assert tensor_utils.dumps(got) == tensor_utils.dumps(want)
    np.testing.assert_array_equal(port_map.owner_table,
                                  jax_map.owner_table)


def test_bucket_of_matches_jax():
    rng = np.random.RandomState(0)
    ids = np.concatenate([
        rng.randint(-2**40, 2**40, 4096),
        np.arange(-10, 10), [0, psm.NUM_BUCKETS - 1, psm.NUM_BUCKETS,
                             2**62],
    ]).astype(np.int64)
    assert psm.NUM_BUCKETS == jsm.NUM_BUCKETS
    np.testing.assert_array_equal(psm.bucket_of(ids), jsm.bucket_of(ids))
    assert psm.bucket_of(ids).min() >= 0


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7])
def test_bootstrap_and_homes_match_jax(n):
    addrs = [f"localhost:{6100 + s}" for s in range(n)]
    pm, jm = psm.ShardMap.bootstrap(addrs), jsm.ShardMap.bootstrap(addrs)
    _same(pm, jm)
    ids = np.random.RandomState(n).randint(0, 10**9, 2048)
    np.testing.assert_array_equal(pm.home_of_ids(ids), jm.home_of_ids(ids))
    for s in range(n):
        np.testing.assert_array_equal(pm.owns(s, ids), jm.owns(s, ids))
        assert pm.ranges_of(s) == jm.ranges_of(s)
        assert pm.buckets_owned(s) == jm.buckets_owned(s)


def _moves(rng, steps):
    """A seeded script of moves valid on both packages' maps."""
    script = []
    shards = 2
    for _ in range(steps):
        kind = rng.choice(["range", "shard", "add", "replicas", "split"])
        if kind == "range":
            lo = int(rng.randint(0, psm.NUM_BUCKETS - 1))
            hi = int(rng.randint(lo + 1, psm.NUM_BUCKETS + 1))
            script.append(("move_range", lo, hi,
                           int(rng.randint(0, shards))))
        elif kind == "shard":
            script.append(("move_shard", int(rng.randint(0, shards)),
                           int(rng.randint(0, shards))))
        elif kind == "add":
            script.append(("add_shard", f"localhost:{7000 + shards}"))
            shards += 1
        elif kind == "replicas":
            ids = rng.randint(0, 10**6, 3)
            script.append(("with_replicas", {
                "items": {int(i): (int(rng.randint(0, shards)),)
                          for i in ids}}))
        else:
            script.append(("split", int(rng.randint(0, shards))))
    return script


def _apply(m, move):
    name, *args = move
    if name == "split":
        try:
            mid, hi = m.split_plan(args[0])
        except ValueError as exc:
            return m, type(exc).__name__
        return m.move_range(mid, hi, len(m.shards) - 1), (mid, hi)
    return getattr(m, name)(*args), None


@pytest.mark.parametrize("seed", range(4))
def test_move_algebra_matches_jax(seed):
    addrs = ["localhost:7000", "localhost:7001"]
    pm, jm = psm.ShardMap.bootstrap(addrs), jsm.ShardMap.bootstrap(addrs)
    ids = np.random.RandomState(seed + 100).randint(0, 10**9, 512)
    for move in _moves(np.random.RandomState(seed), 12):
        pm, p_note = _apply(pm, move)
        jm, j_note = _apply(jm, move)
        assert p_note == j_note
        _same(pm, jm)
        np.testing.assert_array_equal(pm.home_of_ids(ids),
                                      jm.home_of_ids(ids))
        for row_id in ids[:8]:
            assert pm.replica_targets("items", row_id) == \
                jm.replica_targets("items", row_id)
    # A merged-away shard retires identically.
    pm = pm.with_replicas({}).move_shard(0, 1)
    jm = jm.with_replicas({}).move_shard(0, 1)
    _same(pm.retire_shard(0), jm.retire_shard(0))


def test_json_crosses_both_ways():
    base = jsm.ShardMap.bootstrap(["a:1", "b:2", "c:3"])
    jm = base.move_range(100, 900, 2).with_replicas(
        {"t": {7: (0, 1)}, "u": {3: (2,)}})
    pm = psm.ShardMap.from_json(jm.to_json())
    _same(pm, jm)
    back = jsm.ShardMap.from_json(pm.to_json())
    assert back == jm
    # Through the RPC codec, as a REDIRECT carries it.
    wire = tensor_utils.loads(tensor_utils.dumps(pm.to_json()))
    _same(psm.ShardMap.from_json(wire), jm)


@pytest.mark.parametrize("bad", [
    dict(version=0, shards=["a"], ranges=[(0, psm.NUM_BUCKETS, 0)]),
    dict(version=1, shards=[], ranges=[(0, psm.NUM_BUCKETS, 0)]),
    dict(version=1, shards=["a"], ranges=[(0, 100, 0)]),
    dict(version=1, shards=["a"], ranges=[(0, 100, 0),
                                          (50, psm.NUM_BUCKETS, 0)]),
    dict(version=1, shards=["a"], ranges=[(0, psm.NUM_BUCKETS, 1)]),
    dict(version=1, shards=["a"], ranges=[(0, psm.NUM_BUCKETS, 0)],
         replicas={"t": {1: (3,)}}),
])
def test_validation_refuses_as_jax_does(bad):
    with pytest.raises(jsm.ShardMapError) as jax_err:
        jsm.ShardMap(**bad)
    with pytest.raises(psm.ShardMapError) as port_err:
        psm.ShardMap(**bad)
    assert str(port_err.value) == str(jax_err.value)


def test_client_map_only_moves_forward():
    m1 = psm.ShardMap.bootstrap(["a:1"])
    m2 = m1.add_shard("b:2").move_range(4096, 8192, 1)
    holder = psm.ClientShardMap(m1)
    assert holder.update(m2.to_json()) is True
    assert holder.version == 3
    assert holder.update(m1.to_json()) is False
    assert holder.get() == m2
    with pytest.raises(psm.ShardMapError, match="buckets"):
        holder.update(dict(m2.to_json(), num_buckets=16))
