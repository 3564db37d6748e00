"""The port's partition rules and shardings (elasticdl_tpu_torch/parallel/
rules.py and mesh.py) against the JAX package's, on the same shapes.

JAX runs on the conftest's 8 virtual CPU devices, the port on
``[cpu] * n`` meshes. Specs are compared without trailing ``None``s
(``P("dp")`` and ``P("dp", None)`` place a leaf alike). Nothing here is
numeric, so every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from elasticdl_tpu.parallel import mesh as jmesh
from elasticdl_tpu.parallel import rules as jrules
from elasticdl_tpu_torch.parallel import mesh as tmesh
from elasticdl_tpu_torch.parallel import rules as trules
from elasticdl_tpu_torch.parallel.rules import PartitionSpec as TP

CPU = torch.device("cpu")


def _norm(spec) -> tuple:
    entries = list(spec)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _meshes(shape, axes):
    n = int(np.prod(shape))
    return (jmesh.make_mesh(shape, axes, devices=jax.devices()[:n]),
            tmesh.make_mesh(shape, axes, [CPU] * n))


# ---- tests/test_mesh_runner.py:48-73, against the port ---------------------


def test_parse_empty():
    assert tmesh.parse_mesh_args("", "dp") == jmesh.parse_mesh_args("", "dp")
    shape, axes = tmesh.parse_mesh_args("", "dp")
    assert shape is None and axes == ("dp",)


def test_parse_2d():
    assert tmesh.parse_mesh_args("4,2", "dp,mp") == ((4, 2), ("dp", "mp"))


def test_parse_mismatch():
    with pytest.raises(ValueError):
        tmesh.parse_mesh_args("4,2", "dp")


def test_make_mesh_of_one_device_repeated():
    mesh = tmesh.make_mesh(None, ("dp",), [CPU] * 8)
    assert mesh.size == 8 and mesh.axis_names == ("dp",)
    assert mesh.shape == {"dp": 8} and mesh.device == CPU


@pytest.mark.parametrize("shape", [(24, 5), (7, 3), (3, 16), (5, 7, 8),
                                   (), (8,), (4, 2)])
def test_shard_leaf_over_axis_matches_jax(shape):
    jm, tm = _meshes((8,), ("dp",))
    want = jmesh.shard_leaf_over_axis(jm, jnp.zeros(shape)).spec
    got = tmesh.shard_leaf_over_axis(tm, torch.zeros(shape))
    assert _norm(got.spec) == _norm(want)
    n_split = 8 if any(s % 8 == 0 and s >= 8 for s in shape) else 1
    assert got.num_shards == n_split


# ---- spec_fits / fit_spec / regex_param_rule -------------------------------

SPECS = [("dp",), ("dp", None), (None, "tp"), ("tp", "dp"), (("dp", "tp"),),
         ("sp",), (None, None, "dp"), ()]
SHAPES = [(8, 4), (6, 4), (4, 6), (16,), (2, 3, 8)]


@pytest.mark.parametrize("entries", SPECS)
@pytest.mark.parametrize("shape", SHAPES)
def test_spec_fits_and_fit_spec_match_jax(entries, shape):
    jm, tm = _meshes((4, 2), ("dp", "tp"))
    jleaf, tleaf = jnp.zeros(shape), torch.zeros(shape)
    assert (trules.spec_fits(TP(*entries), tleaf, tm)
            == jrules.spec_fits(JP(*entries), jleaf, jm))
    assert (_norm(trules.fit_spec(TP(*entries), tleaf, tm))
            == _norm(jrules.fit_spec(JP(*entries), jleaf, jm)))


def test_regex_param_rule_matches_jax():
    rules_j = [(r"attn/.*/kernel", JP(None, "tp")), (r"bias$", JP("tp"))]
    rules_t = [(r"attn/.*/kernel", TP(None, "tp")), (r"bias$", TP("tp"))]
    names = ["block/attn/query/kernel", "block/mlp/bias", "head/kernel",
             "block/attn/out/kernel"]
    shapes = [(8, 6), (6,), (4, 4), (8, 5)]
    for shape_mesh in [((4, 2), ("dp", "tp")), ((8,), ("dp",))]:
        jm, tm = _meshes(*shape_mesh)
        fallback_j = lambda path, leaf: JP("dp")   # noqa: E731
        fallback_t = lambda path, leaf: TP("dp")   # noqa: E731
        rj = jrules.regex_param_rule(rules_j, mesh=jm, fallback=fallback_j)
        rt = trules.regex_param_rule(rules_t, mesh=tm, fallback=fallback_t)
        for name, shape in zip(names, shapes):
            path = tuple(jax.tree_util.DictKey(k) for k in name.split("/"))
            want = rj(path, jnp.zeros(shape))
            # The port's rule reads a torch name (dots for slashes).
            got = rt(name.replace("/", "."), torch.zeros(shape))
            assert _norm(got) == _norm(want), (name, shape_mesh)
        # Unfitted (no mesh): the rule's spec as written.
        raw = trules.regex_param_rule(rules_t)
        assert raw("x.attn.q.kernel", torch.zeros(3, 3)) == TP(None, "tp")
        assert raw("x.w", torch.zeros(3)) == TP()


def test_path_str():
    assert trules.path_str("blocks.0.attn.query.weight") == \
        "blocks/0/attn/query/weight"
    assert trules.path_str(("features", "ids")) == "features/ids"
    assert jrules.path_str((jax.tree_util.DictKey("features"),
                            jax.tree_util.DictKey("ids"))) == "features/ids"


# ---- NamedSharding and ShardedTensor ---------------------------------------


def test_views_split_gather_round_trip():
    tm = tmesh.make_mesh((4,), ("dp",), [CPU] * 4)
    value = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    for spec, dim in [(TP("dp"), 0), (TP(None, "dp"), None),
                      (TP(None, None), None)]:
        sharding = tmesh.NamedSharding(tm, spec)
        if spec == TP(None, "dp"):
            # 6 % 4 != 0: what ZeRO would never pick still raises.
            with pytest.raises(ValueError, match="split"):
                sharding.shard_shape(value.shape)
            continue
        views = sharding.views(value)
        shards = sharding.split(value)
        assert len(shards) == sharding.num_shards == (4 if dim == 0 else 1)
        for v, s in zip(views, shards):
            assert torch.equal(v, s)
            # A shard is a tensor of its own, a view is not.
            assert (s.untyped_storage().data_ptr()
                    != value.untyped_storage().data_ptr())
            assert (v.untyped_storage().data_ptr()
                    == value.untyped_storage().data_ptr())
        assert torch.equal(sharding.gather(shards), value)
        st = tmesh.ShardedTensor(sharding, shards)
        assert st.shape == (8, 6) and torch.equal(tmesh.whole(st), value)
        st.copy_(value * 2)
        assert torch.equal(st.gather(), value * 2)


def test_sharding_equality_and_two_split_dims():
    tm = tmesh.make_mesh((4, 2), ("dp", "tp"), [CPU] * 8)
    assert (tmesh.NamedSharding(tm, TP("dp"))
            == tmesh.NamedSharding(tm, TP("dp", None)))
    assert (tmesh.NamedSharding(tm, TP("dp"))
            != tmesh.NamedSharding(tm, TP(None, "dp")))
    assert tmesh.NamedSharding(tm, TP(("dp", "tp"))).num_shards == 8
    # Two split dims (the batch's P("dp", "sp"), the experts'
    # P("ep", None, "tp")) place by dims, row-major over them; a leaf
    # held split over two dims gathers whole and copies back.
    two = tmesh.NamedSharding(tm, TP("dp", "tp"))
    assert two.num_shards == 8 and two.dims == [0, 1]
    value = torch.arange(32.0).reshape(8, 4)
    assert [tuple(v.shape) for v in two.views(value)] == [(2, 2)] * 8
    assert torch.equal(two.views(value)[1], value[:2, 2:])
    assert two.block_starts(0, 8) == [0, 0, 2, 2, 4, 4, 6, 6]
    assert two.block_starts(1, 4) == [0, 2] * 4
    assert two.whole_slices((8, 4))[1] == (slice(0, 2), slice(2, 4))
    st = tmesh.ShardedTensor.from_whole(two, value)
    assert st.shape == (8, 4) and torch.equal(st.gather(), value)
    st.copy_(value * 3)
    assert torch.equal(st.shards[1], value[:2, 2:] * 3)
    assert torch.equal(tmesh.whole(st), value * 3)
    with pytest.raises(ValueError, match="twice"):
        tmesh.NamedSharding(tm, TP("tp", "tp"))
    assert tmesh.replicated(tm).is_replicated
    assert tmesh.batch_sharding(tm).spec == TP("dp")
