"""The port's preprocessing package (``elasticdl_tpu_torch/preprocessing``)
against the JAX package's on the CPU: every host transform, feature
group and device layer gives exactly the JAX package's ids.

Inputs come from numpy seeds and carry the edges: values equal to a
boundary, NaN, ±inf, 3e9 (beyond int32), negative ids, ids at and
beyond 2^31, ``bytes`` beside ``str``. The JAX device layers take
``jnp`` arrays, so their float-to-int casts are XLA's (the conversion
inside the zoo's jitted models), which saturate: NaN to 0, beyond the
range to its bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.preprocessing import (
    feature_group as jax_group,
    layers as jax_layers,
    transforms as jax_transforms,
)
from elasticdl_tpu_torch.preprocessing import (
    feature_group as port_group,
    layers as port_layers,
    transforms as port_transforms,
)

EDGES = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 2.0 ** 31,
                  -(2.0 ** 31), 25.0, 35.0, 65.0, 18.0, -0.0, 0.5, 1.5,
                  2.5, -1.5, 99.5], np.float32)
BOUNDARIES = [18.0, 25.0, 30.0, 35.0, 40.0, 45.0, 50.0, 55.0, 60.0, 65.0]
IDS = np.array([-1, 0, 1, 2 ** 31 - 1, -(2 ** 31), 123456789, 2 ** 31,
                2 ** 32 - 1, 2 ** 32 + 5, 2 ** 40 + 7, -(2 ** 40) - 3],
               np.int64)


def _floats(seed, n=64):
    """Seeded census-scale floats with the edges appended."""
    rng = np.random.default_rng(seed)
    draws = rng.uniform(-10.0, 110.0, n).astype(np.float32)
    return np.concatenate([draws, np.round(draws), EDGES])


def _ids(seed, n=64):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(-(2 ** 40), 2 ** 40, n), IDS])


def _equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


# ---- host transforms ------------------------------------------------------


STRINGS = ["Bachelors", "HS-grad", "", "Doctorate", "unknown", "ünïcode",
           "12.5", "-3", "nan", "inf", " 7 ", "1e3", "x1"]


def _string_values(seed):
    rng = np.random.default_rng(seed)
    picks = [STRINGS[i] for i in rng.integers(0, len(STRINGS), 40)]
    return STRINGS + picks


@pytest.mark.parametrize("form", ["str", "bytes", "object", "numeric"])
def test_to_number_matches_jax(form):
    values = _string_values(0)
    if form == "bytes":
        values = np.asarray([v.encode("utf-8") for v in values])
    elif form == "object":
        values = np.asarray(values + [b"4.5", None, 3], dtype=object)
    elif form == "numeric":
        values = _floats(1)
    for dtype in (np.float32, np.float64, np.int64):
        if dtype == np.int64 and form == "numeric":
            continue  # NaN to int64 is not a value either package promises
        want = jax_transforms.to_number(values, -1, dtype=dtype)
        got = port_transforms.to_number(values, -1, dtype=dtype)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_bins", [1, 7, 100, 2 ** 31 - 1])
def test_category_hash_matches_jax(num_bins):
    values = _string_values(2)
    for batch in (np.asarray(values), np.asarray(values).reshape(-1, 1),
                  np.asarray([v.encode("utf-8") for v in values]),
                  np.asarray(values + [3, 4.5], dtype=object),
                  _ids(3)):
        _equal(port_transforms.CategoryHash(num_bins)(batch),
               jax_transforms.CategoryHash(num_bins)(batch))
    assert port_transforms._stable_string_hash("abc") == \
        jax_transforms._stable_string_hash("abc") == \
        port_transforms._stable_string_hash(b"abc")
    with pytest.raises(ValueError, match="num_bins must be positive"):
        port_transforms.CategoryHash(0)


@pytest.mark.parametrize("num_oov", [0, 1, 3])
def test_category_lookup_matches_jax(num_oov):
    vocab = ["Bachelors", "HS-grad", "Masters", "Doctorate"]
    values = _string_values(4)
    for batch in (np.asarray(values),
                  np.asarray([v.encode("utf-8") for v in values]),
                  np.asarray(values[:52]).reshape(-1, 4)):
        want = jax_transforms.CategoryLookup(vocab, num_oov)
        got = port_transforms.CategoryLookup(vocab, num_oov)
        assert got.num_buckets == want.num_buckets
        _equal(got(batch), want(batch))


def test_numeric_bucket_matches_jax():
    bounds = [65.0, 25.0, 45.0, 35.0, 55.0]   # unsorted, as a user may give
    want = jax_transforms.NumericBucket(bounds)
    got = port_transforms.NumericBucket(bounds)
    assert got.num_buckets == want.num_buckets == 6
    for batch in (_floats(5), _floats(6).astype(np.float64),
                  np.asarray(["25", "24.9", "", "nan", "x", "70"]),
                  np.asarray([b"35", b"-inf"])):
        _equal(got(batch), want(batch))


def test_feature_group_and_concat_ids_match_jax():
    rng = np.random.default_rng(7)
    vocab = ["a", "b", "c"]
    record = {
        "cat": np.asarray([vocab[i] for i in rng.integers(0, 3, 32)]
                          + ["zzz", ""]),
        "num": np.concatenate([rng.uniform(0, 100, 32), [np.nan, np.inf]]),
        "more": np.asarray([f"h{i}" for i in rng.integers(0, 9, 34)]),
    }

    def group(pkg):
        return pkg.FeatureGroup([
            ("cat", pkg_transforms[pkg].CategoryLookup(vocab, 2)),
            ("num", pkg_transforms[pkg].NumericBucket([10.0, 50.0])),
            ("more", pkg_transforms[pkg].CategoryLookup(
                ["h1", "h2", "h3"], 13)),
        ])

    pkg_transforms = {jax_group: jax_transforms, port_group: port_transforms}
    want, got = group(jax_group), group(port_group)
    assert got.offsets == want.offsets and \
        got.total_buckets == want.total_buckets == 24
    _equal(got(record), want(record))
    groups = [rng.integers(0, 5, (8, 2)), rng.integers(0, 3, (8, 1)),
              rng.integers(0, 9, (8, 3))]
    _equal(port_group.concat_feature_ids(groups, [5, 3, 9]),
           jax_group.concat_feature_ids(groups, [5, 3, 9]))


# ---- device layers ----------------------------------------------------------


def test_to_int32_is_xla_conversion():
    """XLA's float-to-int32 conversion (the JAX zoo's casts under jit)
    saturates; PyTorch's own cast on the CPU gives INT_MIN for NaN and
    3e9, so ``to_int32`` writes the saturation out. Integer
    inputs keep their low 32 bits, as a jnp int32 array of int64 ids
    does."""
    x = _floats(8)
    _equal(port_layers.to_int32(torch.from_numpy(x)),
           jnp.asarray(x).astype(jnp.int32))
    assert port_layers.to_int32(torch.tensor([np.nan, 3e9])).tolist() == \
        [0, 2 ** 31 - 1]
    ids = _ids(9)
    _equal(port_layers.to_int32(torch.from_numpy(ids)), jnp.asarray(ids))
    _equal(port_layers.to_int32(torch.from_numpy(x).double()),
           jnp.asarray(x).astype(jnp.int32))


def test_discretization_matches_jax():
    want = jax_layers.Discretization(BOUNDARIES[::-1])
    got = port_layers.Discretization(BOUNDARIES[::-1])
    assert got.num_buckets == want.num_buckets == 11
    x = _floats(10)
    for batch in (x, x[:144].reshape(-1, 3)[:, :2], x.astype(np.float64),
                  np.arange(-5, 100, dtype=np.int32)):
        _equal(got(torch.from_numpy(np.ascontiguousarray(batch))),
               want(jnp.asarray(batch)))


def test_discretization_keeps_one_copy_a_device():
    """The boundaries are copied to a device at the first call there and
    reused; a numpy input runs on the CPU."""
    layer = port_layers.Discretization(BOUNDARIES)
    first = layer.boundaries("cpu")
    assert layer.boundaries(torch.device("cpu")) is first
    layer(np.asarray([20.0], np.float32))
    assert list(layer._on) == [torch.device("cpu")]
    assert layer.boundaries("cpu") is first
    assert first.dtype == torch.float32


def test_round_identity_matches_jax():
    x = _floats(11)
    for buckets in (1, 10, 100):
        _equal(port_layers.RoundIdentity(buckets)(torch.from_numpy(x)),
               jax_layers.RoundIdentity(buckets)(jnp.asarray(x)))
    with pytest.raises(ValueError, match="num_buckets must be positive"):
        port_layers.RoundIdentity(0)


@pytest.mark.parametrize("num_bins", [1, 2, 64, 100, 1000003, 2 ** 31 - 1])
def test_hashing_matches_jax(num_bins):
    """The uint32 finalizer in int64 on the low 32 bits: negative ids
    wrap as ``astype(uint32)`` does, int64 ids at and beyond 2^31 keep
    their low 32 bits (as in a jnp int32 array), floats saturate to
    [0, 2^32 - 1] with NaN at 0."""
    want, got = jax_layers.Hashing(num_bins), port_layers.Hashing(num_bins)
    ids = _ids(12)
    _equal(got(torch.from_numpy(ids)), want(ids))
    _equal(got(torch.from_numpy(ids.astype(np.int32))),
           want(jnp.asarray(ids.astype(np.int32))))
    x = _floats(13)
    _equal(got(torch.from_numpy(x)), want(jnp.asarray(x)))
    with pytest.raises(ValueError, match="num_bins must be positive"):
        port_layers.Hashing(0)


def test_add_id_offset_matches_jax():
    rng = np.random.default_rng(14)
    cols = [rng.integers(0, 5, 16), rng.integers(0, 3, (16, 1)),
            rng.integers(0, 9, (16, 2))]
    want = jax_layers.AddIdOffset([5, 3, 9])
    got = port_layers.AddIdOffset([5, 3, 9])
    assert got.total_size == want.total_size == 17
    _equal(got([torch.from_numpy(c) for c in cols]),
           want([jnp.asarray(c) for c in cols]))


def test_one_hot_matches_jax():
    """``jax.nn.one_hot``: ids out of range (negative, at or past the
    class count) give rows of zeros, where ``F.one_hot`` raises."""
    import jax

    ids = np.array([[0, 3, -1], [10, 11, 2]], np.int32)
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        got = port_layers.one_hot(torch.from_numpy(ids), 11, dtype)
        want = jax.nn.one_hot(jnp.asarray(ids), 11, dtype=jdt)
        assert got.dtype == dtype and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    with pytest.raises(RuntimeError):
        torch.nn.functional.one_hot(torch.tensor([-1]), 11)
