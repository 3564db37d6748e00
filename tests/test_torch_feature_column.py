"""The port's feature columns (``elasticdl_tpu_torch/preprocessing/
feature_column.py``) against the JAX package's on the CPU.

- Every column's host half and device ids equal the JAX package's
  exactly, on seeded inputs with the edges (strings and bytes, NaN,
  ±inf, 3e9, negative ids, ids beyond 2^31); so do
  ``apply_host_transforms``' outputs through wrapper columns. The JAX
  device halves take ``jnp`` arrays (XLA's saturating casts, as under
  the zoo's jit).
- ``DenseFeatures`` with the JAX module's tables carried across
  (``bridge.flax_state_dict``), in f32: the forward within 1e-6
  relative L2, and the gradient with respect to each table within 1e-6
  (mean, sum and sqrtn combiners, multi-hot indicators, a normalizer);
  only the order of float sums differs.
- The port's partition pass marks the same tables as the JAX pass.
- The same invalid specifications raise the same errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.embedding.partition import (
    embedding_partition_rule as jax_rule,
)
from elasticdl_tpu.preprocessing import feature_column as jfc
from elasticdl_tpu_torch import bridge
from elasticdl_tpu_torch.embedding.partition import (
    embedding_partition_rule,
    partition_specs,
)
from elasticdl_tpu_torch.preprocessing import feature_column as pfc

BATCH = 8
TOL = 1e-6
VOCAB = ("Bachelors", "HS-grad", "Masters", "Doctorate")
EDGE_FLOATS = [np.nan, np.inf, -np.inf, 3e9, -3e9, 25.0, 35.0, -1.5, 2.5]
EDGE_IDS = [-1, 0, 2 ** 31 - 1, -(2 ** 31), 2 ** 31, 2 ** 32 + 5,
            2 ** 40 + 7, 3, 4, 9]


def _equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _rel(got, want):
    got = np.asarray(got.detach().double().numpy()
                     if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _strings(seed, n=24):
    rng = np.random.default_rng(seed)
    pool = list(VOCAB) + ["unknown", "", "Some-college", "ünïcode"]
    return np.asarray([pool[i] for i in rng.integers(0, len(pool), n)])


def _floats(seed, n=24):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-10, 110, n).astype(np.float32),
                           np.asarray(EDGE_FLOATS, np.float32)])


def _ids(seed, n=24, high=12):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(-3, high, n),
                           np.asarray(EDGE_IDS, np.int64)])


# ---- columns: host halves and device ids ---------------------------------

def _column_cases():
    """(name, build(pkg), host inputs) for every categorical column."""
    return [
        ("identity", lambda m: m.categorical_column_with_identity("k", 10),
         [_ids(0), _ids(1).astype(np.int32), _floats(2)]),
        ("identity_default",
         lambda m: m.categorical_column_with_identity("k", 10,
                                                      default_value=3),
         [_ids(3), _floats(4)]),
        ("hash", lambda m: m.categorical_column_with_hash_bucket("k", 64),
         [_strings(5), np.char.encode(_strings(6), "utf-8"), _ids(7),
          _floats(8)]),
        ("vocab_oov", lambda m: m.categorical_column_with_vocabulary_list(
            "k", VOCAB, num_oov_buckets=3), [_strings(9)]),
        ("vocab_default", lambda m: m.categorical_column_with_vocabulary_list(
            "k", VOCAB, default_value=1), [_strings(10)]),
        ("vocab_reserved", lambda m: m.categorical_column_with_vocabulary_list(
            "k", VOCAB), [np.char.encode(_strings(11), "utf-8")]),
        ("bucketized", lambda m: m.bucketized_column(
            m.numeric_column("k"), [65.0, 18.0, 25.0, 45.0]),
         [_floats(12), np.asarray(["25", "", "x", "70"])]),
    ]


@pytest.mark.parametrize("case", [c[0] for c in _column_cases()])
def test_column_host_and_device_ids_match_jax(case):
    _, build, inputs = next(c for c in _column_cases() if c[0] == case)
    jcol, pcol = build(jfc), build(pfc)
    assert pcol.num_buckets == jcol.num_buckets
    for values in inputs:
        host_j, host_p = jcol.host(values), pcol.host(values)
        _equal(host_p, host_j)
        if np.asarray(host_p).dtype.kind in "US":
            continue   # a raw string id column reaches no device
        _equal(pcol.device_ids(torch.from_numpy(np.asarray(host_p))),
               jcol.device_ids(jnp.asarray(host_j)))


def test_numeric_column_matches_jax():
    def norm(v):
        return (v - 38.0) / 13.0

    jcol = jfc.numeric_column("x", shape=2, normalizer_fn=norm,
                              default_value=-1.0)
    pcol = pfc.numeric_column("x", shape=2, normalizer_fn=norm,
                              default_value=-1.0)
    assert pcol.output_dim == jcol.output_dim == 2
    for values in (_floats(13).reshape(-1, 1)[:32].reshape(16, 2),
                   np.asarray([["1.5", ""], [b"x", "4"]], dtype=object)):
        host = pcol.host(values)
        _equal(host, jcol.host(values))
        _equal(pcol.device(torch.from_numpy(host)),
               jcol.device(jnp.asarray(host)))


def test_concatenated_column_matches_jax():
    def build(m):
        return m.concatenated_categorical_column([
            m.categorical_column_with_vocabulary_list("edu", VOCAB, 2),
            m.categorical_column_with_hash_bucket("work", 16),
            m.bucketized_column(m.numeric_column("age"), [25.0, 50.0]),
            m.categorical_column_with_identity("n", 5),
        ])

    jcol, pcol = build(jfc), build(pfc)
    assert pcol.key == jcol.key and pcol.offsets == jcol.offsets
    assert pcol.num_buckets == jcol.num_buckets == 6 + 16 + 3 + 5
    raw = {"edu": _strings(14, 33), "work": _strings(15, 33),
           "age": _floats(16), "n": _ids(17, 23)}
    host_j = jfc.apply_host_transforms([jcol], raw)
    host_p = pfc.apply_host_transforms([pcol], raw)
    assert sorted(host_p) == sorted(host_j)
    for key in host_j:
        _equal(host_p[key], host_j[key])
    _equal(pcol.device_ids({k: torch.from_numpy(np.asarray(v))
                            for k, v in host_p.items()}),
           jcol.device_ids({k: jnp.asarray(v) for k, v in host_j.items()}))


def test_apply_host_transforms_through_wrappers_matches_jax():
    """Embedding and indicator columns recurse to their leaves; entries
    no column reads pass through."""
    def build(m):
        edu = m.categorical_column_with_vocabulary_list("edu", VOCAB, 1)
        work = m.categorical_column_with_hash_bucket("work", 32)
        return [m.numeric_column("age"),
                m.embedding_column(m.concatenated_categorical_column(
                    [edu, work]), 4),
                m.indicator_column(m.categorical_column_with_hash_bucket(
                    "thal", 8))]

    raw = {"age": np.asarray(["38", "", "x", "51.5"]),
           "edu": _strings(18, 4), "work": np.char.encode(_strings(19, 4),
                                                          "utf-8"),
           "thal": _strings(20, 4), "extra": np.arange(4)}
    want = jfc.apply_host_transforms(build(jfc), raw)
    got = pfc.apply_host_transforms(build(pfc), raw)
    assert sorted(got) == sorted(want)
    for key in want:
        _equal(got[key], want[key])


# ---- DenseFeatures -------------------------------------------------------


def _dense_columns(m):
    """Every column kind DenseFeatures takes: a normalized numeric, an
    embedding over multi-id identity (mean), over a hashed column (sum),
    over a concatenated union (sqrtn), and two indicators."""
    edu = m.categorical_column_with_vocabulary_list("edu", VOCAB, 2)
    age = m.bucketized_column(m.numeric_column("age"), [25.0, 45.0, 65.0])
    return [
        m.numeric_column("x", shape=2, normalizer_fn=lambda v: v * 2.0 - 1.0),
        m.embedding_column(m.categorical_column_with_identity("ids", 12),
                           6, combiner="mean"),
        m.embedding_column(m.categorical_column_with_hash_bucket("h", 16),
                           4, combiner="sum"),
        m.embedding_column(m.concatenated_categorical_column([edu, age]),
                           3, combiner="sqrtn"),
        m.indicator_column(m.categorical_column_with_vocabulary_list(
            "edu", VOCAB, 1)),
        m.indicator_column(m.concatenated_categorical_column(
            [m.categorical_column_with_identity("ids", 12), age])),
    ]


def _dense_features(seed):
    rng = np.random.default_rng(seed)
    raw = {"x": rng.standard_normal((BATCH, 2)).astype(np.float32),
           "ids": rng.integers(-2, 14, (BATCH, 3)),
           "h": _strings(seed + 1, BATCH),
           "edu": _strings(seed + 2, BATCH),
           "age": np.concatenate([rng.uniform(10, 80, BATCH - 2),
                                  [np.nan, 45.0]]).astype(np.float32)}
    return jfc.apply_host_transforms(_dense_columns(jfc), raw)


def test_dense_features_forward_and_table_gradients_match_jax():
    host = _dense_features(21)
    jmod = jfc.DenseFeatures(columns=_dense_columns(jfc))
    jfeats = {k: jnp.asarray(v) for k, v in host.items()}
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0),
                                                jfeats))
    want = np.asarray(jmod.apply(params, jfeats))
    cot = np.random.default_rng(22).standard_normal(want.shape).astype(
        np.float32)

    def objective(p):
        return jnp.sum(jmod.apply(p, jfeats) * cot)

    want_grads = bridge.flax_state_dict(
        jax.tree.map(np.asarray, jax.grad(objective)(params)))

    model = pfc.DenseFeatures(_dense_columns(pfc))
    state = bridge.flax_state_dict(params)
    assert sorted(model.state_dict()) == sorted(state) == [
        "edu_age_embedding.embedding", "h_embedding.embedding",
        "ids_embedding.embedding"]
    model.load_state_dict(state)
    got = model({k: torch.from_numpy(np.asarray(v))
                 for k, v in host.items()})
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got, want) <= TOL
    (got * torch.from_numpy(cot)).sum().backward()
    for name, p in model.named_parameters():
        assert _rel(p.grad, want_grads[name]) <= TOL, name


def test_dense_features_param_dtype_and_initializer():
    """``param_dtype`` sets the tables' and the indicators' dtype; an
    ``initializer(shape, dtype)`` draws the table."""
    cat = pfc.categorical_column_with_identity("c", 5)
    cols = [pfc.embedding_column(
        cat, 3, initializer=lambda shape, dtype: torch.full(shape, 0.5)),
        pfc.indicator_column(cat)]
    model = pfc.DenseFeatures(cols, param_dtype=torch.float64)
    table = model.c_embedding.embedding
    assert table.dtype == torch.float64 and bool((table == 0.5).all())
    out = model({"c": torch.tensor([[1], [4]])})
    assert out.dtype == torch.float64
    np.testing.assert_array_equal(out[:, 3:].detach().numpy(),
                                  [[0, 1, 0, 0, 0], [0, 0, 0, 0, 1]])


def test_partition_pass_marks_the_same_tables_as_jax():
    """A DenseFeatures' tables go through the 2 MB auto-partition rule
    as hand-built Embedding layers do: the same tables are row-sharded
    (a 65,536 x 16 table; not the small one, not one whose rows do not
    divide the axis)."""
    def build(m):
        return [m.embedding_column(m.categorical_column_with_identity(
                    "big", 1 << 16), 16),
                m.embedding_column(m.categorical_column_with_identity(
                    "small", 64), 16),
                m.embedding_column(m.categorical_column_with_identity(
                    "odd", (1 << 16) + 1), 16)]

    feats = {"big": np.zeros((2, 1), np.int32),
             "small": np.zeros((2, 1), np.int32),
             "odd": np.zeros((2, 1), np.int32)}
    jmod = jfc.DenseFeatures(columns=build(jfc))
    params = jmod.init(jax.random.PRNGKey(0),
                       {k: jnp.asarray(v) for k, v in feats.items()})
    rule = jax_rule(axis="dp", axis_size=4)
    want = {".".join(str(getattr(k, "key", k)) for k in path[1:]):
            tuple(rule(path, leaf))
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params)[0]}
    got = partition_specs(pfc.DenseFeatures(build(pfc)),
                          embedding_partition_rule(axis="dp", axis_size=4))
    assert got == want
    assert got["big_embedding.embedding"] == ("dp", None)
    assert got["small_embedding.embedding"] == ()
    assert got["odd_embedding.embedding"] == ()


# ---- invalid specifications ------------------------------------------------


INVALID = [
    ("identity_zero", lambda m: m.categorical_column_with_identity("c", 0),
     "num_buckets must be positive"),
    ("hash_zero", lambda m: m.categorical_column_with_hash_bucket("c", 0),
     "hash_bucket_size must be positive"),
    ("bucketized_source", lambda m: m.bucketized_column(
        m.categorical_column_with_identity("c", 3), [1.0]),
     "numeric_column source"),
    ("concat_empty", lambda m: m.concatenated_categorical_column([]),
     "at least one categorical"),
    ("concat_numeric", lambda m: m.concatenated_categorical_column(
        [m.numeric_column("x")]), "is not a categorical column"),
    ("concat_nested", lambda m: m.concatenated_categorical_column([
        m.concatenated_categorical_column(
            [m.categorical_column_with_identity("a", 2)]),
        m.categorical_column_with_identity("c", 2)]), "nested"),
    ("embedding_dim", lambda m: m.embedding_column(
        m.categorical_column_with_identity("c", 3), 0), "Invalid dimension"),
    ("embedding_init", lambda m: m.embedding_column(
        m.categorical_column_with_identity("c", 3), 8, initializer=5),
     "initializer must be callable"),
    ("embedding_combiner", lambda m: m.embedding_column(
        m.categorical_column_with_identity("c", 3), 8, combiner="max"),
     "unsupported combiner"),
    ("embedding_numeric", lambda m: m.embedding_column(
        m.numeric_column("x"), 8), "needs a categorical column"),
    ("indicator_numeric", lambda m: m.indicator_column(m.numeric_column("x")),
     "needs a categorical column"),
]


@pytest.mark.parametrize("case", [c[0] for c in INVALID])
def test_invalid_specifications_raise_as_jax(case):
    _, build, message = next(c for c in INVALID if c[0] == case)
    with pytest.raises(ValueError, match=message) as want:
        build(jfc)
    with pytest.raises(ValueError, match=message) as got:
        build(pfc)
    assert str(got.value) == str(want.value)


def test_dense_features_refuses_what_jax_refuses():
    """A bare categorical column and a column of no known kind raise the
    JAX module's errors (at its first call; here at construction, where
    the tables are built); identity ``validate`` raises in ``host``."""
    feats = {"c": jnp.asarray([[1]])}
    for cols, message in (
            ((lambda m: [m.categorical_column_with_identity("c", 4)]),
             "bare categorical column 'c'"),
            ((lambda m: [object()]), "unsupported column")):
        with pytest.raises(ValueError, match=message) as want:
            jfc.DenseFeatures(columns=cols(jfc)).init(
                jax.random.PRNGKey(0), feats)
        with pytest.raises(ValueError, match=message) as got:
            pfc.DenseFeatures(cols(pfc))
        if message != "unsupported column":   # the repr names the object
            assert str(got.value) == str(want.value)
    values = np.asarray([0, 3, 12, -1])
    for m in (jfc, pfc):
        col = m.categorical_column_with_identity("c", 10, validate=True)
        with pytest.raises(ValueError, match="2 id\\(s\\) outside"):
            col.host(values)
