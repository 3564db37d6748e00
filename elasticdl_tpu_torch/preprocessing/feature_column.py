"""Feature-column API: declarative feature specs compiled to tensor ops
(port of elasticdl_tpu/preprocessing/feature_column.py).

The constructor surface is the JAX package's (and the reference's TF
one). Columns compile in two planes:

- **host plane**: ``apply_host_transforms(columns, record)`` runs the
  string-capable numpy work (vocabulary lookup, string hashing,
  to_number) inside ``dataset_fn`` on the worker host; these halves
  are the JAX package's, copied, so the host ids are bit-equal;
- **device plane**: ``DenseFeatures(columns)`` is an ``nn.Module`` of
  tensor ops (bucketize, hash-mix, multi-hot, embedding gather) on the
  model's device. Each embedding column owns the port's ``Embedding``
  layer as the submodule ``{key}_embedding``, so its table's parameter
  name ends in ``embedding`` as the JAX package's does (the partition
  pass, ``embedding/partition.py``, matches on it). Its ragged lookup
  takes the ``Embedding`` layer's dispatch (the library route: gather
  and ``combine``).

Where the JAX package builds its tables lazily at the first call, a
``DenseFeatures`` builds them at construction, so the invalid column
lists it refuses raise there, with the JAX package's exception types
and messages. A column's ``initializer`` and a numeric column's
``normalizer_fn`` take tensors: ``initializer(shape, dtype)`` (the
port's ``Embedding`` contract), ``normalizer_fn(x)`` with ``x`` an f32
tensor. Column objects are frozen dataclasses.
"""

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.embedding.combiner import RaggedIds
from elasticdl_tpu_torch.embedding.layer import Embedding
from elasticdl_tpu_torch.preprocessing.layers import (
    Discretization,
    Hashing,
    one_hot,
    to_int32,
)
from elasticdl_tpu_torch.preprocessing.transforms import (
    CategoryHash,
    CategoryLookup,
    to_number,
)


class FeatureColumn:
    """Marker base. Columns expose:

    - ``key``: the feature-dict entry consumed,
    - ``host(values)``: optional numpy transform (strings allowed),
      identity by default,
    - categorical columns add ``num_buckets``; dense columns add
      ``output_dim``.
    """

    def host(self, values):
        return values


class CategoricalColumn(FeatureColumn):
    num_buckets: int


# ---------------------------------------------------------------- numeric


@dataclass(frozen=True)
class NumericColumn(FeatureColumn):
    key: str
    shape: Tuple[int, ...] = (1,)
    normalizer_fn: Optional[Callable] = None
    default_value: float = 0.0

    @property
    def output_dim(self) -> int:
        return int(np.prod(self.shape))

    def host(self, values):
        # String-tolerant numeric parse (csv readers hand over bytes).
        arr = np.asarray(values)
        if arr.dtype.kind in ("U", "S", "O"):
            arr = to_number(arr, self.default_value)
        return arr.astype(np.float32)

    def device(self, x):
        x = torch.as_tensor(x).to(torch.float32)
        if self.normalizer_fn is not None:
            x = self.normalizer_fn(x)
        return x.reshape(x.shape[0], self.output_dim)


def numeric_column(key, shape=(1,), normalizer_fn=None, default_value=0.0):
    """A dense float feature (tf.feature_column.numeric_column shape)."""
    if isinstance(shape, int):
        shape = (shape,)
    return NumericColumn(key, tuple(shape), normalizer_fn,
                         float(default_value))


# ----------------------------------------------------------- categorical


@dataclass(frozen=True)
class IdentityCategoricalColumn(CategoricalColumn):
    key: str
    num_buckets: int
    default_value: Optional[int] = None
    validate: bool = False

    def host(self, values):
        arr = np.asarray(values)
        if self.validate and self.default_value is None:
            bad = (arr < 0) | (arr >= self.num_buckets)
            if bad.any():
                sample = np.asarray(arr[bad]).ravel()[:5].tolist()
                raise ValueError(
                    f"identity column {self.key!r}: "
                    f"{int(bad.sum())} id(s) outside "
                    f"[0, {self.num_buckets}), e.g. {sample}"
                )
        return arr

    def device_ids(self, ids):
        ids = to_int32(ids)
        if self.default_value is not None:
            ids = torch.where((ids >= 0) & (ids < self.num_buckets),
                              ids, int(self.default_value))
        return torch.clamp(ids, 0, self.num_buckets - 1)


def categorical_column_with_identity(
    key, num_buckets, default_value=None, validate=False
):
    """With ``default_value=None`` the TF column raises on out-of-range
    ids; the device plane reads nothing back, so it CLIPS them to the
    boundary buckets [0, num_buckets-1] instead. ``validate=True``
    raises in ``host()`` (in ``dataset_fn``, before ids reach the
    device)."""
    if num_buckets <= 0:
        raise ValueError(f"num_buckets must be positive, got {num_buckets}")
    return IdentityCategoricalColumn(
        key, int(num_buckets), default_value, bool(validate)
    )


# Host-side string pre-hash range: strings map to a stable int32 in
# [0, 2^31) WITHOUT bucketing; the device mixer then buckets exactly
# once, as in the JAX package.
_HASH_PRERANGE = 2**31 - 1


@dataclass(frozen=True)
class HashedCategoricalColumn(CategoricalColumn):
    key: str
    num_buckets: int

    def host(self, values):
        arr = np.asarray(values)
        if arr.dtype.kind in ("U", "S", "O"):
            # Strings hash to a stable wide int on the host (device has
            # no string ops); bucketing happens once, on device.
            return CategoryHash(_HASH_PRERANGE)(arr).astype(
                np.int32
            )
        return arr

    def device_ids(self, ids):
        ids = torch.as_tensor(ids)
        if ids.is_floating_point():
            ids = to_int32(ids)
        return Hashing(self.num_buckets)(ids)


def categorical_column_with_hash_bucket(key, hash_bucket_size):
    if hash_bucket_size <= 0:
        raise ValueError("hash_bucket_size must be positive")
    return HashedCategoricalColumn(key, int(hash_bucket_size))


@dataclass(frozen=True)
class VocabularyCategoricalColumn(CategoricalColumn):
    key: str
    vocabulary: Tuple = ()
    num_oov_buckets: int = 0
    default_value: int = -1

    @property
    def num_buckets(self) -> int:  # type: ignore[override]
        if self.num_oov_buckets > 0:
            return len(self.vocabulary) + self.num_oov_buckets
        if 0 <= self.default_value < len(self.vocabulary):
            return len(self.vocabulary)
        # TF's default_value=-1 yields invalid ids; on device ids must
        # stay in-table, so a reserved OOV bucket takes that role.
        return len(self.vocabulary) + 1

    def host(self, values):
        lookup = CategoryLookup(
            list(self.vocabulary),
            num_oov_buckets=max(self.num_oov_buckets, 1),
        )
        ids = lookup(np.asarray(values)).astype(np.int32)
        if self.num_oov_buckets == 0 and (
            0 <= self.default_value < len(self.vocabulary)
        ):
            # TF surface: with no OOV buckets, unknowns map to
            # default_value instead of a reserved slot.
            ids = np.where(
                ids >= len(self.vocabulary),
                np.int32(self.default_value), ids,
            )
        return ids

    def device_ids(self, ids):
        return torch.clamp(to_int32(ids), 0, self.num_buckets - 1)


def categorical_column_with_vocabulary_list(
    key, vocabulary_list, num_oov_buckets=0, default_value=-1
):
    return VocabularyCategoricalColumn(
        key, tuple(vocabulary_list), int(num_oov_buckets),
        int(default_value),
    )


@dataclass(frozen=True)
class BucketizedColumn(CategoricalColumn):
    source_column: NumericColumn
    boundaries: Tuple[float, ...] = ()
    # The column's own Discretization: its boundaries go to a device
    # once, at the first call there, not at every call.
    _bucketize: Discretization = field(init=False, repr=False,
                                       compare=False)

    def __post_init__(self):
        object.__setattr__(self, "_bucketize",
                           Discretization(list(self.boundaries)))

    @property
    def key(self) -> str:
        return self.source_column.key

    @property
    def num_buckets(self) -> int:  # type: ignore[override]
        return len(self.boundaries) + 1

    def host(self, values):
        return self.source_column.host(values)

    def device_ids(self, x):
        return self._bucketize(x)


def bucketized_column(source_column, boundaries):
    if not isinstance(source_column, NumericColumn):
        raise ValueError("bucketized_column needs a numeric_column source")
    return BucketizedColumn(source_column, tuple(float(b)
                                                for b in boundaries))


@dataclass(frozen=True)
class ConcatenatedCategoricalColumn(CategoricalColumn):
    """Offset-shifted union: sub-column ids share ONE id space (and
    therefore one downstream embedding table), the reference's
    ``concatenated_categorical_column``."""

    columns: Tuple[CategoricalColumn, ...] = ()

    @property
    def key(self) -> str:
        return "_".join(c.key for c in self.columns)

    @property
    def num_buckets(self) -> int:  # type: ignore[override]
        return sum(c.num_buckets for c in self.columns)

    @property
    def offsets(self) -> Tuple[int, ...]:
        out, acc = [], 0
        for c in self.columns:
            out.append(acc)
            acc += c.num_buckets
        return tuple(out)

    def device_ids(self, feature_dict):
        parts = []
        for col, off in zip(self.columns, self.offsets):
            ids = col.device_ids(feature_dict[col.key])
            parts.append(ids.reshape(ids.shape[0], -1) + off)
        return torch.cat(parts, dim=1)


def concatenated_categorical_column(categorical_columns):
    cols = tuple(categorical_columns)
    if not cols:
        raise ValueError("need at least one categorical column")
    for c in cols:
        if not isinstance(c, CategoricalColumn):
            raise ValueError(
                f"{c!r} is not a categorical column"
            )
        if isinstance(c, ConcatenatedCategoricalColumn):
            # device_ids indexes the feature dict by each member's key;
            # a nested concat has a synthetic key that matches nothing.
            raise ValueError(
                "nested concatenated_categorical_column is not "
                "supported — pass the flat list of member columns"
            )
    return ConcatenatedCategoricalColumn(cols)


# ---------------------------------------------------------------- dense-of


@dataclass(frozen=True)
class EmbeddingColumn(FeatureColumn):
    """Categorical ids -> combined embedding rows, from a table the
    ``DenseFeatures`` module owns (``{key}_embedding.embedding``)."""

    categorical_column: CategoricalColumn
    dimension: int
    combiner: str = "mean"
    initializer: Optional[Callable] = None
    trainable: bool = True  # kept for surface parity

    @property
    def key(self) -> str:
        return self.categorical_column.key

    @property
    def output_dim(self) -> int:
        return self.dimension

    def host(self, values):
        return self.categorical_column.host(values)


def embedding_column(categorical_column, dimension, combiner="mean",
                     initializer=None, trainable=True):
    if dimension is None or dimension < 1:
        raise ValueError(f"Invalid dimension {dimension}.")
    if initializer is not None and not callable(initializer):
        raise ValueError("initializer must be callable if specified.")
    if combiner not in ("mean", "sum", "sqrtn"):
        raise ValueError(f"unsupported combiner {combiner!r}")
    if not isinstance(categorical_column, CategoricalColumn):
        raise ValueError("embedding_column needs a categorical column")
    return EmbeddingColumn(
        categorical_column, int(dimension), combiner, initializer,
        trainable,
    )


@dataclass(frozen=True)
class IndicatorColumn(FeatureColumn):
    """Categorical ids -> multi-hot counts (tf indicator_column)."""

    categorical_column: CategoricalColumn

    @property
    def key(self) -> str:
        return self.categorical_column.key

    @property
    def output_dim(self) -> int:
        return self.categorical_column.num_buckets

    def host(self, values):
        return self.categorical_column.host(values)


def indicator_column(categorical_column):
    if not isinstance(categorical_column, CategoricalColumn):
        raise ValueError("indicator_column needs a categorical column")
    return IndicatorColumn(categorical_column)


# ------------------------------------------------------------ composition


def _leaf_columns(col):
    """Walk wrapper columns (embedding/indicator over concatenated) down
    to the columns that actually consume a record entry."""
    if isinstance(col, (EmbeddingColumn, IndicatorColumn)):
        yield from _leaf_columns(col.categorical_column)
    elif isinstance(col, ConcatenatedCategoricalColumn):
        for sub in col.columns:
            yield from _leaf_columns(sub)
    else:
        yield col


def apply_host_transforms(columns, record):
    """Run every column's host-plane transform over a feature dict of
    numpy arrays (the ``dataset_fn`` hook). Wrapper columns recurse to
    their leaves. Returns a new dict keyed by leaf-column key; untouched
    record entries pass through."""
    out = dict(record)
    for col in columns:
        for leaf in _leaf_columns(col):
            out[leaf.key] = leaf.host(record[leaf.key])
    return out


def _column_ids(col, feature_dict):
    if isinstance(col, ConcatenatedCategoricalColumn):
        return col.device_ids(feature_dict)
    ids = col.device_ids(feature_dict[col.key])
    return ids.reshape(ids.shape[0], -1)


class DenseFeatures(nn.Module):
    """Compile a list of columns into one dense (batch, total_dim)
    tensor (the Keras ``DenseFeatures`` role).

    Takes a dict of arrays or tensors (host transforms already
    applied). Column order fixes the concat order; each embedding
    column's table is ``{key}_embedding.embedding`` in ``param_dtype``.
    """

    def __init__(self, columns: Sequence[FeatureColumn],
                 param_dtype=torch.float32):
        super().__init__()
        self.columns = tuple(columns)
        self.param_dtype = param_dtype
        for col in self.columns:
            if isinstance(col, EmbeddingColumn):
                layer = Embedding(col.categorical_column.num_buckets,
                                  col.dimension, combiner=col.combiner,
                                  initializer=col.initializer)
                layer.embedding.data = layer.embedding.data.to(param_dtype)
                self.add_module(f"{col.key}_embedding", layer)
            elif isinstance(col, (NumericColumn, IndicatorColumn)):
                continue
            elif isinstance(col, CategoricalColumn):
                raise ValueError(
                    f"bare categorical column {col.key!r}: wrap it in "
                    "embedding_column(...) or indicator_column(...) "
                    "before DenseFeatures"
                )
            else:
                raise ValueError(f"unsupported column {col!r}")

    def forward(self, features):
        parts = []
        for col in self.columns:
            if isinstance(col, NumericColumn):
                parts.append(col.device(features[col.key]))
            elif isinstance(col, EmbeddingColumn):
                ids = _column_ids(col.categorical_column, features)
                layer = getattr(self, f"{col.key}_embedding")
                weights = torch.ones(ids.shape, dtype=torch.float32,
                                     device=ids.device)
                parts.append(layer(RaggedIds(ids, weights)))
            else:  # IndicatorColumn: multi-hot counts
                ids = _column_ids(col.categorical_column, features)
                parts.append(one_hot(ids, col.output_dim,
                                     self.param_dtype).sum(dim=1))
        return torch.cat(parts, dim=1)
