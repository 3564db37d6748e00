"""Host-plane preprocessing: numpy, string-capable record transforms
(the port's own copy of elasticdl_tpu/preprocessing/transforms.py; its
outputs are bit-equal to the JAX package's).

These run inside ``dataset_fn`` on the worker host, before batches
reach the device: strings never reach the card, so string-to-id work
happens here and only integer ids and floats cross to the device
(``CategoryHash``/``CategoryLookup``/``NumericBucket``: the census
model's process layers; ``to_number``: the reference's ``ToNumber``).
"""

import hashlib

import numpy as np


def to_number(values, default, dtype=np.float32):
    """Convert string-ish values to numbers, mapping empty/invalid entries to
    ``default`` (reference ``layers/to_number.py``: ToNumber.call)."""
    arr = np.asarray(values)
    if np.issubdtype(arr.dtype, np.number):
        return arr.astype(dtype)  # already numeric: skip the parse loop
    flat = arr.reshape(-1)
    out = np.empty(flat.shape, dtype)
    for i, value in enumerate(flat):
        if isinstance(value, bytes):
            value = value.decode("utf-8", "replace")
        try:
            out[i] = dtype(value)
        except (TypeError, ValueError):
            out[i] = default
    return out.reshape(arr.shape)


def _stable_string_hash(value) -> int:
    """Process-stable 64-bit string hash (md5-based; python's ``hash`` is
    salted per process, which would desync workers)."""
    if isinstance(value, bytes):
        data = value
    else:
        data = str(value).encode("utf-8")
    return int.from_bytes(hashlib.md5(data).digest()[:8], "little")


class CategoryHash:
    """String/any → bucket id in [0, num_bins) by stable hashing (census
    ``CategoryHash``; Keras ``Hashing`` layer equivalent for the host)."""

    def __init__(self, num_bins: int):
        if num_bins <= 0:
            raise ValueError("num_bins must be positive")
        self.num_bins = num_bins

    def __call__(self, values):
        arr = np.asarray(values)
        flat = arr.reshape(-1)
        out = np.empty(flat.shape, np.int64)
        for i, value in enumerate(flat):
            out[i] = _stable_string_hash(value) % self.num_bins
        return out.reshape(arr.shape)


class CategoryLookup:
    """Vocabulary lookup: value → index, out-of-vocab → ``num_oov_buckets``
    hashed slots after the vocab (census ``CategoryLookup``; Keras
    ``IndexLookup``/``StringLookup`` equivalent)."""

    def __init__(self, vocabulary, num_oov_buckets: int = 1):
        self.vocabulary = list(vocabulary)
        self.num_oov_buckets = max(int(num_oov_buckets), 1)
        self._index = {v: i for i, v in enumerate(self.vocabulary)}

    @property
    def num_buckets(self) -> int:
        return len(self.vocabulary) + self.num_oov_buckets

    def __call__(self, values):
        arr = np.asarray(values)
        flat = arr.reshape(-1)
        out = np.empty(flat.shape, np.int64)
        vocab_size = len(self.vocabulary)
        for i, value in enumerate(flat):
            if isinstance(value, bytes):
                value = value.decode("utf-8", "replace")
            idx = self._index.get(value)
            if idx is None:
                idx = vocab_size + (
                    _stable_string_hash(value) % self.num_oov_buckets
                )
            out[i] = idx
        return out.reshape(arr.shape)


class NumericBucket:
    """Bucketize numeric values by boundaries → id in [0, len(bounds)]
    (census ``NumericBucket``; host twin of ``layers.Discretization``)."""

    def __init__(self, boundaries):
        self.boundaries = np.asarray(sorted(boundaries), np.float64)

    @property
    def num_buckets(self) -> int:
        return len(self.boundaries) + 1

    def __call__(self, values):
        arr = to_number(values, default=0.0, dtype=np.float64)
        return np.searchsorted(
            self.boundaries, arr, side="right"
        ).astype(np.int64)
