"""Stable partitioning hashes (copy of
elasticdl_tpu/common/hash_utils.py).

Counterpart of the reference's ``elasticdl/python/common/hash_utils.py`` and
``elasticdl/pkg/ps/checkpoint.go:17-34``: dense variables partition by a
sha256 hash of their name, embedding rows by ``id % n``. The same functions
are used for checkpoint sharding, so a checkpoint written with N shards can be
restored onto M shards deterministically.
"""

import hashlib


def string_to_id(name: str, num_shards: int) -> int:
    """Stable shard index for a named dense variable."""
    if num_shards <= 0:
        raise ValueError("num_shards must be positive")
    digest = hashlib.sha256(name.encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big") % num_shards


def int_to_id(embedding_id: int, num_shards: int) -> int:
    """Stable shard index for an embedding row id."""
    if num_shards <= 0:
        raise ValueError("num_shards must be positive")
    return int(embedding_id) % num_shards
