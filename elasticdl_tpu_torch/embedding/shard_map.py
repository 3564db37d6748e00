"""Explicit, versioned row placement: the shard map (a copy of
elasticdl_tpu/embedding/shard_map.py: numpy only, the same buckets, the
same move algebra and the same JSON, so a port client and a JAX service
exchange maps in ``get_shard_map`` and in a REDIRECT).

- the id space folds into ``NUM_BUCKETS`` **buckets** (``id %
  NUM_BUCKETS``: dense vocab ids spread uniformly, so contiguous
  bucket ranges balance load);
- a ``ShardMap`` assigns disjoint bucket **ranges** covering the whole
  bucket space to shards (indexes into its ``shards`` address list),
  and carries a **monotonic version**: every topology change (range
  moved, shard added, replica set updated) is a new map with a bumped
  version;
- **hot-row read replicas** ride the same map: ``replicas[table][id]``
  lists extra shards that serve reads for that id (writes stay
  single-home).

The movement algebra is pure (``move_range``/``move_shard``/
``add_shard``/``with_replicas`` return new maps); the protocol that
makes a move safe (copy, catch-up, fence, cutover) lives in
``master/row_reshard.py`` (the authority) and
``embedding/row_service.py`` (the shards, which also refresh the
replicas). Servers enforce the map: a pull or push for buckets a shard
does not own under its installed map returns a retryable REDIRECT
carrying the newer map, which is how stale clients converge.
"""

import json
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# The id space folds into this many buckets (id % NUM_BUCKETS). A
# power of two with plenty of headroom: the finest possible split is
# one bucket, so 8192 buckets support far more shards than the row
# plane will see while keeping the owner lookup table 16KB.
NUM_BUCKETS = 8192


def bucket_of(ids) -> np.ndarray:
    """Bucket index per id (vectorized). Non-negative for the int64
    row ids this repo uses everywhere (numpy mod follows the divisor's
    sign, so even a stray negative id lands in [0, NUM_BUCKETS))."""
    return np.asarray(ids, np.int64) % NUM_BUCKETS


class ShardMapError(ValueError):
    pass


def _normalize(ranges: Sequence[Tuple[int, int, int]]):
    """Sort by lo and coalesce adjacent ranges owned by one shard —
    the canonical form equality/serialization use."""
    out: List[Tuple[int, int, int]] = []
    for lo, hi, shard in sorted(
        (int(l), int(h), int(s)) for l, h, s in ranges
    ):
        if out and out[-1][2] == shard and out[-1][1] == lo:
            out[-1] = (out[-1][0], hi, shard)
        else:
            out.append((lo, hi, shard))
    return out


class ShardMap:
    """One immutable placement epoch: bucket ranges → shards, plus the
    hot-row replica sets. Mutators return NEW maps with ``version + 1``
    — the monotonic version is the fencing token every server and
    client compares."""

    def __init__(self, version: int, shards: Sequence[str],
                 ranges: Sequence[Tuple[int, int, int]],
                 replicas: Optional[Dict[str, Dict[int, Tuple[int, ...]]]]
                 = None):
        self.version = int(version)
        self.shards = [str(a) for a in shards]
        self.ranges = _normalize(ranges)
        self.replicas = {
            str(t): {int(i): tuple(int(s) for s in reps)
                     for i, reps in per.items()}
            for t, per in (replicas or {}).items()
        }
        self._owner: Optional[np.ndarray] = None
        self.validate()

    # ---- construction / validation ------------------------------------

    @classmethod
    def bootstrap(cls, shards: Sequence[str]) -> "ShardMap":
        """Version-1 map: the bucket space split into N even contiguous
        ranges (shard s owns [s*B/N, (s+1)*B/N)). Dense vocab ids
        spread uniformly over buckets, so even ranges balance load."""
        shards = list(shards)
        n = len(shards)
        if not n:
            raise ShardMapError("bootstrap needs at least one shard")
        bounds = [round(s * NUM_BUCKETS / n) for s in range(n + 1)]
        return cls(
            1, shards,
            [(bounds[s], bounds[s + 1], s) for s in range(n)
             if bounds[s] < bounds[s + 1]],
        )

    def validate(self):
        if self.version < 1:
            raise ShardMapError(f"version must be >= 1: {self.version}")
        if not self.shards:
            raise ShardMapError("shard map has no shards")
        cursor = 0
        for lo, hi, shard in self.ranges:
            if lo != cursor:
                raise ShardMapError(
                    f"ranges must cover [0, {NUM_BUCKETS}) without "
                    f"gaps/overlap: expected lo={cursor}, got {lo}"
                )
            if hi <= lo:
                raise ShardMapError(f"empty/inverted range ({lo}, {hi})")
            if not 0 <= shard < len(self.shards):
                raise ShardMapError(
                    f"range ({lo}, {hi}) names shard {shard} of "
                    f"{len(self.shards)}"
                )
            cursor = hi
        if cursor != NUM_BUCKETS:
            raise ShardMapError(
                f"ranges cover [0, {cursor}), need [0, {NUM_BUCKETS})"
            )
        for table, per in self.replicas.items():
            for i, reps in per.items():
                for s in reps:
                    if not 0 <= s < len(self.shards):
                        raise ShardMapError(
                            f"replica set for {table}:{i} names shard "
                            f"{s} of {len(self.shards)}"
                        )

    # ---- lookup --------------------------------------------------------

    @property
    def owner_table(self) -> np.ndarray:
        """int32[NUM_BUCKETS] bucket → shard lookup (built lazily, the
        map is immutable)."""
        if self._owner is None:
            owner = np.empty(NUM_BUCKETS, np.int32)
            for lo, hi, shard in self.ranges:
                owner[lo:hi] = shard
            self._owner = owner
        return self._owner

    def home_of_ids(self, ids) -> np.ndarray:
        """Home shard index per id (vectorized)."""
        return self.owner_table[bucket_of(ids)]

    def owns(self, shard: int, ids) -> np.ndarray:
        return self.home_of_ids(ids) == int(shard)

    def ranges_of(self, shard: int) -> List[Tuple[int, int]]:
        return [(lo, hi) for lo, hi, s in self.ranges
                if s == int(shard)]

    def buckets_owned(self, shard: int) -> int:
        return sum(hi - lo for lo, hi in self.ranges_of(shard))

    def replica_targets(self, table: str, row_id: int) -> Tuple[int, ...]:
        per = self.replicas.get(table)
        if not per:
            return ()
        return per.get(int(row_id), ())

    # ---- movement algebra (pure; version + 1) --------------------------

    def _bump(self, ranges=None, shards=None, replicas=None) -> "ShardMap":
        return ShardMap(
            self.version + 1,
            self.shards if shards is None else shards,
            self.ranges if ranges is None else ranges,
            self.replicas if replicas is None else replicas,
        )

    def move_range(self, lo: int, hi: int, target: int) -> "ShardMap":
        """Reassign buckets [lo, hi) to ``target``. The migration
        protocol calls this at CUTOVER — after the bytes moved."""
        lo, hi, target = int(lo), int(hi), int(target)
        if not 0 <= lo < hi <= NUM_BUCKETS:
            raise ShardMapError(f"bad range ({lo}, {hi})")
        if not 0 <= target < len(self.shards):
            raise ShardMapError(f"unknown target shard {target}")
        out = []
        for rlo, rhi, shard in self.ranges:
            left = (rlo, min(rhi, lo), shard)
            right = (max(rlo, hi), rhi, shard)
            for piece in (left, right):
                if piece[1] > piece[0]:
                    out.append(piece)
        out.append((lo, hi, target))
        return self._bump(ranges=out)

    def move_shard(self, source: int, target: int) -> "ShardMap":
        """Reassign EVERY bucket of ``source`` to ``target`` (merge:
        the source keeps its slot in ``shards`` but owns nothing — a
        drained shard can be retired by ops once clients converge)."""
        source, target = int(source), int(target)
        out = [(lo, hi, target if s == source else s)
               for lo, hi, s in self.ranges]
        return self._bump(ranges=out)

    def add_shard(self, addr: str) -> "ShardMap":
        """Append a (initially empty) shard — the split target."""
        if addr in self.shards:
            raise ShardMapError(f"shard {addr} already in the map")
        return self._bump(shards=self.shards + [str(addr)])

    def retire_shard(self, shard: int) -> "ShardMap":
        """Drop a drained shard's slot from the address list (the
        compaction step after a ``merge``): it must own zero buckets
        and appear in no replica set. Every shard index above it
        shifts down one — the authority re-distributes the new epoch
        with each server's new ``shard_id``, and stale clients
        converge through the usual version fencing."""
        shard = int(shard)
        if not 0 <= shard < len(self.shards):
            raise ShardMapError(f"unknown shard {shard}")
        if len(self.shards) < 2:
            raise ShardMapError("cannot retire the last shard")
        if self.buckets_owned(shard):
            raise ShardMapError(
                f"shard {shard} still owns "
                f"{self.buckets_owned(shard)} bucket(s); merge it "
                "away first"
            )
        for table, per in self.replicas.items():
            for i, reps in per.items():
                if shard in reps:
                    raise ShardMapError(
                        f"shard {shard} still replicates "
                        f"{table}:{i}; refresh replicas first"
                    )
        shards = [a for s, a in enumerate(self.shards) if s != shard]
        ranges = [
            (lo, hi, s - 1 if s > shard else s)
            for lo, hi, s in self.ranges
        ]
        replicas = {
            table: {
                i: tuple(s - 1 if s > shard else s for s in reps)
                for i, reps in per.items()
            }
            for table, per in self.replicas.items()
        }
        return self._bump(ranges=ranges, shards=shards,
                          replicas=replicas)

    def split_plan(self, shard: int) -> Tuple[int, int]:
        """The upper half of ``shard``'s largest range — what a split
        migrates away. Raises when the shard owns a single bucket
        (nothing left to split)."""
        ranges = self.ranges_of(shard)
        if not ranges:
            raise ShardMapError(f"shard {shard} owns no buckets")
        lo, hi = max(ranges, key=lambda r: r[1] - r[0])
        if hi - lo < 2:
            raise ShardMapError(
                f"shard {shard}'s largest range ({lo}, {hi}) cannot "
                "split further"
            )
        mid = (lo + hi) // 2
        return mid, hi

    def with_replicas(
        self, replicas: Dict[str, Dict[int, Tuple[int, ...]]]
    ) -> "ShardMap":
        """Replace the hot-row replica assignment wholesale (the
        authority recomputes it from the shards' hot sets)."""
        return self._bump(replicas=replicas)

    # ---- serialization -------------------------------------------------

    def to_json(self) -> dict:
        """Plain-container form (msgpack/json safe; replica dicts as
        pair lists — json objects cannot key on ints)."""
        return {
            "version": self.version,
            "num_buckets": NUM_BUCKETS,
            "shards": list(self.shards),
            "ranges": [list(r) for r in self.ranges],
            "replicas": {
                table: [[i, list(reps)]
                        for i, reps in sorted(per.items())]
                for table, per in sorted(self.replicas.items())
            },
        }

    @classmethod
    def from_json(cls, blob: dict) -> "ShardMap":
        if int(blob.get("num_buckets", NUM_BUCKETS)) != NUM_BUCKETS:
            raise ShardMapError(
                f"map was built over {blob.get('num_buckets')} buckets, "
                f"this build uses {NUM_BUCKETS}"
            )
        return cls(
            blob["version"], blob["shards"],
            [tuple(r) for r in blob["ranges"]],
            {
                table: {int(i): tuple(reps) for i, reps in pairs}
                for table, pairs in (blob.get("replicas") or {}).items()
            },
        )

    def __eq__(self, other):
        return (isinstance(other, ShardMap)
                and self.to_json() == other.to_json())

    def __repr__(self):
        return (
            f"ShardMap(v{self.version}, {len(self.shards)} shards, "
            f"{len(self.ranges)} ranges, "
            f"{sum(len(p) for p in self.replicas.values())} replicated "
            "ids)"
        )


class ClientShardMap:
    """Thread-safe monotonic holder of the newest map a client has
    seen. ``update`` from a REDIRECT payload only ever moves forward —
    two pool threads racing redirects from different shards cannot
    regress the routing epoch."""

    def __init__(self, shard_map: ShardMap):
        self._lock = threading.Lock()
        self._map = shard_map

    def get(self) -> ShardMap:
        with self._lock:
            return self._map

    @property
    def version(self) -> int:
        return self.get().version

    def update(self, map_json: dict) -> bool:
        """Adopt ``map_json`` if it is newer; returns whether the
        routing epoch advanced."""
        fresh = ShardMap.from_json(map_json)
        with self._lock:
            if fresh.version <= self._map.version:
                return False
            self._map = fresh
            return True


def dump_map(shard_map: ShardMap) -> str:
    return json.dumps(shard_map.to_json(), indent=2, sort_keys=True)
