"""Tiered row storage and the row plane's write-ahead log (port of
elasticdl_tpu/storage/): hot rows in the native/Python arena, cold rows
spilled to CRC-framed disk segments, and acked pushes logged ahead of
checkpoints.

- ``cold_store.ColdRowStore``: the disk tier, append-only segment
  files of length-prefixed CRC32-framed row records, an in-memory
  id→(segment, offset) index, and compaction of low-live segments.
- ``tiered.TieredTable`` / ``tiered.TierGroup``: the two-tier table
  behind ``EmbeddingTable``/``NativeEmbeddingTable``: a configurable
  hot-row budget with recency-driven admission/eviction, optimizer slot
  tables demoting/promoting in lockstep with their primary, and dirty
  tracking that spans both tiers so delta checkpoints stay correct.
- ``pushlog.PushLog``: the row plane's zero-RPO write-ahead log:
  group-committed CRC-framed records of applied pushes, replayed
  through the normal apply path on relaunch, truncation fenced to
  durable checkpoint publish.

The files of each are the JAX package's bytes: either package opens
the other's cold stores and replays the other's logs. Nothing here
touches CUDA.
"""

from elasticdl_tpu_torch.storage.cold_store import (  # noqa: F401
    ColdRowStore,
    ColdStoreError,
)
from elasticdl_tpu_torch.storage.pushlog import (  # noqa: F401
    PushLog,
    PushLogError,
)
from elasticdl_tpu_torch.storage.tiered import (  # noqa: F401
    TierGroup,
    TierPolicy,
    TieredTable,
    tier_host_tables,
)
