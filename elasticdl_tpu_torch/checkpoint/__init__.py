"""Sharded checkpoint/restore with cross-N repartitioning (port of
elasticdl_tpu/checkpoint: the same shard files and chain layout, written
from torch state).

Counterpart of ``elasticdl/python/common/save_utils.py:70-271`` and the Go
PS checkpoint (``elasticdl/pkg/ps/checkpoint.go``).
"""

from elasticdl_tpu_torch.checkpoint.hooks import (
    CheckpointHook,
    restore_from_dir,
)
from elasticdl_tpu_torch.checkpoint.saver import CheckpointSaver
from elasticdl_tpu_torch.checkpoint.state_io import (
    CorruptCheckpointError,
    named_leaves_from_state,
    restore_state_from_named_leaves,
)
from elasticdl_tpu_torch.checkpoint.writer import CheckpointWriter

__all__ = [
    "CheckpointHook",
    "CheckpointSaver",
    "CheckpointWriter",
    "CorruptCheckpointError",
    "named_leaves_from_state",
    "restore_from_dir",
    "restore_state_from_named_leaves",
]
