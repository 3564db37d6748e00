"""Host-side lazy embedding table of the host tier (port of
elasticdl_tpu/embedding/table.py).

A dict id -> 1-D numpy row, materialised on first ``get`` with a
deterministic initializer, plus constant-initialised slot-table
variants for optimizer state. This tier backs tables too large for the
card's memory: rows are pulled into the device batch per step and
their gradients applied back on the host
(``embedding/host_engine.py``).

Rows initialise from (table name, id) with numpy's ``RandomState``
exactly as the JAX package's table does, so the two give bit-equal
rows for the same name and ids.
"""

from typing import Dict, Iterable

import numpy as np

from elasticdl_tpu_torch.embedding.layer import EMBEDDING_INIT_SCALE


def get_slot_table_name(table_name: str, slot_name: str) -> str:
    """The reference parameter server's slot-table naming."""
    return f"{table_name}-{slot_name}"


def _row_seed(name: str, row_id: int) -> int:
    import zlib

    return (zlib.crc32(name.encode("utf-8")) * 2654435761 + int(row_id)) % (
        2**32
    )


def supports_dirty_rows(table) -> bool:
    """Whether a table-like view can serve incremental (delta)
    checkpoints: it tracks the rows touched since the last drain.
    Checkpoint adapters (step counters) report False and are captured
    in full."""
    return bool(getattr(table, "supports_dirty_rows", False))


class EmbeddingTable:
    """Lazy id->row store with deterministic per-row init.

    Tracks **dirty rows** (ids materialised or written since the last
    ``dirty_arrays`` drain) so a delta checkpoint moves only the working
    set. Reads of existing rows stay free: only a first materialisation
    or a ``set`` marks. Tracking is OFF until a checkpoint consumer
    enables it: without a drain the marked-ids set would grow to every
    touched row for nothing.
    """

    def __init__(
        self,
        name: str,
        dim: int,
        initializer: str = "uniform",
        is_slot: bool = False,
        slot_init_value: float = 0.0,
        dtype=np.float32,
    ):
        self.name = name
        self.dim = int(dim)
        self.initializer = initializer
        self.is_slot = is_slot
        self.slot_init_value = float(slot_init_value)
        self.dtype = np.dtype(dtype)
        self.vectors: Dict[int, np.ndarray] = {}
        self._dirty: set = set()
        self._track_dirty = False

    def _init_row(self, row_id: int) -> np.ndarray:
        if self.is_slot or self.initializer == "zeros":
            return np.full((self.dim,), self.slot_init_value, self.dtype)
        rng = np.random.RandomState(_row_seed(self.name, row_id))
        if self.initializer == "normal":
            return rng.normal(0.0, 0.05, self.dim).astype(self.dtype)
        return rng.uniform(
            -EMBEDDING_INIT_SCALE, EMBEDDING_INIT_SCALE, self.dim
        ).astype(self.dtype)

    def get(self, ids: Iterable[int]) -> np.ndarray:
        """Batch lookup; lazily initialises unseen rows."""
        ids = list(ids)
        out = np.empty((len(ids), self.dim), self.dtype)
        for i, row_id in enumerate(ids):
            row = self.vectors.get(int(row_id))
            if row is None:
                row = self._init_row(int(row_id))
                self.vectors[int(row_id)] = row
                # A lazily created row must ride the next delta.
                if self._track_dirty:
                    self._dirty.add(int(row_id))
            out[i] = row
        return out

    def set(self, ids: Iterable[int], values: np.ndarray) -> None:
        values = np.asarray(values, self.dtype)
        for i, row_id in enumerate(ids):
            self.vectors[int(row_id)] = values[i].copy()
            if self._track_dirty:
                self._dirty.add(int(row_id))

    def erase(self, ids) -> int:
        """Drop rows; absent ids are ignored. Returns the number erased.
        Erased ids leave the dirty set: their bytes are gone, and a
        later dirty drain re-reading them through ``get`` would bring
        them back as fresh lazy rows."""
        erased = 0
        for row_id in ids:
            if self.vectors.pop(int(row_id), None) is not None:
                erased += 1
            self._dirty.discard(int(row_id))
        return erased

    def contains(self, ids) -> np.ndarray:
        """Bool membership mask, without materialising anything."""
        return np.array([int(i) in self.vectors for i in ids], bool)

    def all_ids(self) -> np.ndarray:
        """Every materialised id, sorted, without reading row bytes (the
        row service's range scans for a live migration and its erase
        sweep after a new shard map)."""
        return np.array(sorted(self.vectors), np.int64)

    def peek(self, ids) -> np.ndarray:
        """Read existing rows without materialising or dirtying them:
        what a live migration streams. An absent id raises ``KeyError``
        (the caller enumerated the ids, so absence is a logic error)."""
        out = np.empty((len(list(ids)), self.dim), self.dtype)
        for i, row_id in enumerate(ids):
            out[i] = self.vectors[int(row_id)]
        return out

    @property
    def num_rows(self) -> int:
        return len(self.vectors)

    # ---- dirty-row tracking (incremental checkpoints) -----------------

    @property
    def supports_dirty_rows(self) -> bool:
        """True once a checkpoint consumer enabled tracking."""
        return self._track_dirty

    def enable_dirty_tracking(self) -> None:
        self._track_dirty = True

    @property
    def dirty_count(self) -> int:
        return len(self._dirty)

    def dirty_arrays(self):
        """(ids, rows) of rows touched since the last drain, sorted by
        id, and CLEAR the dirty set."""
        if not self._dirty:
            return (np.zeros((0,), np.int64),
                    np.zeros((0, self.dim), self.dtype))
        ids = np.array(sorted(self._dirty), np.int64)
        self._dirty.clear()
        rows = np.stack([self.vectors[int(i)] for i in ids])
        return ids, rows

    def mark_dirty(self, ids) -> None:
        if self._track_dirty:
            self._dirty.update(int(i) for i in np.asarray(ids).ravel())

    def clear_dirty(self) -> None:
        """Forget tracked dirt (after a restore refill)."""
        self._dirty.clear()

    def to_arrays(self):
        """(ids, rows) sorted by id: the checkpoint serialisation unit."""
        if not self.vectors:
            return (np.zeros((0,), np.int64),
                    np.zeros((0, self.dim), self.dtype))
        ids = np.array(sorted(self.vectors), np.int64)
        rows = np.stack([self.vectors[int(i)] for i in ids])
        return ids, rows

    @classmethod
    def from_arrays(cls, name, ids, rows, **kwargs):
        table = cls(name, rows.shape[1] if rows.ndim == 2 else 0, **kwargs)
        for row_id, row in zip(ids, rows):
            table.vectors[int(row_id)] = np.asarray(row, table.dtype)
        return table
