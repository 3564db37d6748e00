"""ctypes wrappers of the C++ row store: ``NativeEmbeddingTable`` and
``NativeOptimizerWrapper`` (port of elasticdl_tpu/native/row_store.py).

Drop-in replacements for the pure-Python host tier
(``embedding/table.EmbeddingTable``,
``embedding/optimizer.HostOptimizerWrapper``) with the row map, lazy
init and fused optimizer updates in C++ (``native/row_store.cc``, the
same source as the JAX package's, so both give bit-equal lazy rows for
the same name and ids). ``make_host_table`` / ``make_host_optimizer``
pick the native implementation when the library loaded, else fall
back, so call sites never branch.

Init determinism: each implementation is deterministic per (name, id),
but the two hash differently; a table must not move between them
mid-job without a checkpoint (``set`` rows round-trip exactly either
way). A tiered table (``storage/tiered.py``) wraps a native one as its
hot tier: ``NativeOptimizerWrapper`` runs the fused kernels against
``hot_inner`` between the tier group's ``fault_for_apply`` and
``finish_apply``, and takes slot tables from the primary's group.
"""

import contextlib
import ctypes
from typing import Dict, Iterable

import numpy as np

from elasticdl_tpu_torch.embedding.layer import EMBEDDING_INIT_SCALE
from elasticdl_tpu_torch.embedding.optimizer import (
    SGD,
    Adagrad,
    Adam,
    AdamAmsgrad,
    HostOptimizerWrapper,
    Momentum,
    RowOptimizer,
    slot_init_value,
    wrapper_state_tables,
)
from elasticdl_tpu_torch.embedding.table import (
    EmbeddingTable,
    get_slot_table_name,
)
from elasticdl_tpu_torch.native import get_lib, native_available


def _seed(name: str) -> int:
    import zlib

    return zlib.crc32(name.encode("utf-8"))


def _ids_arr(ids) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(list(ids), np.int64))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeEmbeddingTable:
    """``EmbeddingTable``'s surface, C++-backed, float32 only.

    Dirty-row tracking lives on the Python side (a set of ids): the C++
    arena does not report which rows a ``get`` materialised, so a
    ``get`` that grew the store marks every requested id. The fused
    optimizer kernels bypass ``set``, so ``NativeOptimizerWrapper``
    marks the applied ids itself. Tracking is OFF until a checkpoint
    consumer enables it.
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
        if np.dtype(dtype) != np.float32:
            raise TypeError("NativeEmbeddingTable is float32-only")
        if not (is_slot or initializer in ("uniform", "zeros")):
            raise ValueError(
                f"NativeEmbeddingTable has no {initializer!r} initializer "
                "(uniform/zeros only); use the Python EmbeddingTable"
            )
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self.name = name
        self.dim = int(dim)
        self.initializer = initializer
        self.is_slot = is_slot
        self.slot_init_value = float(slot_init_value)
        self.dtype = np.dtype(np.float32)
        const_init = is_slot or initializer == "zeros"
        self._h = self._lib.rs_create(
            self.dim,
            _seed(name),
            1 if const_init else 0,
            EMBEDDING_INIT_SCALE,
            self.slot_init_value if const_init else 0.0,
        )
        self._dirty: set = set()
        self._track_dirty = False

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.rs_destroy(h)
            self._h = None

    def get(self, ids: Iterable[int]) -> np.ndarray:
        ids = _ids_arr(ids)
        out = np.empty((ids.size, self.dim), np.float32)
        before = self.created_count
        self._lib.rs_get(self._h, _i64p(ids), ids.size, _f32p(out))
        if self._track_dirty and self.created_count != before:
            # At least one requested row materialised; which ones is
            # invisible from here, so mark them all.
            self._dirty.update(ids.tolist())
        return out

    def set(self, ids: Iterable[int], values: np.ndarray) -> None:
        ids = _ids_arr(ids)
        values = np.ascontiguousarray(values, np.float32)
        self._lib.rs_set(self._h, _i64p(ids), ids.size, _f32p(values))
        if self._track_dirty:
            self._dirty.update(ids.tolist())

    @property
    def num_rows(self) -> int:
        """Rows in the store."""
        return int(self._lib.rs_num_rows(self._h))

    @property
    def created_count(self) -> int:
        """Monotonic count of row materialisations: unlike ``num_rows``
        it never falls, so it stays exact when ``erase`` frees slots
        that a later ``get`` reuses."""
        return int(self._lib.rs_created_count(self._h))

    def erase(self, ids) -> int:
        """Drop rows; absent ids are ignored. Returns the number erased
        (see ``EmbeddingTable.erase``)."""
        ids = _ids_arr(ids)
        erased = int(self._lib.rs_erase(self._h, _i64p(ids), ids.size))
        if self._dirty:
            self._dirty.difference_update(ids.tolist())
        return erased

    def contains(self, ids) -> np.ndarray:
        """Bool membership mask, without materialising anything."""
        ids = _ids_arr(ids)
        out = np.zeros((ids.size,), np.uint8)
        self._lib.rs_contains(
            self._h, _i64p(ids), ids.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out.astype(bool)

    def all_ids(self) -> np.ndarray:
        """Every materialised id, sorted (the C++ store exports ids with
        their rows, so this reads the rows too)."""
        return self.to_arrays()[0]

    def to_arrays(self):
        n = self.num_rows
        ids = np.empty((n,), np.int64)
        rows = np.empty((n, self.dim), np.float32)
        if n:
            self._lib.rs_export(self._h, _i64p(ids), _f32p(rows))
            order = np.argsort(ids, kind="stable")
            ids, rows = ids[order], rows[order]
        return ids, rows

    @classmethod
    def from_arrays(cls, name, ids, rows, **kwargs):
        table = cls(name, rows.shape[1] if rows.ndim == 2 else 0, **kwargs)
        if len(ids):
            table.set(ids, rows)
        return table

    # ---- dirty-row tracking (incremental checkpoints) -----------------

    @property
    def supports_dirty_rows(self) -> bool:
        return self._track_dirty

    def enable_dirty_tracking(self) -> None:
        self._track_dirty = True

    @property
    def dirty_count(self) -> int:
        return len(self._dirty)

    def dirty_arrays(self):
        """(ids, rows) touched since the last drain, sorted; clears the
        set."""
        if not self._dirty:
            return (np.zeros((0,), np.int64),
                    np.zeros((0, self.dim), np.float32))
        ids = np.array(sorted(self._dirty), np.int64)
        self._dirty.clear()
        out = np.empty((ids.size, self.dim), np.float32)
        self._lib.rs_get(self._h, _i64p(ids), ids.size, _f32p(out))
        return ids, out

    def mark_dirty(self, ids) -> None:
        if self._track_dirty:
            self._dirty.update(int(i) for i in np.asarray(ids).ravel())

    def clear_dirty(self) -> None:
        self._dirty.clear()


class NativeOptimizerWrapper:
    """``HostOptimizerWrapper``'s twin calling the fused C++ row
    updates."""

    def __init__(self, opt: RowOptimizer):
        self.opt = opt
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._slot_tables: Dict[str, NativeEmbeddingTable] = {}
        self._steps: Dict[str, int] = {}

    def _slot_table(self, table, slot_name: str):
        key = get_slot_table_name(table.name, slot_name)
        if key not in self._slot_tables:
            make = getattr(table, "make_slot_table", None)
            if make is not None:
                # A tiered primary makes its slots in its own TierGroup
                # (lockstep demotion and faults; see HostOptimizerWrapper).
                self._slot_tables[key] = make(
                    key, slot_init_value(self.opt, slot_name)
                )
                return self._slot_tables[key]
            st = NativeEmbeddingTable(
                key,
                table.dim,
                is_slot=True,
                slot_init_value=slot_init_value(self.opt, slot_name),
            )
            if getattr(table, "supports_dirty_rows", False):
                st.enable_dirty_tracking()
            self._slot_tables[key] = st
        return self._slot_tables[key]

    def apply_gradients(self, table, ids, grads):
        ids = _ids_arr(ids)
        if np.unique(ids).size != ids.size:
            raise ValueError("ids must be deduplicated before apply")
        # A tiered table wraps the native arena as its hot tier: the
        # fused kernels run against ``hot_inner`` after a fault has
        # promoted every applied row and its slot rows hot (a kernel's
        # lazy get-or-create on an evicted slot row would silently reset
        # optimizer state to its init value).
        tiered = hasattr(table, "fault_for_apply")
        hot = table.hot_inner if tiered else table
        if not isinstance(hot, NativeEmbeddingTable):
            raise TypeError(
                "NativeOptimizerWrapper needs a NativeEmbeddingTable "
                "(or a TieredTable whose hot tier is one)"
            )
        grads = np.ascontiguousarray(grads, np.float32)
        step = self._steps.get(table.name, 0) + 1
        self._steps[table.name] = step
        opt, lib, n = self.opt, self._lib, ids.size
        slots = {name: self._slot_table(table, name)
                 for name in opt.slot_names}
        # The kernels write the hot arena with the GIL released (ctypes):
        # the GROUP lock is held across fault, kernel and bookkeeping, or
        # a concurrent handler's prefault or sweep could grow or erase
        # the same open-addressed arena mid-kernel. The budget sweep runs
        # after the release: no cold-tier write happens under this lock.
        guard = (table.tier_group.lock if tiered
                 else contextlib.nullcontext())
        with guard:
            if tiered:
                table.fault_for_apply(
                    ids, slot_tables=list(slots.values())
                )

            def _h(t):
                return (t.hot_inner if tiered else t)._h

            ip, gp = _i64p(ids), _f32p(grads)
            if isinstance(opt, Momentum):
                lib.rs_momentum(
                    _h(table), _h(slots["momentum"]),
                    ip, n, gp, opt.lr, opt.momentum, int(opt.nesterov),
                )
            elif isinstance(opt, (Adam, AdamAmsgrad)):
                max_h = _h(slots["max_v"]) if opt.amsgrad else None
                lib.rs_adam(
                    _h(table), _h(slots["m"]), _h(slots["v"]),
                    max_h, ip, n, gp,
                    opt.lr, opt.beta1, opt.beta2, opt.epsilon, step,
                )
            elif isinstance(opt, Adagrad):
                lib.rs_adagrad(
                    _h(table), _h(slots["accumulator"]),
                    ip, n, gp, opt.lr, opt.epsilon,
                )
            elif isinstance(opt, SGD):
                lib.rs_sgd(_h(table), ip, n, gp, opt.lr)
            else:
                raise ValueError(f"No native kernel for {opt.name}")
            if tiered:
                # Applied ids are hot now and their cold records stale;
                # the sweep waits until the lock is released.
                table.finish_apply(
                    ids, slot_tables=list(slots.values()), _sweep=False
                )
            # The fused kernels write rows and slots inside C++,
            # bypassing set(): mark the applied ids so delta checkpoints
            # see them.
            if table.supports_dirty_rows:
                table.mark_dirty(ids)
                for slot in slots.values():
                    slot.mark_dirty(ids)
        if tiered and not table.defer_apply_sweep:
            table.maybe_sweep()
        return table

    def state_tables(self, main_tables: Dict) -> Dict:
        """Slot tables + step counters for checkpointing (shared with
        the Python wrapper)."""
        return wrapper_state_tables(self, main_tables)


def make_host_table(name: str, dim: int, dtype=np.float32, **kwargs):
    """Native table when available + float32 + a supported initializer
    (uniform/zeros/slot-constant), else the Python one."""
    supported_init = kwargs.get("is_slot", False) or kwargs.get(
        "initializer", "uniform"
    ) in ("uniform", "zeros")
    if (
        native_available()
        and np.dtype(dtype) == np.float32
        and supported_init
    ):
        return NativeEmbeddingTable(name, dim, dtype=dtype, **kwargs)
    return EmbeddingTable(name, dim, dtype=dtype, **kwargs)


def make_host_optimizer(opt: RowOptimizer):
    if native_available() and type(opt) in (
        SGD, Momentum, Adam, AdamAmsgrad, Adagrad,
    ):
        return NativeOptimizerWrapper(opt)
    return HostOptimizerWrapper(opt)
