"""Two-tier row store: hot arena + cold disk, recency-managed (port of
elasticdl_tpu/storage/tiered.py).

The beyond-RAM embedding table. A ``TieredTable`` wraps an existing
host table (``EmbeddingTable`` or ``NativeEmbeddingTable`` — the **hot
tier**, bounded by a configurable row budget) over a ``ColdRowStore`` (the
**cold tier**). Every ``get``/``set``/fused-apply touch promotes its
rows hot and bumps their recency; when the hot tier exceeds budget, an
LRU sweep demotes the least-recently-touched rows to disk. The miss
path is batched: one ``get`` faults ALL its cold ids in a single
cold-tier read (misses counted per pull, not per row), and the host
engine's pull-ahead (``--host_prefetch_depth``) runs that fault off
the step's critical path: a warm working set never blocks on disk.

**Slot lockstep** — optimizer slot tables join their primary's
``TierGroup`` (one recency map, one budget, one lock): a demoted row
takes its momentum/m/v/accumulator rows with it, and a fault brings
them back, so optimizer state never lazily re-initializes behind a
live row.

**Dirty tracking spans both tiers** — the tier wrapper owns the dirty
set (the inner tables' own tracking stays off): demoting a dirty row
flushes its bytes through to the cold store but keeps the mark, and
``dirty_arrays`` reads each drained id from whichever tier holds it —
delta checkpoints see every mutated row exactly once regardless of
where eviction put it.

**Consistency** — the cold store is a spill cache; checkpoints own
durability. Rows round-trip demote→fault byte-exactly (raw float32),
so a tiered table's checkpoint payload is byte-identical to its
untiered twin's.
"""

import threading
import weakref
from typing import Callable, Dict, List, Optional

import numpy as np

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.storage.cold_store import ColdRowStore

logger = get_logger("tiered")


# ---- chaos seam (installed by chaos/tiered_drill.py) --------------------
# _pre_erase_hook(table_name, ids): during a demotion, after the rows
# were written to the cold store but BEFORE they are erased from the
# hot arena — the window a kill-mid-eviction drill targets.
_pre_erase_hook: Optional[Callable] = None


def set_chaos_hooks(pre_erase: Optional[Callable] = None):
    global _pre_erase_hook
    _pre_erase_hook = pre_erase


class TierPolicy:
    """Knobs for one tier group (one primary table + its slots)."""

    def __init__(self, hot_budget_rows: int,
                 segment_max_bytes: int = 8 << 20,
                 compact_live_fraction: float = 0.5,
                 background_compact: bool = True):
        if int(hot_budget_rows) < 1:
            raise ValueError("hot_budget_rows must be >= 1")
        self.hot_budget_rows = int(hot_budget_rows)
        self.segment_max_bytes = int(segment_max_bytes)
        self.compact_live_fraction = float(compact_live_fraction)
        self.background_compact = bool(background_compact)


# Live groups for the process-wide tier gauges (hot/cold occupancy
# must survive engine/service reconstruction without double counting).
_live_groups = weakref.WeakSet()
_metrics_bound = False
_metrics_lock = threading.Lock()


def _bind_metrics(registry):
    global _metrics_bound
    with _metrics_lock:
        if _metrics_bound:
            return
        _metrics_bound = True

        def _sum(attr):
            total = 0
            for group in list(_live_groups):
                total += getattr(group, attr)()
            return float(total)

        registry.gauge(
            "row_tier_hot_rows",
            "Rows resident in the hot (in-memory) tier across primary "
            "tables",
        ).set_function(lambda: _sum("hot_rows"))
        registry.gauge(
            "row_tier_cold_rows",
            "Rows resident ONLY in the cold (disk) tier across "
            "primary tables",
        ).set_function(lambda: _sum("cold_only_rows"))


class TierGroup:
    """A primary ``TieredTable`` plus its optimizer-slot tables,
    sharing one lock, one recency map, and one hot-row budget (applied
    to the primary; slots demote/promote in lockstep — a slot's own
    overage, e.g. after a bulk restore fill, sheds exactly the rows
    whose primary is cold)."""

    def __init__(self, name: str, policy: TierPolicy, cold_dir: str,
                 inner_factory, metrics_registry=None):
        import os

        from elasticdl_tpu_torch.observability import default_registry

        self.name = name
        self.policy = policy
        self.cold_dir = cold_dir
        self._inner_factory = inner_factory
        self.lock = threading.RLock()
        self._recency: Dict[int, int] = {}
        self._tick = 0
        # Victim candidate buffer: ONE O(hot) argpartition scan picks
        # the globally-oldest rows, consumed oldest-first over many
        # sweeps (amortized O(victims)/sweep instead of O(hot)).
        # Entries are validated at use — a row touched after the scan
        # (recency past ``_victim_tick``) or no longer hot is skipped,
        # so selection stays EXACT LRU: a recently-touched working set
        # is never evicted ahead of colder rows.
        self._victim_buf: List[int] = []
        self._victim_tick = 0
        # Bumped on every demotion/erase: the lock-free prefault read
        # path re-resolves when placement changed under its disk read.
        self._epoch = 0
        self.primary: Optional[TieredTable] = None
        self.slots: Dict[str, "TieredTable"] = {}
        self._registry = metrics_registry or default_registry()
        self._m_faults = self._registry.counter(
            "row_tier_faults_total",
            "Cold-tier fault events (batched per pull, not per row)",
        )
        self._m_fault_rows = self._registry.counter(
            "row_tier_fault_rows_total",
            "Rows promoted hot by cold-tier faults",
        )
        self._m_evictions = self._registry.counter(
            "row_tier_evictions_total",
            "Primary rows demoted to the cold tier",
        )
        self._m_fault_secs = self._registry.histogram(
            "row_tier_fault_seconds",
            "Batched cold-tier read latency per faulting pull",
        )
        self._os = os
        _bind_metrics(self._registry)
        _live_groups.add(self)

    def _make_member(self, member_name: str, inner,
                     primary: bool) -> "TieredTable":
        if np.dtype(getattr(inner, "dtype", np.float32)) != np.float32:
            raise TypeError(
                "TieredTable is float32-only (the cold tier stores "
                f"raw float32 rows); table {member_name!r} is "
                f"{np.dtype(inner.dtype)}"
            )
        cold = ColdRowStore(
            self._os.path.join(
                self.cold_dir, member_name.replace("/", "_")
            ),
            dim=int(inner.dim),
            segment_max_bytes=self.policy.segment_max_bytes,
            compact_live_fraction=self.policy.compact_live_fraction,
            background_compact=self.policy.background_compact,
            metrics_registry=self._registry,
        )
        table = TieredTable(self, inner, cold, primary=primary)
        if primary:
            self.primary = table
        return table

    def make_primary(self, inner) -> "TieredTable":
        if self.primary is not None:
            raise ValueError(f"group {self.name} already has a primary")
        return self._make_member(inner.name, inner, primary=True)

    def make_slot(self, key: str, slot_init_value: float = 0.0
                  ) -> "TieredTable":
        """Create (or return) the tiered slot table ``key`` — the
        ``make_slot_table`` seam the optimizer wrappers call so slots
        land in the SAME group as their primary."""
        with self.lock:
            if key in self.slots:
                return self.slots[key]
            inner = self._inner_factory(
                key, self.primary.dim, is_slot=True,
                slot_init_value=float(slot_init_value),
            )
            table = self._make_member(key, inner, primary=False)
            if self.primary is not None and self.primary._track_dirty:
                # A slot created after checkpointing was configured
                # inherits tracking from its primary, or its rows
                # would never ride a delta.
                table.enable_dirty_tracking()
            self.slots[key] = table
            return table

    # ---- recency / sweep ----------------------------------------------

    # Rows demoted per lock acquisition: bounds how long one sweep
    # chunk can stall a pull/push waiting on the group lock.
    SWEEP_CHUNK = 128

    def touch(self, id_list: List[int]):
        """One tick per touched batch: recency is batch-granular (the
        LRU signal the ROADMAP calls ready-made — finer grain buys
        nothing at sweep time and costs a counter bump per row).
        Takes a plain int list so the C-speed bulk dict update needs
        no per-id conversion."""
        self._tick += 1
        self._recency.update(dict.fromkeys(id_list, self._tick))

    def members(self) -> List["TieredTable"]:
        out = [self.primary] if self.primary is not None else []
        out.extend(self.slots.values())
        return out

    def sweep(self):
        """Enforce the hot budget: demote the least-recently-touched
        primary rows (slots follow in lockstep), then sweep any member
        whose own hot set still exceeds budget (bulk restore can fill
        a slot past it without touching the primary).

        Must be called WITHOUT the group lock held: demotion runs in
        ``SWEEP_CHUNK``-row chunks with the lock dropped in between,
        so a concurrent pull/push waits at most one chunk's disk
        write, never a full sweep."""
        budget = self.policy.hot_budget_rows
        # Unlocked fast path: every handler sweeps after every
        # pull/push, and almost all of those are within budget — don't
        # pay a group-lock acquisition (and a stall behind a faulting
        # peer) to discover that. A promotion racing this check is
        # swept by its own handler's sweep.
        primary = self.primary
        if primary is None:
            return
        # list() is one GIL-atomic copy; iterating the live dict here
        # would race make_slot's insert on another handler thread.
        slots = list(self.slots.values())
        if (len(primary._hot) <= budget
                and all(len(m._hot) <= budget for m in slots)):
            return
        while True:
            with self.lock:
                primary = self.primary
                if primary is None:
                    break
                over = len(primary._hot) - budget
                if over <= 0:
                    break
                victims = self._victims(min(over, self.SWEEP_CHUNK))
                if not victims.size:
                    break
                for member in self.members():
                    member._demote(victims)
                self._m_evictions.inc(int(victims.size))
                for v in victims.tolist():
                    self._recency.pop(v, None)
        with self.lock:
            primary = self.primary
            for member in self.members():
                over = len(member._hot) - budget
                if over <= 0:
                    continue
                if member is primary:
                    victims = self._pick_victims(member, over)
                    member._demote(victims)
                    self._m_evictions.inc(int(victims.size))
                else:
                    # Lockstep, not recency: a slot over budget (an
                    # apply whose batch exceeds the budget re-promotes
                    # every id mid-flight) sheds exactly the rows whose
                    # primary is already cold — an independent recency
                    # pick here would choose different victims than the
                    # primary's clock did and the hot sets would
                    # diverge. |slot ∩ primary| <= budget after the
                    # primary sweep above, so this always clears the
                    # overage.
                    extras = member._hot - primary._hot
                    member._demote(
                        np.fromiter(extras, np.int64, len(extras))
                    )

    def _victims(self, count: int) -> np.ndarray:
        """Oldest hot primary rows (held lock), from the amortized
        candidate buffer. A buffered id that was touched after the
        scan, or demoted/erased out-of-band, is dropped at pop time;
        an exhausted buffer triggers ONE rescan per call."""
        hot = self.primary._hot
        recency = self._recency
        victims: List[int] = []
        rebuilt = False
        while len(victims) < count:
            buf = self._victim_buf
            while buf and len(victims) < count:
                vid = buf.pop()
                if (vid in hot
                        and recency.get(vid, 0) <= self._victim_tick):
                    victims.append(vid)
            if len(victims) >= count or rebuilt:
                break
            rebuilt = True
            self._rebuild_victim_buf(set(victims))
            if not self._victim_buf:
                break
        return np.array(victims, np.int64)

    def _rebuild_victim_buf(self, exclude: set):
        """Refill the candidate buffer with the ``max(4*SWEEP_CHUNK,
        64)`` oldest hot rows (one argpartition over the hot set,
        amortized over the sweeps that consume it), newest candidate
        first so ``pop()`` yields oldest."""
        pool = (self.primary._hot - exclude if exclude
                else self.primary._hot)
        if not pool:
            self._victim_buf = []
            return
        ids = np.fromiter(pool, np.int64, len(pool))
        recency = self._recency
        ticks = np.fromiter(
            (recency.get(int(i), 0) for i in ids), np.int64, ids.size
        )
        take = min(ids.size, max(4 * self.SWEEP_CHUNK, 64))
        if take < ids.size:
            part = np.argpartition(ticks, take - 1)[:take]
            ids, ticks = ids[part], ticks[part]
        order = np.argsort(ticks, kind="stable")[::-1]
        self._victim_buf = ids[order].tolist()
        self._victim_tick = self._tick

    def _pick_victims(self, member: "TieredTable", count: int,
                      exclude: Optional[set] = None) -> np.ndarray:
        pool = member._hot if not exclude else member._hot - exclude
        count = min(count, len(pool))
        if count <= 0:
            return np.zeros((0,), np.int64)
        ids = np.fromiter(pool, np.int64, len(pool))
        recency = self._recency
        ticks = np.array([recency.get(int(i), 0) for i in ids])
        if count >= ids.size:
            return ids
        take = np.argpartition(ticks, count - 1)[:count]
        return ids[take]

    # ---- gauges --------------------------------------------------------

    def hot_rows(self) -> int:
        return len(self.primary._hot) if self.primary is not None else 0

    def cold_only_rows(self) -> int:
        if self.primary is None:
            return 0
        p = self.primary
        return p._cold.num_rows - len(p._hot_in_cold)

    def stats(self) -> dict:
        with self.lock:
            out = {
                "hot_rows": self.hot_rows(),
                "cold_rows": self.cold_only_rows(),
                "budget": self.policy.hot_budget_rows,
                "members": {},
            }
            for member in self.members():
                out["members"][member.name] = {
                    "hot": len(member._hot),
                    "cold_only": member._cold.num_rows
                    - len(member._hot_in_cold),
                    "cold_store": member._cold.stats(),
                }
            return out

    def close(self):
        for member in self.members():
            member._cold.close()


class TieredTable:
    """EmbeddingTable-surface view over (hot inner table, cold store).

    Membership bookkeeping lives here, not in the inner table: every
    id flows through ``get``/``set``/the fused-apply seam, so the
    wrapper always knows which rows are hot (``_hot``), which hot rows
    still have a live, up-to-date cold record (``_hot_in_cold`` /
    ``_cold_clean`` — a clean demotion of those skips the disk write),
    and which rows were mutated since the last dirty drain
    (``_dirty`` — spanning both tiers).
    """

    concurrent_safe = False

    def __init__(self, group: TierGroup, inner, cold: ColdRowStore,
                 primary: bool):
        self._group = group
        self._inner = inner
        self._cold = cold
        self._primary = primary
        self._hot: set = set()
        # Hot ids with a live cold record at all (stale or not) —
        # cold-only row accounting.
        self._hot_in_cold: set = set()
        # Hot ids whose cold record matches the hot bytes (set at
        # fault time, cleared on any write): their demotion skips the
        # cold append entirely.
        self._cold_clean: set = set()
        self._dirty: set = set()
        self._track_dirty = False
        # When True, ``finish_apply`` leaves the budget sweep to the
        # caller's ``maybe_sweep`` (the row-service handlers sweep
        # AFTER releasing the service lock, so eviction's cold writes
        # stall no concurrent pull/push).
        self.defer_apply_sweep = False
        # Seed membership from whatever the inner table already holds
        # (tiering configured over a pre-populated table).
        ids, _rows = inner.to_arrays()
        if len(ids):
            self._hot.update(int(i) for i in ids)

    # ---- EmbeddingTable surface ---------------------------------------

    @property
    def name(self):
        return self._inner.name

    @property
    def dim(self):
        return self._inner.dim

    @property
    def dtype(self):
        return np.dtype(getattr(self._inner, "dtype", np.float32))

    @property
    def initializer(self):
        return getattr(self._inner, "initializer", "uniform")

    @property
    def is_slot(self):
        return getattr(self._inner, "is_slot", False)

    @property
    def slot_init_value(self):
        return getattr(self._inner, "slot_init_value", 0.0)

    @property
    def hot_inner(self):
        """The hot-tier table — what the fused native kernels write
        through (``NativeOptimizerWrapper``)."""
        return self._inner

    @property
    def tier_group(self) -> TierGroup:
        return self._group

    def tier_stats(self) -> dict:
        return self._group.stats()

    def make_slot_table(self, key: str, slot_init_value: float = 0.0):
        """Optimizer-wrapper seam: slot tables must tier in the SAME
        group as their primary (lockstep demotion/promotion)."""
        if not self._primary:
            raise ValueError("slots hang off the primary table only")
        return self._group.make_slot(key, slot_init_value)

    def get(self, ids, _defer_sweep: bool = False) -> np.ndarray:
        """Batch lookup: hot rows from the arena, cold rows faulted in
        ONE batched cold read (one fault event per pull), unseen rows
        lazily initialized by the inner table. Touches recency and
        sweeps the budget (``_defer_sweep`` lets the row-service
        handler run the sweep after it releases its own lock —
        ``maybe_sweep`` must follow)."""
        ids = np.ascontiguousarray(np.asarray(ids, np.int64).ravel())
        id_list = ids.tolist()
        with self._group.lock:
            miss = set(id_list) - self._hot
            if miss:
                self._fault(ids, miss)
                # Still missing after the fault = lazily materialized
                # by the inner get below. Materialization dirties,
                # matching the plain tables: a lazily created row must
                # ride the next delta so restore conserves it.
                new_ids = miss - self._hot
            else:
                new_ids = None
            rows = self._inner.get(ids)
            if new_ids:
                self._hot.update(new_ids)
                if self._track_dirty:
                    self._dirty.update(new_ids)
            self._group.touch(id_list)
        if not _defer_sweep:
            self._group.sweep()
        return rows

    def prefault(self, ids) -> None:
        """Promote this pull's cold ids with the DISK READ outside the
        group lock (and any caller lock): the row-service handler
        calls this before taking the service lock, so a faulting pull
        stalls concurrent pushes only for the in-memory bookkeeping,
        never for the cold-tier IO. A demotion/erase racing the read
        bumps the group epoch and the read is retried — stale bytes
        are never written over a newer resident or cold record."""
        import time

        from elasticdl_tpu_torch.observability import tracing

        ids = np.ascontiguousarray(np.asarray(ids, np.int64).ravel())
        id_list = ids.tolist()
        group = self._group
        for _ in range(8):
            with group.lock:
                if not self._cold.num_rows:
                    return
                miss = set(id_list) - self._hot
                if not miss:
                    return
                fault_ids = self._cold.intersect(miss)
                if not fault_ids.size:
                    return
                epoch = group._epoch
            t0 = time.monotonic()
            try:
                rows = self._cold.get_rows(fault_ids)
            except KeyError:
                continue  # raced an erase mid-read; re-resolve
            with group.lock:
                if group._epoch != epoch:
                    continue  # placement changed under the read
                keep = np.fromiter(
                    (i not in self._hot for i in fault_ids.tolist()),
                    bool, fault_ids.size,
                )
                if keep.any():
                    sel = fault_ids[keep]
                    with tracing.span("row_tier_fault",
                                      table=self.name,
                                      rows=int(sel.size)):
                        self._inner.set(sel, rows[keep])
                    sel_list = sel.tolist()
                    self._hot.update(sel_list)
                    self._hot_in_cold.update(sel_list)
                    self._cold_clean.update(sel_list)
                    group._m_faults.inc()
                    group._m_fault_rows.inc(int(sel.size))
                    group._m_fault_secs.observe(time.monotonic() - t0)
                    # Per-workload attribution: the fault ran on a
                    # handler thread whose ambient principal the RPC
                    # wrap established, so the I/O bills to the
                    # workload whose pull/push faulted the rows.
                    from elasticdl_tpu_torch.observability import (
                        principal as wl_principal,
                        usage as wl_usage,
                    )

                    wl_usage.meter_cold_fault(
                        wl_principal.current(), int(sel.size),
                        time.monotonic() - t0,
                    )
            return
        # Pathological churn: leave the leftovers to the under-lock
        # fault in get().

    def maybe_sweep(self) -> None:
        """Run the budget sweep (chunked, group lock only) — the
        deferred half of ``get(_defer_sweep=True)``."""
        self._group.sweep()

    def prefault_group(self, ids) -> None:
        """``prefault`` across the whole tier group (primary + slot
        tables) — the push handler's pre-lock hook, so a fused apply
        that hits evicted rows pays its cold reads before the service
        lock, not inside ``fault_for_apply`` while holding it."""
        self.prefault(ids)
        for slot in list(self._group.slots.values()):
            slot.prefault(ids)

    def set(self, ids, values, _defer_sweep: bool = False) -> None:
        """Write rows hot (restore refills, Python optimizer
        write-backs). Chunked against the budget so a bulk restore of
        a 10x-budget table streams through the arena instead of
        inflating it. ``_defer_sweep`` as in ``get`` — the Python
        optimizer's apply runs ONE sweep per whole apply, outside any
        caller lock."""
        ids = np.ascontiguousarray(np.asarray(ids, np.int64).ravel())
        values = np.asarray(values)
        budget = self._group.policy.hot_budget_rows
        for lo in range(0, ids.size, budget):
            chunk = slice(lo, min(ids.size, lo + budget))
            with self._group.lock:
                self._set_chunk(ids[chunk], values[chunk])
            if not _defer_sweep:
                self._group.sweep()

    def _set_chunk(self, ids, values):
        self._inner.set(ids, values)
        id_list = ids.tolist()
        new_ids = set(id_list) - self._hot
        self._hot.update(new_ids)
        # Content changed: any cold record is now stale.
        self._cold_clean.difference_update(id_list)
        if self._cold.num_rows:
            in_cold = self._cold.contains(ids)
            if in_cold.any():
                self._hot_in_cold.update(ids[in_cold].tolist())
        if self._track_dirty:
            self._dirty.update(id_list)
        self._group.touch(id_list)

    def erase(self, ids) -> int:
        """Drop rows from BOTH tiers (not demotion — removal)."""
        ids = np.ascontiguousarray(np.asarray(ids, np.int64).ravel())
        with self._group.lock:
            erased = int(self._inner.erase(ids))
            id_list = ids.tolist()
            self._hot.difference_update(id_list)
            self._hot_in_cold.difference_update(id_list)
            self._cold_clean.difference_update(id_list)
            self._dirty.difference_update(id_list)
            erased += self._cold.drop_rows(ids)
            self._group._epoch += 1
        return erased

    def contains(self, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64).ravel()
        with self._group.lock:
            hot = np.array([int(i) in self._hot for i in ids], bool)
            return hot | self._cold.contains(ids)

    def all_ids(self) -> np.ndarray:
        """Every row id across BOTH tiers, sorted, without reading a
        single row byte (membership sets + the cold index) — the
        enumeration live migrations range-scan over."""
        with self._group.lock:
            return np.array(
                sorted(self._hot | set(self._cold.live_ids().tolist())),
                np.int64,
            )

    def peek(self, ids) -> np.ndarray:
        """Read EXISTING rows with NO tier side effects: hot rows from
        the arena (no recency touch), cold rows straight from segment
        reads (no promotion, no budget pressure). A live migration
        streaming a mostly-cold range must not churn the working set
        through the hot tier."""
        ids = np.ascontiguousarray(np.asarray(ids, np.int64).ravel())
        with self._group.lock:
            hot_mask = np.array(
                [int(i) in self._hot for i in ids], bool
            )
            rows = np.empty((ids.size, self.dim), np.float32)
            if hot_mask.any():
                rows[hot_mask] = self._inner.get(ids[hot_mask])
            if (~hot_mask).any():
                rows[~hot_mask] = self._cold.get_rows(ids[~hot_mask])
            return rows

    @property
    def num_rows(self) -> int:
        with self._group.lock:
            return len(self._hot) + (
                self._cold.num_rows - len(self._hot_in_cold)
            )

    def to_arrays(self):
        """(ids, rows) across BOTH tiers, sorted by id — the
        checkpoint serialization unit (hot bytes shadow any stale cold
        record)."""
        with self._group.lock:
            hot_ids, hot_rows = self._inner.to_arrays()
            cold_only = np.array(sorted(
                set(self._cold.live_ids().tolist()) - self._hot
            ), np.int64)
            if not cold_only.size:
                return hot_ids, np.asarray(hot_rows)
            cold_rows = self._cold.get_rows(cold_only)
            if not len(hot_ids):
                return cold_only, cold_rows
            ids = np.concatenate([np.asarray(hot_ids, np.int64),
                                  cold_only])
            rows = np.concatenate(
                [np.asarray(hot_rows, np.float32), cold_rows]
            )
            order = np.argsort(ids, kind="stable")
            return ids[order], rows[order]

    # ---- dirty-row tracking (delta checkpoints) -----------------------

    @property
    def supports_dirty_rows(self) -> bool:
        return self._track_dirty

    def enable_dirty_tracking(self) -> None:
        # The wrapper owns tracking; the inner table's own set stays
        # off (its get-marking heuristics don't see tier promotions,
        # and double bookkeeping would double the hot-path cost).
        self._track_dirty = True

    @property
    def dirty_count(self) -> int:
        return len(self._dirty)

    def dirty_arrays(self):
        """(ids, rows) touched since the last drain, read from
        WHICHEVER tier holds each row (a row demoted while dirty
        drains from disk), sorted; clears the set."""
        with self._group.lock:
            if not self._dirty:
                return (np.zeros((0,), np.int64),
                        np.zeros((0, self.dim), np.float32))
            ids = np.array(sorted(self._dirty), np.int64)
            self._dirty.clear()
            hot_mask = np.array(
                [int(i) in self._hot for i in ids], bool
            )
            rows = np.empty((ids.size, self.dim), np.float32)
            if hot_mask.any():
                rows[hot_mask] = self._inner.get(ids[hot_mask])
            if (~hot_mask).any():
                rows[~hot_mask] = self._cold.get_rows(ids[~hot_mask])
            return ids, rows

    def mark_dirty(self, ids) -> None:
        if self._track_dirty:
            with self._group.lock:
                self._dirty.update(np.asarray(ids).ravel().tolist())

    def clear_dirty(self) -> None:
        with self._group.lock:
            self._dirty.clear()

    # ---- tier mechanics -----------------------------------------------

    def _fault(self, ids: np.ndarray, miss=None):
        """Promote this pull's cold ids in ONE batched read (held
        group lock). ``miss`` is the caller's precomputed not-hot id
        set (each handler builds it once instead of per phase).
        Faulted rows arrive clean (bytes identical to their cold
        record), so an untouched fault can demote later without a
        disk write."""
        import time

        from elasticdl_tpu_torch.observability import tracing

        if not self._cold.num_rows:
            return
        if miss is None:
            miss = set(ids.tolist()) - self._hot
        if not miss:
            return
        fault_ids = self._cold.intersect(miss)
        if not fault_ids.size:
            return
        t0 = time.monotonic()
        with tracing.span("row_tier_fault", table=self.name,
                          rows=int(fault_ids.size)):
            rows = self._cold.get_rows(fault_ids)
            self._inner.set(fault_ids, rows)
        fault_list = fault_ids.tolist()
        self._hot.update(fault_list)
        self._hot_in_cold.update(fault_list)
        self._cold_clean.update(fault_list)
        group = self._group
        group._m_faults.inc()
        group._m_fault_rows.inc(int(fault_ids.size))
        group._m_fault_secs.observe(time.monotonic() - t0)

    def _demote(self, victims: np.ndarray):
        """Evict ``victims ∩ hot`` to the cold tier: dirty/never-
        spilled rows flush through (bytes written before the arena
        erase — a kill in between leaves a duplicate cold record, not
        a lost row), clean residents just drop their arena copy."""
        from elasticdl_tpu_torch.observability import tracing

        present = np.array(
            [i for i in victims.tolist() if i in self._hot], np.int64
        )
        if not present.size:
            return
        write_ids = np.array(
            [i for i in present.tolist() if i not in self._cold_clean],
            np.int64,
        )
        with tracing.span("row_tier_evict", table=self.name,
                          rows=int(present.size),
                          written=int(write_ids.size)):
            if write_ids.size:
                rows = self._inner.get(write_ids)
                self._cold.put_rows(write_ids, rows)
            if _pre_erase_hook is not None:
                _pre_erase_hook(self.name, present)
            self._inner.erase(present)
        present_list = present.tolist()
        self._hot.difference_update(present_list)
        self._hot_in_cold.difference_update(present_list)
        self._cold_clean.difference_update(present_list)
        self._group._epoch += 1
        # Dirty marks SURVIVE demotion: the next dirty drain reads the
        # row from the cold tier (delta checkpoints stay correct).

    # ---- fused-apply seam (NativeOptimizerWrapper) --------------------

    def fault_for_apply(self, ids: np.ndarray,
                        slot_tables=()) -> None:
        """Pre-kernel promotion: cold rows of the primary AND its slot
        tables fault hot before the fused C++ kernels run — a kernel's
        lazy get_or_create on an evicted slot row would silently reset
        optimizer state to its init value."""
        ids = np.ascontiguousarray(np.asarray(ids, np.int64).ravel())
        id_list = ids.tolist()
        with self._group.lock:
            id_set = set(id_list)
            self._fault(ids, id_set - self._hot)
            for slot in slot_tables:
                slot._fault(ids, id_set - slot._hot)
            self._group.touch(id_list)

    def finish_apply(self, ids: np.ndarray, slot_tables=(),
                     _sweep: bool = True) -> None:
        """Post-kernel bookkeeping: every applied id is now hot (the
        kernel materialized any it didn't find), its cold records are
        stale, and the budget sweep runs once for the whole apply
        (``_sweep=False`` when the caller sweeps itself after dropping
        the group lock it holds across the kernel).

        No cold-membership probe here: ``fault_for_apply`` promoted
        every id that HAD a cold record (marking ``_hot_in_cold``
        then), and ids the kernel materialized fresh have none — the
        invariant ``_hot_in_cold == hot ∩ cold-index`` already holds."""
        ids = np.ascontiguousarray(np.asarray(ids, np.int64).ravel())
        id_list = ids.tolist()
        with self._group.lock:
            for member in (self,) + tuple(slot_tables):
                new_ids = set(id_list) - member._hot
                member._hot.update(new_ids)
                member._cold_clean.difference_update(id_list)
        if _sweep and not self.defer_apply_sweep:
            self._group.sweep()

    def debug_info(self) -> str:
        group = self._group
        return (
            f"TieredTable {self.name}: hot={len(self._hot)} "
            f"cold_only={self._cold.num_rows - len(self._hot_in_cold)} "
            f"budget={group.policy.hot_budget_rows} dim={self.dim}"
        )


def tier_host_tables(tables: Dict, cold_dir: str, policy: TierPolicy,
                     inner_factory=None, metrics_registry=None
                     ) -> Dict[str, TieredTable]:
    """Wrap each host table in its own ``TierGroup`` (per-table budget
    and cold subdirectory) — the entry point ``HostRowService.
    configure_tiering`` and local engines use. ``inner_factory`` makes
    the hot-tier slot tables (defaults to ``make_host_table``, so
    slots match the primary's implementation)."""
    import os

    if inner_factory is None:
        from elasticdl_tpu_torch.native.row_store import make_host_table

        inner_factory = make_host_table
    out = {}
    for name, table in tables.items():
        group = TierGroup(
            name, policy,
            os.path.join(cold_dir, name.replace("/", "_")),
            inner_factory, metrics_registry=metrics_registry,
        )
        out[name] = group.make_primary(table)
    return out
