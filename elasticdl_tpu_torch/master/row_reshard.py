"""The shard-map authority: live row-service resharding and the
hot-row replica control loop (port of elasticdl_tpu/master/row_reshard.py;
the same protocol, the same state file bytes and the same wire fields, so
this controller drives JAX shards and a JAX controller drives the port's).

The one writer of shard-map epochs (``embedding/shard_map.py``). Every
topology change runs one generation-fenced protocol: state moves first,
the version flips last.

1. **plan**: persist the migration record (source, target, bucket range)
   to the state file before any byte moves; a controller that dies at
   any later point finds the record and re-runs the move (the re-copy is
   idempotent: ``ingest_rows`` overwrites).
2. **copy**: ``begin_ingest`` on the target (only this migration's
   chunks are accepted), then ``migrate_out`` on the source: bulk
   chunks, catch-up deltas from the source's touched-set tracking, and a
   brief write fence for the final delta.
3. **cutover**: persist the new map (version + 1, the range reassigned)
   while the range is still fenced, then distribute it target first (the
   target must accept the range before the source redirects to it), the
   source second (its fence becomes a redirect and it erases the moved
   rows), the rest last. Stale clients converge through REDIRECTs; no
   client ever sees two owners.
4. **done**: ``end_ingest`` releases the target's fence; the state file
   drops the migration record.

``tick()`` closes the loop for the row plane: it polls each shard's load
(``shard_stats``), moves a range off a load imbalance, refreshes the
hot-row replica designation from the shards' pull-frequency top-K, and
retires a merged-away shard once no client can still route to it.

Persistence: the state file is the authority's truth (tmp + fsync +
rename, JSON with ``indent=2, sort_keys=True``). ``journal=`` takes any
object with ``.append``: each published epoch also appends a
``shard_map`` record there (the master passes its write-ahead journal,
``master/journal.py``, when it runs with ``--journal_dir``).

Splitting onto a new shard needs a process at the target address first
(``python -m elasticdl_tpu_torch.embedding.row_service`` with the same
model module and no checkpoint restore: the migration streams its
state). The controller never starts processes.
"""

import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.embedding.shard_map import ShardMap

logger = get_logger("row_reshard")


# Chaos seam: raised-through hook between persisting the cutover map
# and distributing it — the drill's "kill the master mid-cutover".
_mid_cutover_hook: Optional[Callable] = None


def set_reshard_chaos_hooks(mid_cutover: Optional[Callable] = None):
    global _mid_cutover_hook
    _mid_cutover_hook = mid_cutover


class RideOutTransport:
    """Default shard transport: rides out a shard relaunch with the
    row-service client's own bounded-backoff + channel-rebuild retry
    (a resharding authority faces restarting shards as a matter of
    course — a wedged channel must not fail a resumable migration).
    Delegating to ``_call_with_retry`` also puts every migration RPC
    under the shared ``RowService:rideout`` retry budget and its
    decorrelated-jitter backoff (comm/overload.py): background
    migration traffic is rate-capped during an overload instead of
    amplifying into it."""

    def __init__(self, addr: str, retries: int = 8,
                 backoff_secs: float = 0.25):
        from elasticdl_tpu_torch.comm.rpc import RpcStub
        from elasticdl_tpu_torch.embedding.row_service import SERVICE_NAME

        self._stub = RpcStub(addr, SERVICE_NAME, max_retries=0)
        self._retries = retries
        self._backoff = backoff_secs

    def call(self, method: str, **fields):
        from elasticdl_tpu_torch.embedding.row_service import (
            _call_with_retry,
        )

        return _call_with_retry(
            self._stub, method, self._retries, self._backoff, **fields
        )

    def close(self):
        self._stub.close()


@dataclass
class ReshardPolicy:
    """Pure decision thresholds for the controller's tick (injectable,
    unit-testable).

    A rebalance MOVE triggers when the hottest shard's pull+push row
    rate exceeds ``imbalance_factor`` x the coldest's (with at least
    ``min_rows_per_tick`` observed — an idle fleet has no signal).
    Hot-vs-cold, not hot-vs-mean: on a small fleet max/mean is
    bounded by the fleet size, and a 2-shard fleet at 90/10 load is
    exactly the imbalance a move should fix.
    Replica designation takes each table's globally hottest ids (by
    the shards' pull-frequency top-K) that drew at least
    ``replica_min_pulls`` since the last tick."""

    imbalance_factor: float = 1.8
    min_rows_per_tick: int = 1000
    replica_top_k: int = 64
    replica_min_pulls: int = 64
    # Replicas per hot id (capped by fleet size - 1); 0 disables
    # replication entirely.
    replica_count: int = 2
    cooldown_secs: float = 30.0

    def pick_move(self, rates: Dict[int, float]) -> Optional[tuple]:
        """(source, target) off per-shard row rates, or None."""
        if len(rates) < 2:
            return None
        total = sum(rates.values())
        if total < self.min_rows_per_tick:
            return None
        hot = max(rates, key=lambda s: rates[s])
        cold = min(rates, key=lambda s: rates[s])
        if hot == cold or rates[hot] < self.imbalance_factor * max(
            rates[cold], 1.0
        ):
            return None
        return hot, cold

    def pick_replicas(
        self, hot_counts: Dict[str, Dict[int, int]], num_shards: int,
        home_of: Callable[[str, int], int],
    ) -> Dict[str, Dict[int, tuple]]:
        """{table: {id: replica shards}} from aggregated pull counts.
        Replicas are the shards after the home in ring order — spread
        deterministic, no state to persist beyond the map itself."""
        count = min(self.replica_count, num_shards - 1)
        if count <= 0:
            return {}
        out: Dict[str, Dict[int, tuple]] = {}
        for table, counts in hot_counts.items():
            ranked = sorted(
                counts.items(), key=lambda kv: -kv[1]
            )[: self.replica_top_k]
            per = {}
            for i, n in ranked:
                if n < self.replica_min_pulls:
                    continue
                home = home_of(table, i)
                per[int(i)] = tuple(
                    (home + 1 + k) % num_shards for k in range(count)
                )
            if per:
                out[table] = per
        return out


@dataclass
class MigrationRecord:
    """One in-flight (or crashed-in-flight) range move — exactly what
    the state file carries so a restarted controller can resume."""

    migration_id: str
    source: int
    target: int
    lo: int
    hi: int
    phase: str  # "copy" | "cutover"

    def to_json(self) -> dict:
        return {
            "migration_id": self.migration_id, "source": self.source,
            "target": self.target, "lo": self.lo, "hi": self.hi,
            "phase": self.phase,
        }

    @classmethod
    def from_json(cls, blob: dict) -> "MigrationRecord":
        return cls(
            str(blob["migration_id"]), int(blob["source"]),
            int(blob["target"]), int(blob["lo"]), int(blob["hi"]),
            str(blob["phase"]),
        )


class ShardMapController:
    """The single authority over one row-service fleet's shard map.

    ``transport_factory(addr) -> obj with .call(method, **fields)``
    defaults to RPC stubs; tests/drills inject in-process transports.
    ``state_path`` is required: an authority that cannot persist its
    epoch cannot survive itself, and resharding without crash safety
    is how rows get lost."""

    def __init__(self, state_path: str,
                 transport_factory: Optional[Callable] = None,
                 journal=None,
                 policy: Optional[ReshardPolicy] = None):
        if not state_path:
            raise ValueError("state_path must be non-empty")
        self.state_path = state_path
        self.policy = policy or ReshardPolicy()
        self._journal = journal
        self._transport_factory = transport_factory
        self._transports: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._map: Optional[ShardMap] = None
        self._migration: Optional[MigrationRecord] = None
        self._mig_seq = 0
        self._last_rates: Dict[int, int] = {}
        self._last_action_at = 0.0
        # Drained-but-not-retired shards (merge leaves the slot in the
        # address list): [{"shard", "addr", "epoch"}], persisted so a
        # restarted authority still retires them. Quiescence baselines
        # (traffic totals + clock) stay in-memory — they re-arm after
        # a restart, which only delays retirement by one window.
        self._drained: List[dict] = []
        self._drained_baseline: Dict[int, dict] = {}
        from elasticdl_tpu_torch.observability import default_registry

        registry = default_registry()
        self._m_epochs = registry.counter(
            "row_reshard_epochs_total",
            "Shard-map epochs published by the authority",
        )
        self._m_migrations = registry.counter(
            "row_reshard_migrations_total",
            "Range migrations driven to completion",
            ["kind"],
        )
        if os.path.exists(state_path):
            self._load_state()

    # ---- persistence ---------------------------------------------------

    def _load_state(self):
        with open(self.state_path) as fh:
            state = json.load(fh)
        self._map = ShardMap.from_json(state["map"])
        mig = state.get("migration")
        self._migration = (
            MigrationRecord.from_json(mig) if mig else None
        )
        self._mig_seq = int(state.get("mig_seq", 0))
        self._drained = list(state.get("drained", []))

    def _persist(self):
        """Publish the authority's truth with the checkpoint publish
        discipline: no epoch is visible until fully durable."""
        state = {
            "map": self._map.to_json(),
            "migration": (
                self._migration.to_json() if self._migration else None
            ),
            "mig_seq": self._mig_seq,
            "drained": list(self._drained),
        }
        tmp = self.state_path + ".tmp"
        os.makedirs(os.path.dirname(self.state_path) or ".",
                    exist_ok=True)
        with open(tmp, "w") as fh:
            json.dump(state, fh, indent=2, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.state_path)
        if self._journal is not None:
            try:
                self._journal.append(
                    "shard_map", version=self._map.version,
                    map=self._map.to_json(),
                )
            except Exception as exc:
                logger.warning("journal shard_map append failed: %s",
                               exc)

    # ---- transports ----------------------------------------------------

    def _transport(self, addr: str):
        transport = self._transports.get(addr)
        if transport is None:
            if self._transport_factory is not None:
                transport = self._transport_factory(addr)
            else:
                transport = RideOutTransport(addr)
            self._transports[addr] = transport
        return transport

    # ---- map lifecycle -------------------------------------------------

    @property
    def map(self) -> Optional[ShardMap]:
        return self._map

    def bootstrap(self, addrs: List[str]) -> ShardMap:
        """First epoch over a fresh fleet (no-op if state already
        exists — a restarted master must not regress the map)."""
        with self._lock:
            if self._map is None:
                self._map = ShardMap.bootstrap(addrs)
                self._persist()
                self._m_epochs.inc()
            self._sync_locked()
            return self._map

    def sync(self) -> int:
        """Distribute the current map to every shard (idempotent —
        versions fence). Returns how many shards accepted."""
        with self._lock:
            return self._sync_locked()

    def _sync_locked(self, order: Optional[List[int]] = None) -> set:
        """Install the current map on every shard; returns the set of
        shard indices that ACCEPTED. Failures are logged, not raised —
        but callers that need a specific shard installed (the cutover's
        target) must check membership: clients converge via REDIRECT,
        SERVERS only converge through this call (tick() re-syncs
        laggards it sees in poll_stats)."""
        m = self._map
        ok = set()
        shards = order if order is not None else range(len(m.shards))
        for s in shards:
            try:
                self._transport(m.shards[s]).call(
                    "set_shard_map", map=m.to_json(), shard_id=int(s),
                )
                ok.add(int(s))
            except Exception as exc:
                logger.warning(
                    "set_shard_map on shard %d (%s) failed: %s "
                    "(tick() re-syncs laggards)",
                    s, m.shards[s], exc,
                )
        return ok

    def add_shard(self, addr: str) -> int:
        """Register a new (empty) shard and give it the map — the
        split target. Returns its shard index."""
        with self._lock:
            self._map = self._map.add_shard(addr)
            self._persist()
            self._m_epochs.inc()
            self._sync_locked()
            return len(self._map.shards) - 1

    # ---- migrations ----------------------------------------------------

    def move_range(self, source: int, lo: int, hi: int,
                   target: int) -> dict:
        """Drive one live range move end to end (the docstring's
        plan/copy/cutover/done). Raises on failure with the migration
        record persisted — ``resume()`` re-runs it."""
        with self._lock:
            if self._migration is not None:
                raise RuntimeError(
                    f"migration {self._migration.migration_id} already "
                    "in flight; resume() it first"
                )
            self._mig_seq += 1
            record = MigrationRecord(
                f"mig-{self._mig_seq}-v{self._map.version}"
                f"-{lo}-{hi}", int(source), int(target), int(lo),
                int(hi), "copy",
            )
            self._migration = record
            self._persist()
        return self._run_migration(record)

    def _run_migration(self, record: MigrationRecord) -> dict:
        m = self._map
        source_addr = m.shards[record.source]
        target_addr = m.shards[record.target]
        stats = {}
        if record.phase == "copy":
            self._transport(target_addr).call(
                "begin_ingest", migration_id=record.migration_id,
                lo=record.lo, hi=record.hi,
            )
            stats = self._transport(source_addr).call(
                "migrate_out", migration_id=record.migration_id,
                lo=record.lo, hi=record.hi, target_addr=target_addr,
            )
            # Cutover: persist the flipped map FIRST (a crash after
            # this point re-distributes; a crash before re-copies).
            with self._lock:
                self._map = self._map.move_range(
                    record.lo, record.hi, record.target
                )
                record.phase = "cutover"
                self._migration = record
                self._persist()
                self._m_epochs.inc()
        hook = _mid_cutover_hook
        if hook is not None:
            hook(self, record)
        with self._lock:
            # Target first: it must accept the range before the source
            # starts redirecting clients to it.
            order = [record.target, record.source] + [
                s for s in range(len(self._map.shards))
                if s not in (record.target, record.source)
            ]
            accepted = self._sync_locked(order)
            if record.target not in accepted:
                # Without the target on the new epoch, every redirect
                # sends clients to a shard that bounces them back
                # (carrying the OLDER map, which they ignore) — an
                # unservable range. Keep the migration record (phase
                # cutover) and fail: resume() re-distributes.
                raise RuntimeError(
                    f"cutover: target shard {record.target} did not "
                    f"accept map v{self._map.version}; migration "
                    f"{record.migration_id} kept for resume()"
                )
            try:
                self._transport(
                    self._map.shards[record.target]
                ).call("end_ingest",
                       migration_id=record.migration_id)
            except Exception as exc:
                logger.warning("end_ingest failed: %s", exc)
            self._migration = None
            self._persist()
        self._m_migrations.labels("move").inc()
        logger.info(
            "migrated buckets [%d, %d) shard %d -> %d (v%d): %s",
            record.lo, record.hi, record.source, record.target,
            self._map.version, stats,
        )
        return stats

    def resume(self) -> Optional[dict]:
        """Crash recovery: finish whatever the state file says was in
        flight. Phase "copy" re-runs the whole move (idempotent);
        phase "cutover" re-distributes the already-persisted map and
        releases the target. Returns the move's stats (None if there
        was nothing to resume)."""
        with self._lock:
            record = self._migration
        if record is None:
            with self._lock:
                if self._map is not None:
                    self._sync_locked()
            return None
        logger.info(
            "resuming migration %s (phase %s)", record.migration_id,
            record.phase,
        )
        return self._run_migration(record)

    # ---- convenience topologies ----------------------------------------

    def split(self, source: int, new_addr: Optional[str] = None,
              target: Optional[int] = None) -> dict:
        """Split the source shard: move the upper half of its largest
        range to ``new_addr`` (a fresh shard) or an existing
        ``target``."""
        if (new_addr is None) == (target is None):
            raise ValueError("pass exactly one of new_addr/target")
        if new_addr is not None:
            target = self.add_shard(new_addr)
        lo, hi = self._map.split_plan(source)
        return self.move_range(source, lo, hi, target)

    def merge(self, source: int, target: int) -> List[dict]:
        """Drain the source shard into ``target`` (one move per owned
        range). The drained slot stays in the address list until the
        tick's compaction step retires it — once every client has
        converged past the drained shard's last epoch (see
        ``_maybe_retire_locked``)."""
        out = []
        for lo, hi in list(self._map.ranges_of(source)):
            # Each constituent move already counts in
            # row_reshard_migrations_total{kind=move}.
            out.append(self.move_range(source, lo, hi, target))
        with self._lock:
            self._drained.append({
                "shard": int(source),
                "addr": self._map.shards[int(source)],
                # Clients at epochs below this could still route ids
                # to the drained shard; retirement waits until no one
                # does (quiescence) and every server converged past.
                "epoch": int(self._map.version),
            })
            self._persist()
        return out

    def _maybe_retire_locked(self, stats: Dict[int, dict],
                             now: float) -> Optional[int]:
        """Compaction: retire ONE drained shard per tick once it is
        provably unreferenced — every reachable server installed an
        epoch >= the drain epoch, and the drained shard served ZERO
        pulls/pushes for a full policy cooldown window (a client
        still holding a pre-drain map would route ids at it, so
        sustained silence is the observable form of "every client has
        converged past the drained shard's last epoch"). Returns the
        retired index or None. Caller holds the lock."""
        for record in list(self._drained):
            shard = int(record["shard"])
            if shard >= len(self._map.shards) or (
                self._map.shards[shard] != record["addr"]
            ):
                # Index no longer names the drained address (map
                # evolved unexpectedly, e.g. hand-edited state) —
                # drop the stale record instead of retiring the
                # wrong shard.
                self._drained.remove(record)
                self._persist()
                continue
            if self._map.buckets_owned(shard):
                # Re-split onto the drained slot: it is live again.
                self._drained.remove(record)
                self._drained_baseline.pop(shard, None)
                self._persist()
                continue
            behind = [
                s for s, per in stats.items()
                if per.get("map_version", 0) < record["epoch"]
            ]
            if behind:
                continue
            per = stats.get(shard)
            traffic = (
                (per.get("pulled_rows", 0) + per.get("pushed_rows", 0))
                if per is not None else None
            )
            baseline = self._drained_baseline.get(shard)
            if baseline is None or (
                traffic is not None and traffic != baseline["traffic"]
            ):
                # (Re-)arm the quiescence window; an unreachable
                # drained shard (ops already killed the process)
                # quiesces trivially (traffic None == None holds).
                self._drained_baseline[shard] = {
                    "traffic": traffic, "t": now,
                }
                continue
            if now - baseline["t"] < self.policy.cooldown_secs:
                continue
            m = self._map
            # Replica designation may still point at the drained slot
            # (ring-order spread counts every slot): filter the
            # drained MEMBER out of each set — the surviving replicas
            # keep serving the hot reads (dropping whole entries
            # would collapse the fan-in onto the home until the next
            # update_replicas tick).
            replicas = {}
            for table, per_table in m.replicas.items():
                kept = {}
                for i, reps in per_table.items():
                    filtered = tuple(s for s in reps if s != shard)
                    if filtered:
                        kept[i] = filtered
                if kept:
                    replicas[table] = kept
            if replicas != m.replicas:
                m = m.with_replicas(replicas)
            self._map = m.retire_shard(shard)
            self._drained.remove(record)
            self._drained_baseline.pop(shard, None)
            # Surviving drained records + baselines shift down past
            # the removed slot; per-index rate history is stale now.
            for other in self._drained:
                if int(other["shard"]) > shard:
                    other["shard"] = int(other["shard"]) - 1
            self._drained_baseline = {
                (s - 1 if s > shard else s): b
                for s, b in self._drained_baseline.items()
            }
            self._last_rates = {}
            self._persist()
            self._m_epochs.inc()
            self._m_migrations.labels("retire").inc()
            self._sync_locked()
            logger.info(
                "retired drained shard %d (%s) from the map (v%d): "
                "%d shard(s) remain",
                shard, record["addr"], self._map.version,
                len(self._map.shards),
            )
            return shard
        return None

    # ---- the policy tick -----------------------------------------------

    def poll_stats(self, top_k: Optional[int] = None) -> Dict[int, dict]:
        """shard_stats from every reachable shard."""
        m = self._map
        out = {}
        for s, addr in enumerate(m.shards):
            try:
                out[s] = self._transport(addr).call(
                    "shard_stats",
                    top_k=int(top_k or self.policy.replica_top_k),
                )
            except Exception as exc:
                logger.warning("shard_stats on %s failed: %s", addr,
                               exc)
        return out

    def update_replicas(self) -> bool:
        """Recompute the hot-row replica designation from the shards'
        pull-frequency top-K; publish a new epoch only when it
        changed. Returns whether an epoch was published."""
        stats = self.poll_stats()
        hot: Dict[str, Dict[int, int]] = {}
        for per_shard in stats.values():
            for table, pairs in (per_shard.get("hot") or {}).items():
                bucket = hot.setdefault(table, {})
                for i, n in pairs:
                    bucket[int(i)] = bucket.get(int(i), 0) + int(n)
        m = self._map
        replicas = self.policy.pick_replicas(
            hot, len(m.shards),
            lambda table, i: int(m.home_of_ids([i])[0]),
        )
        with self._lock:
            if replicas == self._map.replicas:
                return False
            self._map = self._map.with_replicas(replicas)
            self._persist()
            self._m_epochs.inc()
            self._sync_locked()
        logger.info(
            "replica designation updated (v%d): %s",
            self._map.version,
            {t: len(p) for t, p in replicas.items()},
        )
        return True

    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One control-loop pass (called from the master's run tick):
        refresh replicas off the hot sets, and rebalance a range off
        load imbalance. Rate-limited by the policy cooldown; never
        raises (a flaky shard must not take the master loop down)."""
        now = time.monotonic() if now is None else now
        if self._map is None or self._migration is not None:
            return None
        if now - self._last_action_at < self.policy.cooldown_secs:
            return None
        try:
            stats = self.poll_stats()
            if not stats:
                return None
            # Laggard repair: a shard that missed a distribution (it
            # was restarting, or a cutover's tail sync failed) only
            # converges through set_shard_map — clients' REDIRECTs
            # never teach servers.
            behind = [
                s for s, per in stats.items()
                if per.get("map_version", 0) < self._map.version
            ]
            if behind:
                with self._lock:
                    self._sync_locked(behind)
            # Compaction: retire a drained (merged-away) shard once
            # clients provably converged past its last epoch.
            with self._lock:
                retired = self._maybe_retire_locked(stats, now)
            if retired is not None:
                self._last_action_at = now
                return f"retire:{retired}"
            primed = bool(self._last_rates)
            totals = {
                s: per.get("pulled_rows", 0) + per.get("pushed_rows", 0)
                for s, per in stats.items()
            }
            # Clamped per-tick deltas: a restarted shard's counters
            # reset (delta would go negative), and an unprimed first
            # tick would read lifetime totals as one tick's load.
            rates = {
                s: max(0, t - self._last_rates.get(s, t))
                for s, t in totals.items()
            }
            self._last_rates = totals
            if not primed:
                return None
            acted = None
            move = self.policy.pick_move(rates)
            if move is not None:
                source, target = move
                try:
                    lo, hi = self._map.split_plan(source)
                    self.move_range(source, lo, hi, target)
                    acted = f"move:{source}->{target}"
                except Exception as exc:
                    logger.warning("rebalance move failed: %s", exc)
            if self.update_replicas():
                acted = (acted + "+replicas") if acted else "replicas"
            if acted:
                self._last_action_at = now
            return acted
        except Exception as exc:
            logger.warning("reshard tick failed: %s", exc)
            return None

    def close(self):
        for transport in self._transports.values():
            close = getattr(transport, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass
        self._transports.clear()
