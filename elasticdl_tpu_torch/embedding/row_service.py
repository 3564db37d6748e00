"""Shared row service: the host tier served over RPC (port of
elasticdl_tpu/embedding/row_service.py).

The one parameter-server role a single process cannot absorb: several
worker processes training one table larger than the card need a shared
row plane. The reference serves it with the Pserver gRPC service
(``pull_embedding_vectors`` / ``push_gradients``); here the same
contract rides the framework's msgpack RPC (``comm/rpc.py``), with the
JAX package's wire fields, so a port client trains against a JAX
service and the reverse:

- **Server** (``HostRowService``): owns the tables (Python or C++ row
  store, in host RAM; the service touches no CUDA) and the row
  optimizer; applies pushed gradients under a lock (asynchronous
  parameter-server semantics: concurrent workers interleave), drops a
  retried push by its ``(client, seq)``, checkpoints rows, optimizer
  slots, step counters and the seq map every N pushes through the
  port's ``CheckpointSaver``, and restores the newest version at start.
- **Client** (``make_remote_engine``): a ``HostEmbeddingEngine`` whose
  tables pull rows over RPC and whose optimizer pushes the gradients
  back. ``HostStepRunner`` works unchanged on top of it; its
  ``host_tables`` is None (the service checkpoints its rows).

Placement is a versioned ``ShardMap`` (``embedding/shard_map.py``)
that the client routes through and the server enforces: a pull or push
for buckets a shard does not own under its installed map returns a
retryable REDIRECT carrying the newer map. One address is a one-shard
map; a comma list bootstraps an even split of the bucket space.

Live resharding and hot-row replicas: row ranges move between live
shards through a generation-fenced migration (``migrate_out`` on the
source, ``begin_ingest``/``ingest_rows``/``ingest_steps``/``end_ingest``
on the target): a bulk copy in chunks (cold rows of a tiered table
streamed by segment reads, never promoted through the hot budget), then
catch-up deltas of the rows pushed meanwhile, then a brief write fence
until the authority installs the flipped map. A fenced push answers
"fenced" and the client retries it after the cutover. Each shard tracks
its most-pulled ids (``shard_stats``); the authority designates read
replicas for them, the home pushes refreshes after applied pushes
(``replica_refresh``), and the client spreads hot-id reads over home and
replicas (``pull_replica_rows``, falling back to the home on a miss),
optionally hedged. The authority is ``master/row_reshard.py``.

Storage (``storage/``): ``configure_tiering`` re-houses every table
behind a hot-row budget over CRC-framed cold segments, so a shard
serves tables larger than host RAM; ``configure_push_log`` logs every
applied push ahead of the checkpoints (group commit, ``durable`` or
``applied`` acks) and replays the log's tail on relaunch, so a SIGKILL
loses no acked push. Both write the JAX service's bytes.

Not ported yet: ``main``'s sampling-profiler and metrics-reporter flags
(``--profile_hz``, ``--profile_window_secs``, ``--master_addr``,
``--metrics_report_secs``) raise and name ROADMAP Queue 1, item 8f.
"""

import itertools
import threading
import time
from collections import Counter
from typing import Callable, Dict, Optional

import numpy as np

from elasticdl_tpu_torch.comm import deadline as wl_deadline
from elasticdl_tpu_torch.comm import overload as wl_overload
from elasticdl_tpu_torch.comm.rpc import (
    EXPIRED_DETAIL,
    InvalidRequest,
    RpcError,
    RpcServer,
    RpcStub,
    decorrelated_jitter,
)
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.embedding.host_engine import HostEmbeddingEngine
from elasticdl_tpu_torch.embedding.shard_map import (
    ClientShardMap,
    ShardMap,
    bucket_of,
)
from elasticdl_tpu_torch.embedding.table import get_slot_table_name
from elasticdl_tpu_torch.observability import principal as wl_principal
from elasticdl_tpu_torch.observability import tracing
from elasticdl_tpu_torch.observability import usage as wl_usage

logger = get_logger("row_service")

SERVICE_NAME = "RowService"
SEQS_TABLE_NAME = "__row_service_seqs__"
_ITEM_8F = "is not ported yet (ROADMAP Queue 1, item 8f)"

# Rows a migration chunk: bounds how long the service lock is held for
# one read and how large each ingest RPC is.
MIGRATE_CHUNK_ROWS = 2048
# Catch-up rounds before the source fences writes to the moving range
# and ships the final delta.
MIGRATE_CATCHUP_ROUNDS = 4
# A write fence lifts itself if the cutover never arrives (the authority
# died mid-protocol and will re-run the whole move): better to accept
# writes again, which the re-run copies, than to refuse the range for
# good. It must exceed the worst final delta plus cutover distribution
# (the authority's RideOutTransport retries span ~64 s against a flaky
# shard): a fence lapsing mid-protocol would let a push apply on the
# source after the final delta shipped, to be erased at the cutover.
FENCE_TTL_SECS = 300.0
# Hot-id pull tracking: a bounded counter a table (lossy: past the
# bound the tail halves away), kept only once a shard map is installed.
HOT_TRACK_MAX_IDS = 4096


# ---- chaos seam ---------------------------------------------------------
#
# mid_migrate(service, migration_id, view_name, chunk_ids) runs after
# each migrated chunk lands on the target; raising from it stands for the
# source dying mid-copy (chaos/reshard_drill.py installs it).

_mid_migrate_hook: Optional[Callable] = None


def set_reshard_chaos_hooks(mid_migrate: Optional[Callable] = None):
    global _mid_migrate_hook
    _mid_migrate_hook = mid_migrate


class DirectTransport:
    """In-process transport to a ``HostRowService`` (tests, drills): the
    ``.call`` surface of ``RpcStub`` without a socket."""

    def __init__(self, service: "HostRowService"):
        self._handlers = service.handlers()

    def call(self, method: str, timeout=None, **fields):
        return self._handlers[method](fields) or {}


def _all_ids(table) -> np.ndarray:
    """Every materialised row id of a table-like, without reading row
    bytes where the store can avoid it (the fallback pays a full
    ``to_arrays``)."""
    fn = getattr(table, "all_ids", None)
    if fn is not None:
        return np.asarray(fn(), np.int64)
    return np.asarray(table.to_arrays()[0], np.int64)


def _peek_rows(table, ids: np.ndarray) -> np.ndarray:
    """Rows of existing ids without promotion or recency side effects
    where the store has ``peek`` (a tiered table reads cold ids straight
    from its segments: a migrated cold range must not churn through the
    hot budget); else ``get``."""
    fn = getattr(table, "peek", None)
    rows = fn(ids) if fn is not None else table.get(ids)
    return np.asarray(rows, np.float32)


def _client_key(client: str) -> int:
    """Stable 63-bit key for a client id string (blake2b, as the JAX
    service keys it, so both packages' seq tables hold the same ids)."""
    import hashlib

    return int.from_bytes(
        hashlib.blake2b(client.encode("utf-8"), digest_size=8).digest(),
        "big",
    ) >> 1


class _SeqTable:
    """Checkpoint adapter persisting the push-dedup map ({client key:
    last applied seq}) as a dim-1 table: a relaunch restores the map
    with the rows it belongs to, so a push applied just before the
    checkpoint and retried after the relaunch is not applied twice."""

    dim = 1

    def __init__(self, service: "HostRowService"):
        self._service = service

    def to_arrays(self):
        items = sorted(self._service._applied_seq.items())
        ids = np.array([k for k, _ in items], np.int64)
        rows = np.array(
            [[v] for _, v in items], np.float64
        ).reshape(-1, 1)
        return ids, rows

    def set(self, ids, values):
        values = np.asarray(values).reshape(len(list(ids)), -1)
        for key, row in zip(ids, values):
            self._service._applied_seq[int(key)] = int(round(float(row[0])))


def _clone_empty(table):
    """A fresh table of the same type and configuration: its lazy init
    for untouched ids matches the live table's exactly. A tiered table
    clones its hot tier (the inner table owns the lazy init; a throwaway
    must not drag a cold store along)."""
    table = getattr(table, "hot_inner", table)
    return type(table)(
        table.name,
        table.dim,
        initializer=getattr(table, "initializer", "uniform"),
        is_slot=getattr(table, "is_slot", False),
        slot_init_value=getattr(table, "slot_init_value", 0.0),
        dtype=getattr(table, "dtype", np.float32),
    )


class HostRowService:
    """Server side of the shared host tier.

    ``checkpoint_dir``/``checkpoint_steps``: save rows + optimizer state
    every N gradient pushes (the reference parameter server checkpoints
    inside ``push_gradients`` every checkpoint_steps versions); the push
    count is the service's version. At start the newest valid version
    is restored, so a relaunched service resumes without loss.
    """

    def __init__(self, tables: Dict, optimizer, checkpoint_dir: str = "",
                 checkpoint_steps: int = 0, keep_max: int = 3,
                 metrics_registry=None,
                 push_durable_wait_secs: float = 60.0):
        self._tables = tables
        self._optimizer = optimizer
        # Ceiling on the durable-ack fsync wait; a propagated request
        # deadline shrinks it per push (the record is queued and lands
        # regardless; only the ack is abandoned).
        self._push_durable_wait_secs = float(push_durable_wait_secs)
        from elasticdl_tpu_torch.observability import default_registry

        registry = metrics_registry or default_registry()
        # Slow pulls and pushes stamp their span's trace id onto the
        # observation, so a latency breach names concrete traces.
        self._m_pull = registry.histogram(
            "row_service_pull_seconds", "pull_rows handler latency",
            exemplars=True,
        )
        self._m_push = registry.histogram(
            "row_service_push_seconds", "push_row_grads handler latency",
            exemplars=True,
        )
        self._m_pulled = registry.counter(
            "row_service_pulled_rows_total", "Rows served to pulls",
        )
        self._m_pushed = registry.counter(
            "row_service_pushed_rows_total",
            "Row gradients applied from pushes",
        )
        self._m_dup = registry.counter(
            "row_service_duplicate_pushes_total",
            "Retried pushes dropped by (client, seq) dedup",
        )
        self._m_stall = registry.histogram(
            "checkpoint_stall_seconds",
            "Step/push-path time spent capturing + enqueuing a "
            "checkpoint (the part the hot path actually waits on)",
            exemplars=True,
        )
        # The reshard plane's families, in the JAX service's order.
        self._m_map_version = registry.gauge(
            "row_shard_map_version",
            "Installed shard-map epoch (0 = static legacy topology)",
        )
        self._m_mig_rows = registry.counter(
            "row_migration_rows_total",
            "Rows streamed out by live range migrations",
        )
        self._m_mig_bytes = registry.counter(
            "row_migration_bytes_total",
            "Row bytes streamed out by live range migrations",
        )
        self._m_mig_secs = registry.counter(
            "row_migration_seconds_total",
            "Wall seconds spent inside migrate_out (copy + catch-up "
            "+ fence window)",
        )
        self._m_redirects = registry.counter(
            "row_redirects_total",
            "Pulls/pushes redirected because this shard does not own "
            "their buckets under the installed map",
        )
        self._m_replica_reads = registry.counter(
            "row_replica_reads_total",
            "Rows served from this shard's hot-row replica store",
        )
        self._m_durable_wait_timeouts = registry.counter(
            "row_push_durable_wait_timeouts_total",
            "Durable-ack fsync waits abandoned (wait ceiling or the "
            "propagated request deadline expired before the covering "
            "group commit landed; the record itself still commits)",
        )
        self._m_replica_stale = registry.histogram(
            "row_replica_staleness_seconds",
            "Replication lag observed at refresh receipt (home "
            "read-time to replica apply-time, wall clock)",
        )
        self._lock = threading.RLock()
        # ---- placement and resharding (mutated under self._lock) ----
        self._shard_map: Optional[ShardMap] = None
        self._shard_id = 0
        # The outbound migration: {"id", "lo", "hi", "touched": {table:
        # set(ids)}}. The push handler records the applied ids that land
        # in the moving range, so catch-up ships exactly the delta (the
        # checkpoint's own dirty sets stay untouched).
        self._out_migration: Optional[dict] = None
        # Inbound migrations this shard agreed to ingest (the generation
        # fence: ingest_rows for an unregistered id is refused).
        self._ingests: Dict[str, dict] = {}
        # Write fences, [(lo, hi, monotonic deadline)]: a push to a
        # fenced bucket answers "fenced" between a migration's final
        # delta and the cutover's map install.
        self._fences = []
        # Hot-id pull tracking (only once a map is installed), under a
        # lock of its own: the counting is advisory and must never
        # serialise the handlers on the service lock.
        self._hot_lock = threading.Lock()
        self._hot_counts: Dict[str, Counter] = {}
        self._hot_track_pulls = 0
        # This shard's own load counters for shard_stats (the registry's
        # are process-wide).
        self._stat_pulled_rows = 0
        self._stat_pushed_rows = 0
        # The hot-row replica store, {table: {id: (row, applied_at,
        # read_at)}}: rows this shard serves as a read replica.
        self._replica_store: Dict[str, dict] = {}
        self._replica_queue = None
        self._replica_thread = None
        # Shard-to-shard transports (migration streaming, replica
        # refresh); tests and drills set an in-process factory.
        self.transport_factory: Optional[Callable] = None
        self._transports: Dict[str, object] = {}
        self._server: Optional[RpcServer] = None
        self._push_count = 0
        # Per-table update counters, bumped under the lock on every
        # APPLIED push (duplicates changed nothing): the serving cache's
        # invalidation probe (``table_versions``). Not persisted: a
        # restarted service reports 0 again, which a cache comparing by
        # != reads as "changed".
        self._table_versions: Dict[str, int] = {
            name: 0 for name in tables
        }
        # Wall-clock stamp of the last applied push per table (pulls
        # return it; readers in other processes turn it into row
        # freshness, so it is wall clock, not monotonic).
        self._applied_at: Dict[str, float] = {}
        self._checkpoint_steps = 0
        self._saver = None
        self._ckpt_writer = None
        self._ckpt_planner = None
        # Write-ahead push log (storage/pushlog.py), None until
        # configure_push_log: every applied push is queued for the group
        # commit under the lock that applied it, so the log is a total
        # order of this shard's applies.
        self._push_log = None
        # Serialises plan/capture/submit: two pushes at consecutive
        # checkpoint versions must not interleave in the planner, or two
        # deltas name the same prev and the chain walk drops the second.
        # An overlapping interval trigger skips; the drain path waits.
        self._ckpt_trigger = threading.Lock()
        # Push dedup: {client key: last applied seq}, persisted with the
        # checkpoint (_SeqTable).
        self._applied_seq: Dict[int, int] = {}
        if checkpoint_dir:
            self.configure_checkpoint(
                checkpoint_dir, checkpoint_steps, keep_max
            )

    # ---- RPC handlers --------------------------------------------------

    def handlers(self):
        return {
            "table_info": self._table_info,
            "table_versions": self._table_versions_handler,
            "pull_rows": self._pull_rows,
            "push_row_grads": self._push_row_grads,
            "export_rows": self._export_rows,
            # The reshard plane:
            "get_shard_map": self._get_shard_map,
            "set_shard_map": self._set_shard_map,
            "shard_stats": self._shard_stats,
            "migrate_out": self._migrate_out,
            "begin_ingest": self._begin_ingest,
            "end_ingest": self._end_ingest,
            "ingest_rows": self._ingest_rows,
            "ingest_steps": self._ingest_steps,
            "pull_replica_rows": self._pull_replica_rows,
            "replica_refresh": self._replica_refresh,
        }

    def _table_info(self, request: dict) -> dict:
        return {
            "tables": {
                name: {"dim": int(table.dim)}
                for name, table in self._tables.items()
            }
        }

    def _table_versions_handler(self, request: dict) -> dict:
        """Per-table update counters and last-apply stamps: one small
        reply, far cheaper for a cache to poll than re-pulling rows."""
        with self._lock:
            return {"versions": dict(self._table_versions),
                    "applied_at": dict(self._applied_at)}

    # ---- request validation --------------------------------------------
    #
    # The native apply kernels trust the (n_ids, dim) shape they are
    # handed: a wrong-dim or wrong-count grad block would read past the
    # arena and kill the process. Every inbound block is validated
    # before it can reach an apply; InvalidRequest surfaces as
    # INVALID_ARGUMENT to the client.

    def _validated_table(self, request: dict):
        name = request.get("table")
        table = self._tables.get(name) if isinstance(name, str) else None
        if table is None:
            raise InvalidRequest(
                f"unknown table {name!r} (serving "
                f"{sorted(self._tables)})"
            )
        return name, table

    @staticmethod
    def _validated_ids(request: dict) -> np.ndarray:
        raw = request.get("ids")
        if raw is None:
            raise InvalidRequest("ids missing")
        try:
            ids = np.asarray(raw, np.int64)
        except (ValueError, TypeError, OverflowError) as exc:
            raise InvalidRequest(f"ids not an int64 vector: {exc}")
        if ids.ndim != 1:
            raise InvalidRequest(
                f"ids must be 1-D, got shape {ids.shape}"
            )
        return ids

    @staticmethod
    def _validated_grads(request: dict, ids: np.ndarray, table,
                         table_name: str) -> np.ndarray:
        if np.unique(ids).size != ids.size:
            # One update per id: the native path would silently apply
            # a repeated id twice.
            raise InvalidRequest("ids must be unique per push")
        raw = request.get("grads")
        if raw is None:
            raise InvalidRequest("grads missing")
        try:
            grads = np.asarray(raw, np.float32)
        except (ValueError, TypeError) as exc:
            raise InvalidRequest(f"grads not a float32 block: {exc}")
        if grads.ndim != 2:
            raise InvalidRequest(
                f"grads must be 2-D (n_ids, dim), got shape "
                f"{grads.shape}"
            )
        expected = (int(ids.size), int(table.dim))
        if tuple(grads.shape) != expected:
            raise InvalidRequest(
                f"grads shape {tuple(grads.shape)} != "
                f"(len(ids), dim) = {expected} for table "
                f"{table_name!r}"
            )
        return grads

    def _pull_rows(self, request: dict) -> dict:
        t0 = time.monotonic()
        who = wl_principal.current()
        table_name, table = self._validated_table(request)
        ids = self._validated_ids(request)
        # Nests under the RPC server span, so lock wait + store time is
        # told apart from wire time; kept by name past its exit for the
        # latency exemplar below.
        tiered = hasattr(table, "prefault")
        pull_span = tracing.span("row_pull", table=table_name,
                                 rows=int(ids.size),
                                 **wl_principal.span_attrs(who))
        with pull_span:
            if tiered:
                # The cold reads of this pull run outside the service
                # lock: concurrent pushes wait on the in-memory
                # bookkeeping only.
                table.prefault(ids)
            # Explicit acquire/release: the lock-hold meter counts from
            # acquisition, not from the wait.
            self._lock.acquire()
            hold_t0 = time.monotonic()
            try:
                reject = self._reshard_reject_locked(ids)
                if reject is not None:
                    return reject
                rows = (table.get(ids, _defer_sweep=True) if tiered
                        else table.get(ids))
                applied_at = self._applied_at.get(table_name, 0.0)
                self._stat_pulled_rows += int(ids.size)
                map_version = 0
                if self._shard_map is not None:
                    map_version = self._shard_map.version
            finally:
                self._lock.release()
                wl_usage.meter_lock_hold(
                    who, time.monotonic() - hold_t0
                )
            if tiered:
                # The budget sweep after the service lock is released:
                # its cold writes stall no handler but this one.
                table.maybe_sweep()
            if map_version:
                # Hot-id tracking feeds the authority's replica choice:
                # kept only once a map is installed, and outside the
                # service lock.
                self._track_hot(table_name, ids)
        rows = np.asarray(rows, np.float32)
        self._m_pulled.inc(ids.size)
        wl_usage.meter_rows(who, "pull_rows", rows=int(ids.size),
                            nbytes=int(rows.nbytes))
        self._m_pull.observe(time.monotonic() - t0,
                             trace_id=pull_span.trace_id)
        # applied_at rides every pull (0.0 = never pushed), and so does
        # the installed map's version (0 = none), which tells a client
        # about an epoch that moved no row of its own.
        return {"rows": rows,
                "applied_at": applied_at,
                "map_version": map_version}

    def _export_rows(self, request: dict) -> dict:
        """Dense rows for a serving export without inflating the live
        table: trained rows overlay a throwaway table's lazy init.
        ``ids`` (map-routed export, what the port's client sends) asks
        for exactly the ids this shard owns, and redirects like a pull;
        else the range ``lo+offset, lo+offset+stride, ... < hi`` (the
        request of the JAX ``_RemoteTable.export_range``)."""
        table = self._tables[request["table"]]
        if "ids" in request:
            want = np.asarray(request["ids"], np.int64)
            with self._lock:
                reject = self._reshard_reject_locked(want)
                if reject is not None:
                    return reject
                ids, rows = table.to_arrays()
            dense = np.asarray(_clone_empty(table).get(want))
            pos = {int(i): k for k, i in enumerate(want.tolist())}
            for i, row in zip(ids.tolist(), rows):
                at = pos.get(int(i))
                if at is not None:
                    dense[at] = row
            return {"rows": dense.astype(np.float32)}
        lo, hi = int(request["lo"]), int(request["hi"])
        stride = int(request.get("stride", 1))
        offset = int(request.get("offset", 0))
        want = np.arange(lo + offset, hi, stride)
        with self._lock:
            ids, rows = table.to_arrays()
        dense = np.asarray(_clone_empty(table).get(want))
        keep = (ids >= lo + offset) & (ids < hi)
        if stride != 1:
            keep &= (ids - lo - offset) % stride == 0
        dense[(ids[keep] - lo - offset) // stride] = rows[keep]
        return {"rows": dense.astype(np.float32)}

    def _push_row_grads(self, request: dict) -> dict:
        """validate → fault cold rows (tiered) → redirect or fence →
        drop a duplicate (client, seq) → apply → bump the table's version
        and applied_at → record the seq (only after a successful apply) →
        queue the WAL record → note the ids in a moving range (catch-up)
        → wait for the fsync (durable acks) → queue the replica refresh
        → sweep the hot budget (tiered) → at every ``checkpoint_steps``
        push, an interval checkpoint."""
        t0 = time.monotonic()
        who = wl_principal.current()
        table_name, table = self._validated_table(request)
        client = request.get("client", "")
        seq = int(request.get("seq", -1))
        ids = self._validated_ids(request)
        # Shape-gate the grad block before any lock or apply.
        grads = self._validated_grads(request, ids, table, table_name)
        prefault = getattr(table, "prefault_group", None)
        push_span = tracing.span("row_push", table=table_name,
                                 rows=int(ids.size),
                                 **wl_principal.span_attrs(who))
        with push_span:
            if prefault is not None:
                # Cold reads of evicted rows and their optimizer slots
                # outside the service lock; a duplicate push merely
                # promotes rows it would have touched anyway.
                prefault(ids)
            duplicate = False
            wal_ticket = None
            self._lock.acquire()
            hold_t0 = time.monotonic()
            try:
                # Ownership and fence checks before any mutation: a
                # redirected or fenced push applies nothing, so the
                # client's retry (at the new home, or after the cutover)
                # is the first and only apply.
                reject = self._reshard_reject_locked(ids)
                if reject is not None:
                    return reject
                if self._fence_hit_locked(ids):
                    return {"reshard": {"reason": "fenced"}}
                if client and seq >= 0:
                    key = _client_key(client)
                    if seq <= self._applied_seq.get(key, -1):
                        # A retry whose first attempt applied before its
                        # reply was lost.
                        self._m_dup.inc()
                        duplicate = True
                if not duplicate:
                    self._optimizer.apply_gradients(table, ids, grads)
                    self._table_versions[table_name] += 1
                    self._applied_at[table_name] = time.time()
                    if client and seq >= 0:
                        # Only after the apply succeeded: a failed apply
                        # leaves the seq unburned, so the retry applies.
                        self._applied_seq[_client_key(client)] = seq
                    self._push_count += 1
                    version = self._push_count
                    self._stat_pushed_rows += int(ids.size)
                    if self._push_log is not None:
                        # Queued under the lock that applied: log order
                        # == apply order == version order. The fsync
                        # wait comes after the release.
                        wal_ticket = self._push_log.append(
                            version=version, client=client or "",
                            seq=seq, table=table_name, ids=ids,
                            grads=grads,
                            applied_at=self._applied_at[table_name],
                            map_version=(
                                self._shard_map.version
                                if self._shard_map is not None else 0
                            ),
                        )
                    mig = self._out_migration
                    if mig is not None:
                        # Applied writes in the moving range feed the
                        # migration's catch-up delta.
                        b = bucket_of(ids)
                        in_range = (b >= mig["lo"]) & (b < mig["hi"])
                        if in_range.any():
                            mig["touched"].setdefault(
                                table_name, set()
                            ).update(ids[in_range].tolist())
                    refresh_ids = self._replicated_ids_locked(
                        table_name, ids
                    )
            finally:
                self._lock.release()
                wl_usage.meter_lock_hold(
                    who, time.monotonic() - hold_t0
                )
            if duplicate:
                if (self._push_log is not None
                        and self._push_log.ack == "durable"):
                    # A duplicate ack is still an ack: it leaves only
                    # once the first attempt's record is durable.
                    fsync_t0 = time.monotonic()
                    self._durable_wait(self._push_log.barrier)
                    wl_usage.meter_fsync_wait(
                        who, time.monotonic() - fsync_t0
                    )
                return {"duplicate": True}
            if wal_ticket is not None and self._push_log.ack == "durable":
                # The reply leaves only after the group commit covering
                # this record fsyncs; a failed commit raises, so the
                # client never takes the push for durable.
                fsync_t0 = time.monotonic()
                self._durable_wait(
                    lambda budget: wal_ticket.wait(timeout=budget)
                )
                wl_usage.meter_fsync_wait(
                    who, time.monotonic() - fsync_t0
                )
            if refresh_ids is not None:
                # The push-driven replica refresh, queued outside the
                # lock: the refresher thread reads the fresh rows and
                # fans them out to the replica shards.
                self._queue_refresh(table_name, refresh_ids)
            if prefault is not None:
                # The fused apply's budget sweep, with the lock released.
                table.maybe_sweep()
        self._m_pushed.inc(ids.size)
        wl_usage.meter_rows(who, "push_row_grads", rows=int(ids.size),
                            nbytes=int(grads.nbytes))
        self._m_push.observe(time.monotonic() - t0,
                             trace_id=push_span.trace_id)
        if (
            self._saver is not None and self._checkpoint_steps
            and version % self._checkpoint_steps == 0
        ):
            self._checkpoint(version)
        m = self._shard_map
        return {"map_version": m.version if m is not None else 0}

    def configure_push_durable_wait(self, secs: float) -> None:
        """Set the durable-ack fsync wait ceiling
        (``--push_durable_wait_secs``; the zoo's factory builds the
        service before the flags apply)."""
        self._push_durable_wait_secs = float(secs)

    def _durable_wait(self, waiter: Callable[[float], None]) -> None:
        """One durable-ack fsync wait (``waiter(timeout_secs)``) under
        the configured ceiling, shrunk by the propagated request deadline
        when there is one. A wait that runs out counts in
        ``row_push_durable_wait_timeouts_total`` and still raises: the
        client must never learn "durable" from a wait that did not see
        the fsync."""
        from elasticdl_tpu_torch.storage.pushlog import PushLogError

        budget = self._push_durable_wait_secs
        left = wl_deadline.remaining()
        if left is not None:
            budget = min(budget, max(left, 1e-3))
        try:
            waiter(budget)
        except PushLogError as exc:
            # Only the ran-out-of-time shape is a timeout; a failed
            # commit write (a broken WAL disk) must not hide here.
            if "did not complete in time" in str(exc):
                self._m_durable_wait_timeouts.inc()
            raise

    # ---- shard map: enforcement ----------------------------------------

    def _reshard_reject_locked(self, ids: np.ndarray) -> Optional[dict]:
        """REDIRECT verdict for ids this shard does not own under the
        installed map (None: all owned, or no map installed). The
        carried map is how a stale client converges."""
        m = self._shard_map
        if m is None:
            return None
        if m.owns(self._shard_id, ids).all():
            return None
        self._m_redirects.inc()
        return {"reshard": {"reason": "not_owner", "map": m.to_json()}}

    def _fence_hit_locked(self, ids: np.ndarray) -> bool:
        """Whether an id lands in a write-fenced bucket range (between a
        migration's final delta and its cutover). An expired fence lifts
        itself: an authority that died before the cutover re-runs the
        move from scratch."""
        if not self._fences:
            return False
        now = time.monotonic()
        expired = [f for f in self._fences if f[2] <= now]
        if expired:
            # Loud: the migration was abandoned mid-protocol (or the
            # cutover is pathologically slow); writes accepted again here
            # part from the target's copy until the move re-runs.
            for lo, hi, _dl in expired:
                logger.warning(
                    "write fence on buckets [%d, %d) EXPIRED before "
                    "cutover; accepting writes again (the abandoned "
                    "migration must re-run)", lo, hi,
                )
            self._fences = [f for f in self._fences if f[2] > now]
        if not self._fences:
            return False
        b = bucket_of(ids)
        return any(
            bool(((b >= lo) & (b < hi)).any())
            for lo, hi, _deadline in self._fences
        )

    def _track_hot(self, table: str, ids: np.ndarray):
        with self._hot_lock:
            counts = self._hot_counts.setdefault(table, Counter())
            counts.update(ids.tolist())
            self._hot_track_pulls += 1
            if (self._hot_track_pulls % 256 == 0
                    and len(counts) > HOT_TRACK_MAX_IDS):
                # Lossy decay: the head at half weight, the tail dropped,
                # so one-touch ids cannot grow the counter without bound.
                self._hot_counts[table] = Counter({
                    i: n // 2
                    for i, n in counts.most_common(
                        HOT_TRACK_MAX_IDS // 2
                    )
                    if n > 1
                })

    def _replicated_ids_locked(self, table: str,
                               ids: np.ndarray) -> Optional[np.ndarray]:
        """The pushed ids whose replicas need a refresh (None: no
        replication for this table)."""
        m = self._shard_map
        if m is None:
            return None
        per = m.replicas.get(table)
        if not per:
            return None
        hot = [i for i in ids.tolist() if i in per]
        return np.asarray(hot, np.int64) if hot else None

    # ---- shard map: install --------------------------------------------

    def install_shard_map(self, shard_map: ShardMap, shard_id: int):
        """In-process map install (the RPC handler's body)."""
        return self._set_shard_map({
            "map": shard_map.to_json(), "shard_id": int(shard_id),
        })

    def _get_shard_map(self, request: dict) -> dict:
        with self._lock:
            m = self._shard_map
            return {
                "map": m.to_json() if m is not None else None,
                "shard_id": self._shard_id,
            }

    def _set_shard_map(self, request: dict) -> dict:
        """Install a newer map epoch (idempotent at the same version;
        an older one is refused: the monotonic version is the fence).
        A new epoch lifts the fences on ranges this shard no longer
        owns, erases the rows it no longer owns (except those of a
        registered inbound migration, which arrive ahead of the flip),
        prunes replica copies it no longer serves, and warms the
        replicas of the hot ids it homes."""
        fresh = ShardMap.from_json(request["map"])
        shard_id = int(request.get("shard_id", -1))
        with self._lock:
            cur = self._shard_map
            if cur is not None and fresh.version < cur.version:
                return {"accepted": False, "version": cur.version}
            if shard_id >= 0:
                self._shard_id = shard_id
            already = cur is not None and fresh.version == cur.version
            self._shard_map = fresh
            self._m_map_version.set(float(fresh.version))
            erased = 0
            if not already:
                # A fence on a range this shard gave away served its
                # purpose (the cutover landed); writes there redirect.
                kept = [
                    (lo, hi, dl) for lo, hi, dl in self._fences
                    if bool((fresh.owner_table[lo:hi]
                             == self._shard_id).any())
                ]
                for lo, hi, _dl in set(self._fences) - set(kept):
                    logger.info(
                        "write fence on buckets [%d, %d) lifted by the "
                        "cutover to map v%d", lo, hi, fresh.version,
                    )
                self._fences = kept
                erased = self._erase_unowned_locked()
                for table, store in self._replica_store.items():
                    per = fresh.replicas.get(table, {})
                    for i in list(store):
                        if self._shard_id not in per.get(i, ()):
                            del store[i]
        if not already:
            self._warm_replicas()
        return {"accepted": True, "version": fresh.version,
                "erased_rows": erased}

    def _erase_unowned_locked(self) -> int:
        """Drop rows (and their optimizer slots) whose bucket this shard
        no longer owns: every row has one home. Buckets of a registered
        inbound migration are exempt (the copy precedes the flip)."""
        m = self._shard_map
        if m is None:
            return 0
        exempt = [(g["lo"], g["hi"]) for g in self._ingests.values()]
        erased = 0
        for group in self._migration_views().values():
            for table in group.values():
                ids = _all_ids(table)
                if not ids.size:
                    continue
                b = bucket_of(ids)
                drop = m.home_of_ids(ids) != self._shard_id
                for lo, hi in exempt:
                    drop &= ~((b >= lo) & (b < hi))
                if drop.any():
                    erased += int(table.erase(ids[drop]))
        return erased

    # ---- live resharding: migration ------------------------------------

    def _migration_views(self) -> Dict[str, Dict[str, object]]:
        """{primary table: {view name: raw table}}: each table with its
        optimizer slot tables, which move (and are erased) in lockstep.
        Step counters and the seq map are this process's bookkeeping,
        not row state."""
        out = {}
        for name, table in self._tables.items():
            group = {name: table}
            for slot in getattr(self._optimizer.opt, "slot_names", ()):
                group[get_slot_table_name(name, slot)] = (
                    self._optimizer._slot_table(table, slot)
                )
            out[name] = group
        return out

    def _transport(self, addr: str):
        transport = self._transports.get(addr)
        if transport is None:
            if self.transport_factory is not None:
                transport = self.transport_factory(addr)
            else:
                transport = RpcStub(addr, SERVICE_NAME, max_retries=2)
            self._transports[addr] = transport
        return transport

    def _migrate_out(self, request: dict) -> dict:
        """Source side of a live range move: stream every owned row of
        buckets [lo, hi), with its optimizer slots, to the target's
        ``ingest_rows`` chunk by chunk, without stalling pulls and pushes
        (the service lock is held for one chunk's read; a tiered table
        reads cold chunks from its segments). Writes landing in the
        range meanwhile are re-shipped in catch-up rounds; the last
        round fences the range, so the authority flips the map against
        frozen bytes. Returns rows, bytes, seconds and catch-up rounds."""
        mig_id = str(request["migration_id"])
        lo, hi = int(request["lo"]), int(request["hi"])
        target_addr = str(request["target_addr"])
        t0 = time.monotonic()
        transport = self._transport(target_addr)
        views = self._migration_views()
        moved_rows = 0
        moved_bytes = 0
        rounds = 0
        with self._lock:
            if self._out_migration is not None:
                raise RuntimeError(
                    f"migration {self._out_migration['id']} already in "
                    "flight; one outbound move at a time"
                )
            self._out_migration = {
                "id": mig_id, "lo": lo, "hi": hi, "touched": {},
            }
        try:
            # Every ingest RPC below inherits purpose=migration, so the
            # target bills these bytes to the move, never to a push.
            with tracing.span("row_migrate_out", migration=mig_id,
                              lo=lo, hi=hi), \
                    wl_principal.pushed(purpose="migration"):
                for primary, group in views.items():
                    for vname, table in group.items():
                        with self._lock:
                            ids = _all_ids(table)
                        b = bucket_of(ids)
                        sel = ids[(b >= lo) & (b < hi)]
                        for at in range(0, sel.size, MIGRATE_CHUNK_ROWS):
                            chunk = sel[at:at + MIGRATE_CHUNK_ROWS]
                            with self._lock:
                                rows = _peek_rows(table, chunk)
                            transport.call(
                                "ingest_rows", migration_id=mig_id,
                                table=vname, ids=chunk, rows=rows,
                            )
                            moved_rows += int(chunk.size)
                            moved_bytes += int(rows.nbytes)
                            hook = _mid_migrate_hook
                            if hook is not None:
                                hook(self, mig_id, vname, chunk)
                # Catch-up: re-ship the rows written during the copy
                # until the delta drains or the rounds run out; the last
                # swap happens under a write fence, so no push slips
                # between the final delta and the cutover.
                while True:
                    with self._lock:
                        touched = self._out_migration["touched"]
                        drained = not any(touched.values())
                        if drained or rounds >= MIGRATE_CATCHUP_ROUNDS:
                            self._fences.append(
                                (lo, hi,
                                 time.monotonic() + FENCE_TTL_SECS)
                            )
                            logger.info(
                                "write fence on buckets [%d, %d) up "
                                "(migration %s, %d catch-up round(s))",
                                lo, hi, mig_id, rounds,
                            )
                            final = touched
                            self._out_migration["touched"] = {}
                            break
                        self._out_migration["touched"] = {}
                    rounds += 1
                    r, nbytes = self._ship_delta(
                        views, touched, transport, mig_id
                    )
                    moved_rows += r
                    moved_bytes += nbytes
                r, nbytes = self._ship_delta(
                    views, final, transport, mig_id
                )
                moved_rows += r
                moved_bytes += nbytes
                # The per-table apply counts too, inside the fence so
                # they are final: a fresh target would otherwise correct
                # a migrated row's next Adam update as if it were step 1.
                with self._lock:
                    steps = {
                        primary: int(
                            self._optimizer._steps.get(primary, 0)
                        )
                        for primary in views
                    }
                if any(steps.values()):
                    transport.call(
                        "ingest_steps", migration_id=mig_id,
                        steps=steps,
                    )
        finally:
            with self._lock:
                self._out_migration = None
        secs = time.monotonic() - t0
        self._m_mig_rows.inc(moved_rows)
        self._m_mig_bytes.inc(moved_bytes)
        self._m_mig_secs.inc(secs)
        return {
            "rows": moved_rows, "bytes": moved_bytes,
            "seconds": secs, "catchup_rounds": rounds,
        }

    def _ship_delta(self, views, touched: Dict[str, set], transport,
                    mig_id: str):
        """Re-ship the touched rows and their slots (one catch-up round
        or the fenced final one)."""
        rows_out = 0
        bytes_out = 0
        for primary, id_set in touched.items():
            if not id_set:
                continue
            ids = np.asarray(sorted(id_set), np.int64)
            for vname, table in views.get(primary, {}).items():
                with self._lock:
                    rows = _peek_rows(table, ids)
                transport.call(
                    "ingest_rows", migration_id=mig_id,
                    table=vname, ids=ids, rows=rows,
                )
                rows_out += int(ids.size)
                bytes_out += int(rows.nbytes)
        return rows_out, bytes_out

    def _begin_ingest(self, request: dict) -> dict:
        """Target side: register an inbound migration. Chunks of an
        unregistered migration id are refused, so a zombie source of an
        abandoned attempt cannot corrupt a later one."""
        mig_id = str(request["migration_id"])
        with self._lock:
            self._ingests[mig_id] = {
                "lo": int(request["lo"]), "hi": int(request["hi"]),
                "rows": 0,
            }
        return {}

    def _end_ingest(self, request: dict) -> dict:
        with self._lock:
            info = self._ingests.pop(str(request["migration_id"]), None)
        return {"rows": int(info["rows"]) if info else 0}

    def _ingest_rows(self, request: dict) -> dict:
        """One migrated chunk, set into the named view (idempotent: a
        re-run migration ships the same bytes again). ``set`` marks the
        rows dirty when checkpoints are on, so they ride the target's
        next delta."""
        mig_id = str(request["migration_id"])
        vname = str(request["table"])
        ids = np.asarray(request["ids"], np.int64)
        rows = np.asarray(request["rows"], np.float32)
        flat = {}
        for group in self._migration_views().values():
            flat.update(group)
        table = flat.get(vname)
        if table is None:
            raise ValueError(f"ingest for unknown view {vname!r}")
        with self._lock:
            info = self._ingests.get(mig_id)
            if info is None:
                raise ValueError(
                    f"ingest for unregistered migration {mig_id!r} "
                    "(stale source? re-run the migration)"
                )
            table.set(ids, rows)
            info["rows"] += int(ids.size)
        # Billed to the wire principal (the source's purpose=migration).
        wl_usage.meter_rows(wl_principal.current(), "ingest_rows",
                            rows=int(ids.size),
                            nbytes=int(rows.nbytes))
        return {}

    def _ingest_steps(self, request: dict) -> dict:
        """Adopt the source's per-table apply counts by max: a target
        that applied pushes of its own keeps its larger count, a fresh
        split target takes the source's."""
        mig_id = str(request["migration_id"])
        steps = request.get("steps") or {}
        with self._lock:
            if mig_id not in self._ingests:
                raise ValueError(
                    f"steps for unregistered migration {mig_id!r}"
                )
            for table, count in steps.items():
                if table in self._tables:
                    self._optimizer._steps[table] = max(
                        int(self._optimizer._steps.get(table, 0)),
                        int(count),
                    )
        return {}

    # ---- live resharding: load and hot-row read replicas ---------------

    def _shard_stats(self, request: dict) -> dict:
        """Load and hot-set snapshot for the authority's policy tick."""
        top_k = int(request.get("top_k", 64))
        with self._hot_lock:
            hot = {
                table: [[int(i), int(n)]
                        for i, n in counts.most_common(top_k)]
                for table, counts in self._hot_counts.items()
            }
        with self._lock:
            return {
                "shard_id": self._shard_id,
                "map_version": (
                    self._shard_map.version
                    if self._shard_map is not None else 0
                ),
                "pulled_rows": self._stat_pulled_rows,
                "pushed_rows": self._stat_pushed_rows,
                "num_rows": {
                    name: int(t.num_rows)
                    for name, t in self._tables.items()
                    if hasattr(t, "num_rows")
                },
                "hot": hot,
            }

    def _pull_replica_rows(self, request: dict) -> dict:
        """Hot-id reads from the replica store, with a found mask: a
        miss (its refresh not landed yet) falls back to the home on the
        client. A replica speeds reads up and is never needed for one."""
        table = str(request["table"])
        ids = np.asarray(request["ids"], np.int64)
        dim = int(self._tables[table].dim)
        rows = np.zeros((ids.size, dim), np.float32)
        found = np.zeros(ids.size, bool)
        applied_at = 0.0
        with self._lock:
            store = self._replica_store.get(table, {})
            stamps = []
            for k, i in enumerate(ids.tolist()):
                entry = store.get(i)
                if entry is not None:
                    rows[k] = entry[0]
                    found[k] = True
                    stamps.append(entry[1])
            if stamps:
                # The oldest served copy's stamp: the conservative
                # freshness bound.
                applied_at = min(stamps)
        self._m_replica_reads.inc(int(found.sum()))
        wl_usage.meter_rows(wl_principal.current(), "pull_replica_rows",
                            rows=int(found.sum()),
                            nbytes=int(rows.nbytes))
        return {"rows": rows, "found": found, "applied_at": applied_at}

    def _replica_refresh(self, request: dict) -> dict:
        """A home's copy of hot rows: store them and observe the
        replication lag (the home's read time to now, wall clock).

        ``map_version`` is the epoch the home fanned out under. One newer
        than ours is taken whole (the home installs a new map first and
        warms at once, racing our install; our install prunes what it
        turns out not to replicate here). At or below ours, each id must
        be designated to this shard, so a zombie home's stale fan-out
        cannot bring copies back."""
        table = str(request["table"])
        ids = np.asarray(request["ids"], np.int64)
        rows = np.asarray(request["rows"], np.float32)
        applied_at = float(request.get("applied_at", 0.0))
        read_at = float(request.get("read_at", 0.0))
        sender_version = int(request.get("map_version", 0))
        now = time.time()
        with self._lock:
            m = self._shard_map
            ahead = m is None or sender_version > m.version
            store = self._replica_store.setdefault(table, {})
            for k, i in enumerate(ids.tolist()):
                if not ahead and self._shard_id not in (
                    m.replica_targets(table, i)
                ):
                    continue  # a stale designation: not served
                store[i] = (rows[k].copy(), applied_at, read_at)
        if read_at:
            self._m_replica_stale.observe(max(0.0, now - read_at))
        wl_usage.meter_rows(wl_principal.current(), "replica_refresh",
                            rows=int(ids.size),
                            nbytes=int(rows.nbytes))
        return {}

    def _queue_refresh(self, table: str, ids: np.ndarray):
        if self._replica_thread is None:
            import queue as _queue

            with self._lock:
                if self._replica_thread is None:
                    self._replica_queue = _queue.Queue(maxsize=128)
                    self._replica_thread = threading.Thread(
                        target=self._replica_loop, daemon=True,
                        name="row-replica-refresh",
                    )
                    self._replica_thread.start()
        try:
            self._replica_queue.put_nowait((table, ids))
        except Exception:
            # A full queue drops this refresh: replicas are best-effort
            # copies of bounded staleness; the next push queues again.
            pass

    def _replica_loop(self):
        while True:
            item = self._replica_queue.get()
            if item is None:
                return
            table, ids = item
            try:
                self._do_refresh(table, ids)
            except Exception as exc:
                logger.warning("replica refresh failed: %s", exc)

    def _do_refresh(self, table_name: str, ids: np.ndarray):
        with self._lock:
            m = self._shard_map
            if m is None:
                return
            per = m.replicas.get(table_name)
            if not per:
                return
            table = self._tables[table_name]
            if hasattr(table, "contains"):
                ids = ids[table.contains(ids)]
            if not ids.size:
                return
            rows = _peek_rows(table, ids)
            applied_at = self._applied_at.get(table_name, 0.0)
            shards = list(m.shards)
            map_version = m.version
        read_at = time.time()
        targets: Dict[int, list] = {}
        for k, i in enumerate(ids.tolist()):
            for s in per.get(i, ()):
                if s != self._shard_id:
                    targets.setdefault(s, []).append(k)
        # The refresher thread has no principal of its own: the fan-out
        # bills to purpose=replica_refresh at the receiving shards.
        with wl_principal.pushed(purpose="replica_refresh"):
            for s, picks in targets.items():
                sel = np.asarray(picks, np.intp)
                try:
                    self._transport(shards[s]).call(
                        "replica_refresh", table=table_name,
                        ids=ids[sel], rows=rows[sel],
                        applied_at=applied_at, read_at=read_at,
                        map_version=map_version,
                    )
                except Exception as exc:
                    logger.warning(
                        "replica refresh to shard %d failed: %s", s, exc
                    )

    def _warm_replicas(self):
        """On a new map: push this shard's owned, materialised
        replicated ids out once, so replicas start warm (afterwards the
        pushes drive the refreshes)."""
        with self._lock:
            m = self._shard_map
            if m is None:
                return
            work = []
            for table, per in m.replicas.items():
                if table not in self._tables or not per:
                    continue
                ids = np.fromiter(per.keys(), np.int64,
                                  count=len(per))
                owned = ids[m.owns(self._shard_id, ids)]
                if owned.size:
                    work.append((table, owned))
        for table, owned in work:
            self._queue_refresh(table, owned)

    # ---- tiered storage ------------------------------------------------

    def configure_tiering(self, cold_dir: str, hot_budget_rows: int,
                          segment_max_bytes: int = 8 << 20,
                          compact_live_fraction: float = 0.5,
                          background_compact: bool = True):
        """Re-house every table behind a two-tier store (a hot arena of
        at most ``hot_budget_rows`` rows a table, colder rows in
        CRC-framed segments under ``cold_dir``; ``storage/tiered.py``),
        so this shard serves tables larger than host RAM as long as the
        working set fits the budget.

        Must run before ``configure_checkpoint``: that enables dirty
        tracking on the table views it sees, and once tiering is on the
        tier wrapper owns it (a row demoted while dirty must still ride
        the next delta)."""
        from elasticdl_tpu_torch.storage import TierPolicy, tier_host_tables

        with self._lock:
            if self._saver is not None:
                raise RuntimeError(
                    "configure_tiering must run before "
                    "configure_checkpoint (dirty tracking moves to the "
                    "tier wrapper)"
                )
            self._tables = tier_host_tables(
                self._tables, cold_dir,
                TierPolicy(
                    hot_budget_rows,
                    segment_max_bytes=segment_max_bytes,
                    compact_live_fraction=compact_live_fraction,
                    background_compact=background_compact,
                ),
            )
            for table in self._tables.values():
                # The handlers sweep after releasing the service lock
                # (maybe_sweep); an apply must not also sweep inside it.
                table.defer_apply_sweep = True
        logger.info(
            "Row service tiering on: hot budget %d rows/table, cold "
            "tier at %s", hot_budget_rows, cold_dir,
        )
        return self

    def tier_stats(self) -> Dict[str, dict]:
        """Per-table tier occupancy and garbage."""
        with self._lock:
            return {
                name: table.tier_stats()
                for name, table in self._tables.items()
                if hasattr(table, "tier_stats")
            }

    # ---- checkpoint ----------------------------------------------------

    def configure_checkpoint(self, checkpoint_dir: str,
                             checkpoint_steps: int = 0, keep_max: int = 3,
                             delta_chain_max: int = 8,
                             async_write: bool = True):
        """Attach (or re-point) the checkpoint saver and restore the
        newest valid version (chain-aware).

        ``delta_chain_max`` > 0: interval saves write deltas (the rows
        and slots dirtied since the previous save), with a periodic full
        base. ``async_write``: the push handler pays only the capture
        and an enqueue; serialisation and IO run on the bounded
        background writer (``CheckpointWriter``)."""
        from elasticdl_tpu_torch.checkpoint.saver import (
            ChainPlanner,
            CheckpointSaver,
        )
        from elasticdl_tpu_torch.checkpoint.writer import CheckpointWriter

        if self._ckpt_writer is not None:
            # Land (and surface) anything queued on the old writer.
            self._ckpt_writer.close()
        self._saver = CheckpointSaver(
            checkpoint_dir, keep_max=keep_max,
            delta_chain_max=delta_chain_max,
        )
        self._ckpt_writer = CheckpointWriter(
            max_pending=1, sync=not async_write
        )
        self._ckpt_planner = ChainPlanner(delta_chain_max)
        self._checkpoint_steps = int(checkpoint_steps)
        for view in self.host_tables.values():
            # Dirty tracking on now that a consumer drains it (tables
            # start with it off: the set would grow without bound on a
            # service that never checkpoints).
            enable = getattr(view, "enable_dirty_tracking", None)
            if enable is not None:
                enable()
        self._restore_latest()
        return self

    # ---- write-ahead push log ------------------------------------------

    def configure_push_log(self, log_dir: str, group_ms: float = 2.0,
                           ack: str = "durable",
                           segment_max_bytes: int = 8 << 20):
        """Attach the write-ahead push log (``storage/pushlog.py``) and
        replay its tail: every record past the restored checkpoint
        version is applied again through the normal apply path, where the
        checkpointed (client, seq) map makes the replay idempotent and
        the installed shard map filters ranges that moved away.

        Must run after ``configure_checkpoint`` (the chain first, then
        the log's tail) and after ``configure_tiering``. With no
        checkpoint the whole log replays.

        ``ack="durable"`` (default): a push's reply waits for the group
        commit covering its record (RPO 0). ``ack="applied"``: replies
        return after the in-memory apply (RPO one ``group_ms`` window).
        """
        from elasticdl_tpu_torch.observability import default_registry
        from elasticdl_tpu_torch.storage.pushlog import PushLog

        if self._push_log is not None:
            self._push_log.close()
        log = PushLog(
            log_dir, group_ms=group_ms, ack=ack,
            segment_max_bytes=segment_max_bytes,
        )
        m_replayed = default_registry().counter(
            "row_push_log_replayed_records_total",
            "Push-log records re-applied on relaunch (past the "
            "restored checkpoint version)",
        )
        with self._lock:
            restored = self._push_count
        replayed = covered = 0
        # The replay's cold faults and apply work meter as
        # purpose=replay, never as the client traffic they once were.
        with wl_principal.pushed(purpose="replay"):
            for record in log.replay_records():
                if self._replay_push_record(record):
                    replayed += 1
                else:
                    covered += 1
        if replayed:
            m_replayed.inc(replayed)
        for table in self._tables.values():
            # The replay deferred every budget sweep: one a table brings
            # the hot arena back under budget before serving starts.
            sweep = getattr(table, "maybe_sweep", None)
            if sweep is not None:
                sweep()
        # Sealed segments at or below the restored version are covered
        # by the chain: reclaim them now rather than scan them at every
        # relaunch.
        log.truncate_through(restored)
        self._push_log = log
        logger.info(
            "Row service push log at %s (ack=%s, group %.1fms): "
            "replayed %d record(s) past checkpoint version %d "
            "(%d already covered/filtered)",
            log_dir, ack, group_ms, replayed, restored, covered,
        )
        return self

    def _replay_push_record(self, record: dict) -> bool:
        """Apply one logged push again on relaunch. Returns whether it
        changed state (False: covered by the restored checkpoint,
        deduped, or wholly moved away). The push version advances either
        way: checkpoint versions keep counting from where the dead
        process stopped."""
        version = int(record["v"])
        table_name = str(record["table"])
        with self._lock:
            if version <= self._push_count:
                return False  # the restored chain holds it
            applied = False
            table = self._tables.get(table_name)
            if table is None:
                logger.warning(
                    "push-log record v%d names unknown table %r; "
                    "skipped (different model module?)",
                    version, table_name,
                )
            else:
                ids = np.asarray(record["ids"], np.int64)
                grads = np.asarray(record["grads"], np.float32)
                if self._shard_map is not None:
                    # Ranges that moved away between the record and the
                    # checkpointed map belong to another shard now.
                    own = self._shard_map.owns(self._shard_id, ids)
                    ids, grads = ids[own], grads[own]
                client = str(record.get("client") or "")
                seq = int(record.get("seq", -1))
                dup = bool(
                    client and seq >= 0
                    and seq <= self._applied_seq.get(
                        _client_key(client), -1
                    )
                )
                if ids.size and not dup:
                    prefault = getattr(table, "prefault_group", None)
                    if prefault is not None:
                        # Replay runs alone at startup: the cold reads
                        # under the lock contend with nobody.
                        prefault(ids)
                    self._optimizer.apply_gradients(table, ids, grads)
                    self._table_versions[table_name] += 1
                    self._applied_at[table_name] = max(
                        self._applied_at.get(table_name, 0.0),
                        float(record.get("applied_at", 0.0)),
                    )
                    self._stat_pushed_rows += int(ids.size)
                    applied = True
                if client and seq >= 0 and not dup:
                    self._applied_seq[_client_key(client)] = seq
            self._push_count = version
        return applied

    def _checkpoint(self, version: int, blocking: bool = False) -> bool:
        """Capture under ONE lock acquisition (rows, slots, step
        counters and the seq map at the same version), then hand the
        write to the background writer. An interval trigger that finds
        the writer busy skips (its rows stay dirty and ride the next
        save); the drain path (``checkpoint_now``) waits for its turn.
        Returns whether a write was enqueued."""
        if not self._ckpt_trigger.acquire(blocking=blocking):
            return False
        try:
            # Checkpoint work, not the triggering push's.
            with wl_principal.pushed(purpose="checkpoint"):
                return self._checkpoint_locked(version, blocking)
        finally:
            self._ckpt_trigger.release()

    def _checkpoint_locked(self, version: int, blocking: bool) -> bool:
        if not blocking and self._ckpt_writer.busy:
            return False
        from elasticdl_tpu_torch.checkpoint.saver import (
            CorruptCheckpointError,
            capture_tables,
            remark_dirty,
        )

        t0 = time.monotonic()
        plan, base, prev = self._ckpt_planner.plan(version)
        with self._lock:
            # The shard map snapshots with the rows: a restored shard
            # comes back owning exactly the rows the checkpoint holds.
            captured, dirty_ids = capture_tables(
                self.host_tables, delta=plan == "delta"
            )
            meta = {}
            if self._shard_map is not None:
                meta = {
                    "shard_map": self._shard_map.to_json(),
                    "shard_id": self._shard_id,
                }

        def remark():
            remark_dirty(self.host_tables, dirty_ids)

        def write():
            try:
                if plan == "delta":
                    if not self._saver.element_exists(prev):
                        # The predecessor's write failed ahead of us: a
                        # delta on it could not be restored.
                        raise CorruptCheckpointError(
                            f"delta {version}: predecessor {prev} "
                            "never became durable; restarting chain"
                        )
                    self._saver.save_delta(
                        version, {}, captured, base, prev, meta=meta
                    )
                else:
                    self._saver.save(
                        version, {}, embeddings=captured, meta=meta
                    )
                log = self._push_log
                if log is not None:
                    # The version is durable now (the save fsyncs and
                    # publishes before it returns): sealed log segments
                    # it covers may go. Truncation runs only here, on
                    # the writer, after the publish.
                    log.truncate_through(int(version))
            except BaseException:
                # Put the drained rows back and restart the chain from a
                # fresh base.
                remark()
                self._ckpt_planner.reset()
                raise

        def write_tagged():
            with wl_principal.pushed(purpose="checkpoint"):
                write()

        try:
            ok = self._ckpt_writer.submit(
                write_tagged, label=f"rows-v{version}-{plan}",
                block=blocking
            )
        except RuntimeError:
            # The writer closed under us (stop() racing a push across an
            # interval): the push applied; skip the save.
            ok = False
        if not ok:
            remark()
            self._ckpt_planner.reset()
        self._m_stall.observe(time.monotonic() - t0)
        return ok

    def checkpoint_now(self) -> bool:
        """A durable checkpoint at the current push count (the SIGTERM
        drain): waits for its writer turn and flushes before returning.
        False when no saver is configured."""
        if self._saver is None:
            return False
        # Land queued writes first: the disk's tip lags the queue.
        self._ckpt_writer.flush()
        with self._lock:
            version = self._push_count
        if self._saver.get_valid_latest_version() == version:
            return True
        ok = self._checkpoint(version, blocking=True)
        self._ckpt_writer.flush()
        return ok

    def _restore_latest(self):
        try:
            version, _, embeddings = self._saver.restore()
        except FileNotFoundError:
            return
        targets = self.host_tables
        missing = [n for n in targets if n not in embeddings]
        if missing:
            raise ValueError(
                "row-service checkpoint lacks payload for "
                f"{sorted(missing)}; different optimizer or tables?"
            )
        for name, view in targets.items():
            ids, rows = embeddings[name].to_arrays()
            if ids.size:
                view.set(ids, rows)
            if getattr(view, "supports_dirty_rows", False):
                # The disk already holds the restored rows.
                view.clear_dirty()
        self._push_count = int(version)
        # The map rides the checkpoint meta: a relaunched shard routes
        # and enforces the epoch it was saved under.
        map_json = self._saver.last_restored_meta.get("shard_map")
        if map_json and self._shard_map is None:
            self._shard_map = ShardMap.from_json(map_json)
            self._shard_id = int(
                self._saver.last_restored_meta.get("shard_id", 0))
            self._m_map_version.set(float(self._shard_map.version))
        logger.info(
            "Row service restored version %d (%d tables)",
            version, len(targets),
        )

    # ---- lifecycle -----------------------------------------------------

    def start(self, addr: str = "localhost:0",
              tag: str = "", max_workers: int = 64,
              admission_limit: int = 0) -> "HostRowService":
        """``tag`` names this shard to chaos fault plans
        (``rowservice/0``); ``max_workers`` bounds handler concurrency;
        ``admission_limit`` > 0 installs priority admission control
        (``comm/overload.py``) in front of every handler."""
        admission = None
        if admission_limit > 0:
            admission = wl_overload.AdmissionController(
                admission_limit, tag=tag or SERVICE_NAME,
            )
        self._server = RpcServer(
            addr, {SERVICE_NAME: self.handlers()}, tag=tag,
            max_workers=max_workers, admission=admission,
        ).start()
        logger.info("Row service on port %d", self._server.port)
        return self

    @property
    def port(self) -> int:
        return self._server.port

    def stop(self, grace: Optional[float] = None):
        if self._server is not None:
            # Drain in-flight handlers before closing the writer: a push
            # crossing an interval must not meet a closed writer.
            ev = self._server.stop(grace)
            if ev is not None:
                ev.wait((grace or 0) + 30.0)
        if self._push_log is not None:
            try:
                # Drain the group-commit queue (one last fsync) after
                # the handlers drained: every push the service applied
                # is on disk before the process exits.
                self._push_log.close()
            except BaseException as exc:
                logger.error("push-log drain on stop failed: %s", exc)
        if self._ckpt_writer is not None:
            try:
                self._ckpt_writer.close()
            except BaseException as exc:
                logger.error(
                    "checkpoint flush on stop failed: %s", exc
                )
        if self._replica_thread is not None:
            # Retire the replica refresher after the handlers drained, so
            # no push can re-arm it.
            self._replica_queue.put(None)
            self._replica_thread.join(timeout=10.0)
            self._replica_thread = None
        for transport in self._transports.values():
            close = getattr(transport, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass
        self._transports.clear()
        for table in self._tables.values():
            # Tiered tables: flush the cold segments, stop the compactor
            # and write the index snapshot (the clean-close marker that
            # ``tools.check_store`` audits).
            group = getattr(table, "tier_group", None)
            if group is not None:
                try:
                    group.close()
                except BaseException as exc:
                    logger.error("cold-tier close failed: %s", exc)

    def wait(self):
        """Block until the server stops (process-main lifetime)."""
        self._server.wait()

    @property
    def host_tables(self) -> Dict:
        """Rows + optimizer slots + step counters + the push-dedup map,
        lock-guarded: what the service's checkpoints carry."""
        from elasticdl_tpu_torch.embedding.host_engine import (
            _LockedTable,
            locked_checkpoint_tables,
        )

        out = locked_checkpoint_tables(
            self._tables, self._optimizer, self._lock
        )
        out[SEQS_TABLE_NAME] = _LockedTable(_SeqTable(self), self._lock)
        return out


# CANCELLED is transient too: a GOAWAY during service shutdown cancels
# calls in flight, and every method here is safe to retry (pulls are
# idempotent; pushes dedup by (client, seq)). RESOURCE_EXHAUSTED is an
# admission shed with a retry-after hint in its detail.
_TRANSIENT_CODES = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "CANCELLED",
                    "RESOURCE_EXHAUSTED")


class ReshardRedirect(Exception):
    """The shard does not own the requested buckets under its map:
    retry against the carried (newer) map. Nothing was applied."""

    def __init__(self, map_json):
        super().__init__("row home moved (stale shard-map epoch)")
        self.map_json = map_json


class ReshardFenced(Exception):
    """Writes to the range are briefly fenced (a migration is between
    its final delta and the cutover): back off and retry."""


def _check_reshard(resp: dict):
    info = resp.get("reshard") if isinstance(resp, dict) else None
    if not info:
        return
    if info.get("reason") == "fenced":
        raise ReshardFenced()
    raise ReshardRedirect(info.get("map"))


def _call_with_retry(stub: RpcStub, method: str, retries: int,
                     backoff_secs: float, hedge=None, **fields):
    """Ride out a service relaunch: bounded decorrelated-jitter backoff
    on transport codes only (INTERNAL, a handler's error, surfaces at
    once).

    Every retry spends a token of the shared ``RowService:rideout``
    budget (``comm/overload.py``); a denied spend waits for the refill
    rather than abandon the ride-out. A shed's retry-after hint
    overrides the local backoff, and an expired deadline ends the
    ride-out.

    ``hedge`` (an ``overload.HedgeTimer``) makes each attempt of an
    idempotent read a hedged pair: a second identical send after the
    tracked p99 delay, the first answer wins. The hedge rides inside
    the retry loop (one budgeted attempt, one hedged pair), never around
    it: two stacked ride-outs would double the worst case."""
    delay = backoff_secs
    budget = None
    if wl_overload.controls_enabled():
        budget = wl_overload.retry_budget_for("RowService:rideout")
    for attempt in range(retries + 1):
        try:
            if hedge is not None:
                t0 = time.monotonic()
                resp = wl_overload.hedged_call(
                    lambda: stub.call(method, **fields),
                    lambda: stub.call(method, **fields),
                    hedge.delay(), service=SERVICE_NAME, method=method,
                )
                hedge.observe(time.monotonic() - t0)
            else:
                resp = stub.call(method, **fields)
            if budget is not None:
                budget.on_success()
            return resp
        except RpcError as exc:
            if (exc.code not in _TRANSIENT_CODES
                    or attempt == retries
                    or EXPIRED_DETAIL in str(exc)
                    or wl_deadline.expired()):
                raise
            while budget is not None and not budget.try_spend():
                if wl_deadline.expired():
                    raise
                time.sleep(0.25)
            hint = None
            if exc.code == "RESOURCE_EXHAUSTED":
                hint = wl_overload.parse_retry_after(str(exc))
            sleep_for = delay if hint is None else hint
            left = wl_deadline.remaining()
            if left is not None:
                sleep_for = min(sleep_for, max(left, 0.0))
            logger.warning(
                "row service %s failed (attempt %d/%d); retrying in %.1fs",
                method, attempt + 1, retries, sleep_for,
            )
            time.sleep(sleep_for)
            # A fresh channel per retry: a channel whose connects were
            # refused while the service restarted can wedge for good.
            stub.reconnect()
            delay = decorrelated_jitter(delay, base=backoff_secs,
                                        cap=30.0)


class _RemoteTable:
    """Table-like view pulling rows over RPC (writes happen on the
    server through the optimizer's push). ``concurrent_safe``: the stub
    is thread-safe and the server serialises row access."""

    concurrent_safe = True

    def __init__(self, stub: RpcStub, name: str, dim: int,
                 retries: int = 12, backoff_secs: float = 0.5,
                 hedge=None):
        self._stub = stub
        self.name = name
        self.dim = dim
        self._retries = retries
        self._backoff = backoff_secs
        # The fleet's shared overload.HedgeTimer (None: no hedging).
        self._hedge = hedge
        # The service's last-apply stamp as of our newest pull.
        self.last_applied_at = 0.0
        # The newest map epoch piggybacked on this shard's replies.
        self.last_map_version = 0

    def get(self, ids) -> np.ndarray:
        resp = _call_with_retry(
            self._stub, "pull_rows", self._retries, self._backoff,
            hedge=self._hedge,
            table=self.name, ids=np.asarray(ids, np.int64),
        )
        _check_reshard(resp)
        self.last_applied_at = float(resp.get("applied_at", 0.0) or 0.0)
        self.last_map_version = int(resp.get("map_version", 0) or 0)
        return np.asarray(resp["rows"], np.float32)

    def fetch_map(self) -> Optional[dict]:
        return _call_with_retry(
            self._stub, "get_shard_map", self._retries, self._backoff,
        ).get("map")

    def pull_replica(self, ids) -> dict:
        """Hot-id read from this shard's replica store, with a found
        mask (the caller falls back to the home on a miss)."""
        resp = _call_with_retry(
            self._stub, "pull_replica_rows", self._retries,
            self._backoff, hedge=self._hedge, table=self.name,
            ids=np.asarray(ids, np.int64),
        )
        stamp = float(resp.get("applied_at", 0.0) or 0.0)
        if stamp > 0:
            self.last_applied_at = stamp
        return resp

    def export_ids(self, ids) -> np.ndarray:
        """Dense rows for explicit ids (trained rows over lazy init);
        redirects like a pull."""
        resp = _call_with_retry(
            self._stub, "export_rows", self._retries, self._backoff,
            table=self.name, ids=np.asarray(ids, np.int64),
        )
        _check_reshard(resp)
        return np.asarray(resp["rows"], np.float32)

    def pull_version(self) -> int:
        """This table's update counter on the service."""
        resp = _call_with_retry(
            self._stub, "table_versions", self._retries, self._backoff,
        )
        return int(resp["versions"][self.name])


class _RemoteOptimizer:
    """Optimizer-like view pushing row gradients over RPC; the server
    applies them.

    Each pushing thread gets its own client id (a fresh counter, never a
    thread ident, which is reused after a thread dies): the server drops
    any seq <= the client's last applied, so two threads sharing one
    stream would lose whichever concurrent push arrived second. Within a
    thread, seqs rise, so a retried push after a lost reply dedups."""

    concurrent_safe = True

    def __init__(self, stub: RpcStub, retries: int = 12,
                 backoff_secs: float = 0.5):
        import uuid

        self._stub = stub
        self._retries = retries
        self._backoff = backoff_secs
        self._client_base = uuid.uuid4().hex
        self._local = threading.local()
        self._client_counter = itertools.count()
        self._counter_lock = threading.Lock()

    def apply_gradients(self, table, ids, grads):
        if not hasattr(self._local, "client"):
            with self._counter_lock:
                n = next(self._client_counter)
            self._local.client = f"{self._client_base}-{n}"
            self._local.seq = 0
        self._local.seq += 1
        resp = _call_with_retry(
            self._stub, "push_row_grads", self._retries, self._backoff,
            table=table.name,
            ids=np.asarray(ids, np.int64),
            grads=np.asarray(grads, np.float32),
            client=self._local.client, seq=self._local.seq,
        )
        # A redirected or fenced push applied nothing; the burned seq is
        # harmless (dedup needs only monotonic seqs).
        _check_reshard(resp)
        return table


_RESHARD_ATTEMPTS = 20
_FENCE_BACKOFF_SECS = 0.02


def _run_jobs(pool, jobs):
    """Run job thunks, on the pool only when there is real fan-out (a
    one-shard wave stays inline). Each job is bound to the submitting
    thread's deadline (``comm/deadline.py``), so a wave spends one
    budget across its shard legs."""
    if pool is None or len(jobs) == 1:
        for job in jobs:
            job()
        return
    futures = [pool.submit(wl_deadline.bind(job)) for job in jobs]
    for f in futures:
        f.result()


class _ShardRegistry:
    """One stub / remote table / remote optimizer per shard address,
    made lazily (a map learned from a REDIRECT can name an address the
    engine was never given), plus the fan-out pool. Shared by every
    table and the optimizer of one engine."""

    def __init__(self, retries: int, backoff_secs: float,
                 hedge_reads: bool = False):
        self._retries = retries
        self._backoff = backoff_secs
        self._lock = threading.Lock()
        self._stubs: Dict[str, RpcStub] = {}
        self._tables: Dict = {}
        self._optimizers: Dict = {}
        self._pool = None
        # One p99 tracker for the whole fleet: the hedge delay models
        # "slower than the fleet's tail", not one shard's own (a stalled
        # shard must not teach itself that stalls are normal).
        self._hedge = (wl_overload.HedgeTimer()
                       if hedge_reads else None)

    def stub(self, addr: str) -> RpcStub:
        with self._lock:
            stub = self._stubs.get(addr)
            if stub is None:
                # max_retries=0: _call_with_retry owns the retry budget.
                stub = RpcStub(addr, SERVICE_NAME, max_retries=0)
                self._stubs[addr] = stub
            return stub

    def table(self, addr: str, name: str, dim: int) -> "_RemoteTable":
        key = (addr, name)
        with self._lock:
            table = self._tables.get(key)
        if table is None:
            table = _RemoteTable(
                self.stub(addr), name, dim, self._retries, self._backoff,
                hedge=self._hedge,
            )
            with self._lock:
                table = self._tables.setdefault(key, table)
        return table

    def tables_named(self, name: str):
        with self._lock:
            return [t for (_a, n), t in self._tables.items()
                    if n == name]

    def optimizer(self, addr: str) -> "_RemoteOptimizer":
        with self._lock:
            opt = self._optimizers.get(addr)
        if opt is None:
            opt = _RemoteOptimizer(
                self.stub(addr), self._retries, self._backoff
            )
            with self._lock:
                opt = self._optimizers.setdefault(addr, opt)
        return opt

    @property
    def pool(self):
        with self._lock:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(
                    max_workers=16, thread_name_prefix="row-shard",
                )
            return self._pool


def _adopt_redirect(outcome, olock, positions, exc: ReshardRedirect):
    """Keep the newest map a wave's redirects carried, and mark the
    redirected positions for the next wave."""
    with olock:
        cur = outcome["map"]
        if cur is None or (
            exc.map_json and exc.map_json["version"] > cur["version"]
        ):
            outcome["map"] = exc.map_json
        outcome["unresolved"].extend(positions.tolist())


class _ShardedTable:
    """Client-side scatter/gather over the shard fleet, routed through
    the shared ``ClientShardMap``: a row's home is the shard that owns
    its bucket under the newest epoch this client has seen. A stale
    epoch surfaces as a REDIRECT carrying the newer map; the holder
    adopts it and only the unresolved ids retry. Hot ids with replicas
    spread their reads over home and replicas (round robin); a replica
    miss falls back to the home, and writes never touch a replica."""

    concurrent_safe = True

    def __init__(self, name: str, dim: int, cmap: ClientShardMap,
                 registry: _ShardRegistry):
        self.name = name
        self.dim = int(dim)
        self._cmap = cmap
        self._reg = registry
        self._rr = itertools.count()

    def _remote(self, m: ShardMap, shard: int) -> "_RemoteTable":
        return self._reg.table(m.shards[shard], self.name, self.dim)

    def get(self, ids) -> np.ndarray:
        ids = np.ascontiguousarray(np.asarray(ids, np.int64).ravel())
        out = np.empty((ids.size, self.dim), np.float32)
        pending = np.arange(ids.size, dtype=np.intp)
        force_home = np.zeros(ids.size, bool)
        delay = _FENCE_BACKOFF_SECS
        for _attempt in range(_RESHARD_ATTEMPTS):
            m = self._cmap.get()
            sub = ids[pending]
            home = m.home_of_ids(sub)
            target = home.copy()
            via_replica = np.zeros(pending.size, bool)
            per = m.replicas.get(self.name)
            if per:
                rr = next(self._rr)
                for k in range(pending.size):
                    if force_home[pending[k]]:
                        continue
                    reps = per.get(int(sub[k]))
                    if reps:
                        cands = (int(home[k]),) + tuple(
                            s for s in reps if s != home[k]
                        )
                        pick = cands[rr % len(cands)]
                        if pick != home[k]:
                            target[k] = pick
                            via_replica[k] = True
            outcome = {"map": None, "unresolved": [], "refresh": None}
            olock = threading.Lock()
            jobs = []
            for s in sorted(set(target.tolist())):
                for is_rep in (False, True):
                    mask = (target == s) & (via_replica == is_rep)
                    if mask.any():
                        jobs.append(self._pull_job(
                            m, int(s), is_rep, pending[mask], ids,
                            out, outcome, olock, force_home,
                        ))
            _run_jobs(
                self._reg.pool if len(jobs) > 1 else None, jobs
            )
            if outcome["refresh"] is not None:
                # A shard piggybacked a newer epoch without redirecting
                # (a replica-only change): fetch it so the next pulls
                # route by it.
                try:
                    fresh = outcome["refresh"].fetch_map()
                    if fresh:
                        self._cmap.update(fresh)
                except RpcError:
                    pass  # opportunistic; the next pull asks again
            if outcome["map"] is not None:
                progressed = self._cmap.update(outcome["map"])
            else:
                # A replica miss makes progress too: its ids go home.
                progressed = bool(
                    force_home[np.asarray(outcome["unresolved"],
                                          np.intp)].any()
                ) if outcome["unresolved"] else False
            if not outcome["unresolved"]:
                return out
            pending = np.asarray(sorted(outcome["unresolved"]),
                                 np.intp)
            if not progressed:
                # No newer map and no replica fallback: wait out the
                # server's transition.
                time.sleep(delay)
                delay = min(delay * 2, 4.0)
        raise RuntimeError(
            f"row pulls for table {self.name!r} kept redirecting "
            f"after {_RESHARD_ATTEMPTS} attempts (shard-map churn?)"
        )

    def _pull_job(self, m, shard, is_replica, positions, ids, out,
                  outcome, olock, force_home):
        def job():
            remote = self._remote(m, shard)
            try:
                if is_replica:
                    resp = remote.pull_replica(ids[positions])
                    found = np.asarray(resp["found"], bool)
                    rows = np.asarray(resp["rows"], np.float32)
                    out[positions[found]] = rows[found]
                    miss = positions[~found]
                    if miss.size:
                        with olock:
                            outcome["unresolved"].extend(miss.tolist())
                            force_home[miss] = True
                else:
                    out[positions] = remote.get(ids[positions])
                    if remote.last_map_version > m.version:
                        with olock:
                            outcome["refresh"] = remote
            except ReshardRedirect as exc:
                _adopt_redirect(outcome, olock, positions, exc)
            except RpcError:
                if not is_replica:
                    raise
                # A dead replica must not fail the read: the home
                # answers instead.
                with olock:
                    outcome["unresolved"].extend(positions.tolist())
                    force_home[positions] = True
        return job

    def pull_version(self) -> int:
        """Sum of the fleet's update counters under the current map: a
        push on any shard changes it."""
        m = self._cmap.get()
        return sum(
            self._remote(m, s).pull_version()
            for s in range(len(m.shards))
        )

    @property
    def last_applied_at(self) -> float:
        """The OLDEST last-apply stamp among shards that reported one
        (the conservative freshness bound: max() would let healthy
        shards hide one whose pushes stalled)."""
        stamps = [
            t.last_applied_at
            for t in self._reg.tables_named(self.name)
            if t.last_applied_at > 0
        ]
        return min(stamps) if stamps else 0.0

    def export_dense(self, vocab: int, chunk: int = 65536) -> np.ndarray:
        """Each shard exports only the ids it owns under the current map
        (explicit-id ``export_rows``), merged here; redirects retry like
        pulls."""
        parts = []
        for lo in range(0, int(vocab), chunk):
            want = np.arange(lo, min(lo + chunk, int(vocab)),
                             dtype=np.int64)
            out = np.empty((want.size, self.dim), np.float32)
            pending = np.arange(want.size, dtype=np.intp)
            for _attempt in range(_RESHARD_ATTEMPTS):
                m = self._cmap.get()
                home = m.home_of_ids(want[pending])
                outcome = {"map": None, "unresolved": []}
                olock = threading.Lock()
                jobs = [
                    self._export_job(m, int(s), pending[home == s],
                                     want, out, outcome, olock)
                    for s in sorted(set(home.tolist()))
                ]
                _run_jobs(
                    self._reg.pool if len(jobs) > 1 else None, jobs
                )
                if outcome["map"] is not None:
                    self._cmap.update(outcome["map"])
                if not outcome["unresolved"]:
                    break
                pending = np.asarray(sorted(outcome["unresolved"]),
                                     np.intp)
            else:
                raise RuntimeError(
                    f"export for table {self.name!r} kept redirecting"
                )
            parts.append(out)
        return np.concatenate(parts, axis=0)

    def _export_job(self, m, shard, positions, want, out, outcome,
                    olock):
        def job():
            try:
                out[positions] = self._remote(m, shard).export_ids(
                    want[positions]
                )
            except ReshardRedirect as exc:
                _adopt_redirect(outcome, olock, positions, exc)
        return job


class _ShardedOptimizer:
    """Push scatter over the fleet, routed through the same map: each
    shard receives only the row gradients it homes. A sub-push either
    applies whole or is refused whole (the server checks ownership and
    fences first), so a redirect retries only its own ids under the
    newer map, and nothing applies twice."""

    concurrent_safe = True

    def __init__(self, cmap: ClientShardMap, registry: _ShardRegistry):
        self._cmap = cmap
        self._reg = registry

    def apply_gradients(self, table, ids, grads):
        ids = np.ascontiguousarray(np.asarray(ids, np.int64).ravel())
        grads = np.asarray(grads, np.float32)
        pending = np.arange(ids.size, dtype=np.intp)
        delay = _FENCE_BACKOFF_SECS
        for _attempt in range(_RESHARD_ATTEMPTS):
            m = self._cmap.get()
            home = m.home_of_ids(ids[pending])
            outcome = {"map": None, "fenced": False, "unresolved": []}
            olock = threading.Lock()
            jobs = [
                self._push_job(m, int(s), table, ids, grads,
                               pending[home == s], outcome, olock)
                for s in sorted(set(home.tolist()))
            ]
            _run_jobs(
                self._reg.pool if len(jobs) > 1 else None, jobs
            )
            progressed = (outcome["map"] is not None
                          and self._cmap.update(outcome["map"]))
            if not outcome["unresolved"]:
                return table
            pending = np.asarray(sorted(outcome["unresolved"]),
                                 np.intp)
            if outcome["fenced"] or not progressed:
                time.sleep(delay)
                delay = min(delay * 2, 4.0)
        raise RuntimeError(
            "row pushes kept redirecting/fenced after "
            f"{_RESHARD_ATTEMPTS} attempts (shard-map churn?)"
        )

    def _push_job(self, m, shard, table, ids, grads, positions,
                  outcome, olock):
        def job():
            opt = self._reg.optimizer(m.shards[shard])
            try:
                opt.apply_gradients(
                    table, ids[positions], grads[positions]
                )
            except ReshardRedirect as exc:
                _adopt_redirect(outcome, olock, positions, exc)
            except ReshardFenced:
                with olock:
                    outcome["fenced"] = True
                    outcome["unresolved"].extend(positions.tolist())
        return job


def make_remote_engine(
    addr: str, id_keys: Dict[str, str],
    retries: int = 12, backoff_secs: float = 0.5,
    hedge_reads: bool = False,
) -> HostEmbeddingEngine:
    """Client-side engine over running ``HostRowService`` shard(s).

    ``addr`` is one address or a comma list: the bootstrap fleet. The
    engine adopts the newest map any listed shard has installed, or
    builds the bootstrap map over the listed addresses (the servers
    then never redirect). A topology change under a live engine
    surfaces as a retryable REDIRECT carrying the newer map. Pulls and
    pushes retry across a shard relaunch (0.5 s doubling, capped at
    30 s, 12 retries: about 4 minutes). ``hedge_reads`` makes pulls and
    replica reads hedged (``comm/overload.py``): a second send after the
    fleet's p99 delay, the first answer wins."""
    addrs = [a.strip() for a in addr.split(",") if a.strip()]
    if not addrs:
        raise ValueError("empty row-service address")
    registry = _ShardRegistry(retries, backoff_secs,
                              hedge_reads=hedge_reads)
    stubs = [registry.stub(a) for a in addrs]
    infos = [
        _call_with_retry(stub, "table_info", retries, backoff_secs)[
            "tables"
        ]
        for stub in stubs
    ]
    for a, info in zip(addrs[1:], infos[1:]):
        if info != infos[0]:
            raise ValueError(
                f"row-service shard {a} serves different tables "
                f"({sorted(info)}) than shard {addrs[0]} "
                f"({sorted(infos[0])}); all shards must run the same "
                "model module"
            )
    best = None
    for stub in stubs:
        try:
            resp = _call_with_retry(
                stub, "get_shard_map", retries, backoff_secs
            )
        except RpcError:
            continue
        map_json = resp.get("map")
        if map_json and (
            best is None or map_json["version"] > best["version"]
        ):
            best = map_json
    cmap = ClientShardMap(
        ShardMap.from_json(best) if best is not None
        else ShardMap.bootstrap(addrs)
    )
    tables = {
        name: _ShardedTable(name, meta["dim"], cmap, registry)
        for name, meta in infos[0].items()
    }
    optimizer = _ShardedOptimizer(cmap, registry)
    engine = HostEmbeddingEngine(tables, optimizer, id_keys=id_keys)
    engine.remote = True  # the service owns checkpointing
    engine.shard_map = cmap  # routing-epoch introspection (tests)
    return engine


# Placement scheme recorded in shard_layout.json: bucket-range shard
# maps. A marker without the field predates the map (the id % N era).
PLACEMENT_SCHEME = "bucket-range-v1"


def validate_shard_layout(checkpoint_dir: str, shard: int,
                          num_shards: int):
    """Refuse to restore a checkpoint written under another static
    shard layout or placement scheme: the rows whose home moved would
    silently come back as lazy inits. ``shard_layout.json`` records the
    layout; a directory holding versions but no marker is the one-shard
    layout."""
    import json
    import os

    marker = os.path.join(checkpoint_dir, "shard_layout.json")
    if os.path.exists(marker):
        with open(marker) as fh:
            recorded = json.load(fh)
    else:
        from elasticdl_tpu_torch.checkpoint.saver import CheckpointSaver

        has_versions = bool(
            os.path.isdir(checkpoint_dir)
            and CheckpointSaver(checkpoint_dir).list_versions()
        )
        if not has_versions:
            os.makedirs(checkpoint_dir, exist_ok=True)
            with open(marker, "w") as fh:
                json.dump({"shard": shard, "num_shards": num_shards,
                           "placement": PLACEMENT_SCHEME}, fh)
            return
        recorded = {"shard": 0, "num_shards": 1}  # pre-shard layout
    recorded_placement = recorded.get(
        "placement",
        # One shard owns everything under every scheme.
        PLACEMENT_SCHEME if int(recorded.get("num_shards", 1)) == 1
        else "id-mod-n",
    )
    if (
        int(recorded.get("num_shards", 1)) != num_shards
        or int(recorded.get("shard", 0)) != shard
        or recorded_placement != PLACEMENT_SCHEME
    ):
        raise SystemExit(
            f"checkpoint {checkpoint_dir} was written as shard "
            f"{recorded.get('shard', 0)}/{recorded.get('num_shards', 1)}"
            f" (placement {recorded_placement}) but this process is "
            f"shard {shard}/{num_shards} (placement "
            f"{PLACEMENT_SCHEME}); changing the static shard layout "
            "across a restore would silently lose the rows whose home "
            "moved. Start a fresh checkpoint dir (or repartition "
            "offline via checkpoint.saver), or grow the fleet live "
            "through the shard-map controller (master/row_reshard.py)."
        )


# main's flags whose JAX code is not ported yet: they raise when given.
_NOT_PORTED_FLAGS = {
    "profile_hz": "the sampling profiler",
    "profile_window_secs": "the sampling profiler",
    "master_addr": "the metrics reporter to the master",
    "metrics_report_secs": "the metrics reporter to the master",
}


def main(argv=None):
    """Process entry: ``python -m elasticdl_tpu_torch.embedding.row_service
    --model_zoo ... --model_def ... [--addr :6100] [--checkpoint_dir ...]``.
    The zoo module supplies ``make_row_service()``. The service keeps its
    tables in host RAM (and, with ``--hot_budget_rows``, its colder rows
    on disk) and touches no CUDA. ``--shard_id/--num_shards`` record the
    shard layout, so a relaunch under another layout fails loudly
    (``validate_shard_layout``). Tiering is configured before the
    checkpoint (a restore streams through the budget), the push log
    after it (the chain is restored first, then the log's tail
    replayed)."""
    import argparse
    import signal

    from elasticdl_tpu_torch.core.model_spec import load_model_zoo_module

    parser = argparse.ArgumentParser("elasticdl_tpu_torch-row-service")
    parser.add_argument("--model_zoo", required=True)
    parser.add_argument("--model_def", required=True)
    parser.add_argument("--addr", default="[::]:6100")
    parser.add_argument("--checkpoint_dir", default="")
    parser.add_argument("--checkpoint_steps", type=int, default=0)
    parser.add_argument("--keep_checkpoint_max", type=int, default=3)
    parser.add_argument("--checkpoint_delta_chain", type=int, default=8,
                        help="Max delta checkpoints riding one full base "
                             "before a save compacts into a fresh base; "
                             "0 = full snapshots only")
    parser.add_argument("--checkpoint_sync", action="store_true",
                        help="Write checkpoints inline on the push "
                             "handler instead of the background writer")
    parser.add_argument("--push_log_dir", default="",
                        help="Write-ahead push log directory: every "
                             "applied push is group-committed to disk "
                             "and replayed on relaunch, so acked pushes "
                             "survive SIGKILL independently of the "
                             "checkpoint cadence. Empty (default) = off")
    parser.add_argument("--push_log_group_ms", type=float, default=2.0,
                        help="Group-commit window: one fsync covers "
                             "every push landing within it")
    parser.add_argument("--push_log_ack", default="durable",
                        choices=["durable", "applied"],
                        help="durable (default): push replies wait "
                             "for the covering fsync (RPO=0). "
                             "applied: reply after the in-memory "
                             "apply (RPO = one group window)")
    parser.add_argument("--push_durable_wait_secs", type=float,
                        default=60.0,
                        help="Ceiling on the durable-ack fsync wait "
                             "in the push path; a propagated request "
                             "deadline shrinks it per push. Abandoned "
                             "waits count in "
                             "row_push_durable_wait_timeouts_total")
    parser.add_argument("--admission_limit", type=int, default=0,
                        help="Priority admission control: bound on "
                             "concurrently admitted handlers; beyond "
                             "it, requests shed lowest-priority-first "
                             "with a retryable RESOURCE_EXHAUSTED. "
                             "0 (default) = off")
    parser.add_argument("--hot_budget_rows", type=int, default=0,
                        help="Tiered storage: max rows a table resident "
                             "in the hot in-memory arena; colder rows "
                             "spill to CRC-framed disk segments. "
                             "0 (default) = everything in memory")
    parser.add_argument("--cold_dir", default="",
                        help="Cold-tier segment directory (a spill "
                             "cache, wiped on start: checkpoints own "
                             "durability). Default: <checkpoint_dir>_cold,"
                             " or a tempdir when no checkpoint dir is "
                             "set")
    parser.add_argument("--cold_segment_mb", type=int, default=8,
                        help="Cold-tier segment file size bound (MB)")
    parser.add_argument("--cold_compact_live_fraction", type=float,
                        default=0.5,
                        help="Compact a cold segment when its live "
                             "record fraction drops below this")
    parser.add_argument("--shard_id", type=int, default=0)
    parser.add_argument("--num_shards", type=int, default=1)
    parser.add_argument("--metrics_port", type=int, default=-1,
                        help="Serve this process's registry as "
                             "Prometheus /metrics; 0 = ephemeral, -1 "
                             "(default) = disabled")
    parser.add_argument("--flight_recorder", type=int, default=0,
                        help="Install a span flight recorder of this "
                             "many entries (served on /traces next to "
                             "/metrics); 0 (default) = tracing off")
    for flag in _NOT_PORTED_FLAGS:
        parser.add_argument(f"--{flag}", default=None,
                            help=f"Not ported yet (ROADMAP Queue 1, "
                                 f"item 8f): {_NOT_PORTED_FLAGS[flag]}")
    args = parser.parse_args(argv)
    for flag, what in _NOT_PORTED_FLAGS.items():
        if getattr(args, flag) is not None:
            raise NotImplementedError(f"--{flag}: {what} {_ITEM_8F}")

    module, _ = load_model_zoo_module(args.model_zoo, args.model_def)
    factory = getattr(module, "make_row_service", None)
    if factory is None:
        raise SystemExit(
            f"{args.model_def}: module defines no make_row_service()"
        )
    service = factory()
    if args.hot_budget_rows > 0:
        # Before the checkpoint: a restore streams through the tier (the
        # budget holds from the first row), and dirty tracking lands on
        # the tier wrapper.
        cold_dir = args.cold_dir
        if not cold_dir:
            if args.checkpoint_dir:
                cold_dir = args.checkpoint_dir.rstrip("/") + "_cold"
            else:
                import tempfile

                cold_dir = tempfile.mkdtemp(prefix="edl_cold_")
        service.configure_tiering(
            cold_dir, args.hot_budget_rows,
            segment_max_bytes=args.cold_segment_mb << 20,
            compact_live_fraction=args.cold_compact_live_fraction,
        )
    if args.checkpoint_dir:
        validate_shard_layout(
            args.checkpoint_dir, args.shard_id, args.num_shards
        )
        service.configure_checkpoint(
            args.checkpoint_dir, args.checkpoint_steps,
            args.keep_checkpoint_max,
            delta_chain_max=args.checkpoint_delta_chain,
            async_write=not args.checkpoint_sync,
        )
    if args.push_log_dir:
        # After the checkpoint: restore the chain, then replay the log's
        # tail through the normal apply path.
        service.configure_push_log(
            args.push_log_dir, group_ms=args.push_log_group_ms,
            ack=args.push_log_ack,
        )
    service.configure_push_durable_wait(args.push_durable_wait_secs)
    service.start(args.addr, tag=f"rowservice/{args.shard_id}",
                  admission_limit=args.admission_limit)
    logger.info("Row service serving on %s", args.addr)

    def _graceful(_sig, _frame):
        # Planned eviction: land a durable checkpoint, drain the
        # handlers, flush the push-log queue.
        logger.warning(
            "SIGTERM: draining row service (checkpoint + push-log "
            "flush)"
        )
        try:
            service.checkpoint_now()
        except BaseException as exc:
            logger.error("drain checkpoint failed: %s", exc)
        service.stop(grace=5.0)

    try:
        signal.signal(signal.SIGTERM, _graceful)
    except ValueError:
        pass  # not the main thread (embedded use)
    if args.flight_recorder > 0:
        tracing.set_process_role("rowservice", str(args.shard_id))
        tracing.install_recorder(
            tracing.FlightRecorder(args.flight_recorder)
        )
    if args.metrics_port >= 0:
        from elasticdl_tpu_torch.observability import (
            MetricsHTTPServer,
            default_registry,
            render_prometheus,
        )

        MetricsHTTPServer(
            lambda: render_prometheus(default_registry().snapshot()),
            port=args.metrics_port,
            traces=lambda: {"spans": tracing.recorder_spans()},
            render_openmetrics=lambda: render_prometheus(
                default_registry().snapshot(), exemplars=True
            ),
        ).start()
    service.wait()


if __name__ == "__main__":
    main()
