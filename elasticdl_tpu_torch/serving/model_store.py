"""Multi-version bundle management for the online serving plane (port of
elasticdl_tpu/serving/model_store.py).

- ``ModelStore`` watches an export root: a directory of versioned
  bundle subdirectories, or one bundle directory. A bundle is eligible
  once ``metadata.json`` exists (written last by the exporter).
- New versions load on the store's poll thread, never on the serving
  thread; one reference swap publishes them. The previous ``retain``
  versions stay resident for ``rollback()``, which pins the dropped
  version out of later polls. A failed load backs off with decorrelated
  jitter (rate-capped further by the shared retry budget).
- Each version is its own module instance: a reload never writes into
  the weights the batcher is using.
- ``ServedModel.predict`` is the one entry the server calls. For a
  row-service bundle (``metadata.host_serving``) it resolves the host
  tables' ids first (``HostRowResolver``): dedup the batch's raw ids,
  read the unique rows from the ``HotRowCache`` and pull the misses from
  the live row service (``embedding/row_service.py``), bucket-pad the
  block to a power of two, and hand the inverse maps and the blocks to
  the predictor, which places each block on the model's device once.
"""

import json
import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.embedding.host_engine import bucket_size
from elasticdl_tpu_torch.observability import default_registry, tracing
from elasticdl_tpu_torch.serving.export import (
    HOST_ROWS_FEATURE_PREFIX,
    META_FILE,
    load_predictor,
)

logger = get_logger("model_store")


class HotRowCache:
    """Per-replica LRU over ``(table, id) -> row`` with version-based
    invalidation, in front of the row service (the one source of truth).

    Freshness: every ``version_check_secs`` each table's update counter
    (``pull_version``, one small reply) is compared with the one seen
    when the cache was filled; a changed counter drops all of that
    table's entries, so the next resolve re-pulls. The periodic probe
    runs on a background thread, so a warm resolve touches no socket.
    ``version_check_secs=0`` probes inline on every resolve
    (read-your-writes); below 0 never probes (immutable tables).

    Thread-safe; ``ModelStore`` hands one cache to every version it
    loads, so a hot reload keeps the warm rows."""

    def __init__(self, capacity: int = 100_000,
                 version_check_secs: float = 0.05,
                 metrics_registry=None):
        self.capacity = int(capacity)
        self.version_check_secs = float(version_check_secs)
        self._lock = threading.Lock()
        self._rows: "OrderedDict[Tuple[str, int], np.ndarray]" = \
            OrderedDict()
        self._versions: Dict[str, int] = {}
        # Per-table invalidation epoch, bumped when the counter moves: a
        # fill whose pull straddled an invalidation is dropped
        # (put_many), or its rows would outlive the staleness bound.
        self._epochs: Dict[str, int] = {}
        # The row service's applied-push stamp carried by the pull that
        # filled each table: a cache hit still knows its rows' age.
        self._applied_at: Dict[str, float] = {}
        self._probe_tables: Dict = {}
        self._probe_stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None

        registry = metrics_registry or default_registry()
        self._m_hits = registry.counter(
            "serving_row_cache_hits_total",
            "Unique rows served from the hot-row cache",
        )
        self._m_misses = registry.counter(
            "serving_row_cache_misses_total",
            "Unique rows pulled from the row service on cache miss",
        )
        self._m_evictions = registry.counter(
            "serving_row_cache_evictions_total",
            "Rows evicted by LRU capacity pressure",
        )
        self._m_invalidations = registry.counter(
            "serving_row_cache_invalidations_total",
            "Rows dropped because a table's update counter moved",
        )
        self_ref = weakref.ref(self)
        registry.gauge(
            "serving_row_cache_rows",
            "Rows currently resident in the hot-row cache",
        ).set_function(
            lambda: float(len(self_ref()._rows)) if self_ref() else 0.0
        )

    def __len__(self) -> int:
        return len(self._rows)

    # ---- invalidation --------------------------------------------------

    def maybe_check_versions(self, tables: Dict):
        """Freshness hook, called once a resolve. With a positive
        interval it (re)arms the background probe against the current
        tables and returns; with 0 it probes inline."""
        if self.version_check_secs < 0:
            return
        if self.version_check_secs == 0:
            self._check_versions(tables)
            return
        self._probe_tables = tables
        if self._probe_thread is None:
            with self._lock:
                if self._probe_thread is not None:
                    return
                self._probe_thread = threading.Thread(
                    target=self._probe_loop, daemon=True,
                    name="row-cache-versions",
                )
            self._probe_thread.start()

    def _probe_loop(self):
        while not self._probe_stop.wait(self.version_check_secs):
            try:
                self._check_versions(self._probe_tables)
            except Exception:
                logger.exception("row cache version probe loop failed")

    def stop(self):
        self._probe_stop.set()
        thread = self._probe_thread
        if thread is not None:
            thread.join(timeout=5)

    def _check_versions(self, tables: Dict):
        """Read each table's update counter; drop a table's entries when
        it moved. Tables without ``pull_version`` never invalidate. A
        failed probe invalidates too: freshness cannot be proved, and
        the next pull surfaces the real error."""
        for name, table in tables.items():
            probe = getattr(table, "pull_version", None)
            if probe is None:
                continue
            try:
                version = int(probe())
            except Exception:
                logger.warning(
                    "row cache version probe failed for table %s; "
                    "invalidating", name, exc_info=True,
                )
                version = None
            with self._lock:
                if name in self._versions \
                        and self._versions.get(name) != version:
                    self._epochs[name] = self._epochs.get(name, 0) + 1
                    dropped = [key for key in self._rows if key[0] == name]
                    for key in dropped:
                        del self._rows[key]
                    if dropped:
                        self._m_invalidations.inc(len(dropped))
                if version is None:
                    self._versions.pop(name, None)
                else:
                    self._versions[name] = version

    # ---- lookup / fill -------------------------------------------------

    def get_many(self, table: str, ids: np.ndarray,
                 out: np.ndarray) -> np.ndarray:
        """Fill ``out[i]`` for every cached id; returns the boolean miss
        mask. Hits move to most recently used."""
        miss = np.zeros(len(ids), bool)
        with self._lock:
            for i, raw_id in enumerate(ids):
                key = (table, int(raw_id))
                row = self._rows.get(key)
                if row is None:
                    miss[i] = True
                else:
                    self._rows.move_to_end(key)
                    out[i] = row
        hits = int(len(ids) - miss.sum())
        if hits:
            self._m_hits.inc(hits)
        if miss.any():
            self._m_misses.inc(int(miss.sum()))
        return miss

    def table_epoch(self, table: str) -> int:
        """Read before pulling; pass to ``put_many`` so a fill whose
        pull straddled an invalidation is dropped."""
        with self._lock:
            return self._epochs.get(table, 0)

    def applied_at(self, table: str) -> float:
        """The row service's applied-push stamp as of the pull that last
        filled this table's entries (0.0: unknown)."""
        with self._lock:
            return self._applied_at.get(table, 0.0)

    def put_many(self, table: str, ids: np.ndarray, rows: np.ndarray,
                 epoch: Optional[int] = None,
                 applied_at: Optional[float] = None):
        if self.capacity <= 0:
            return
        evicted = 0
        with self._lock:
            if applied_at:
                self._applied_at[table] = max(
                    self._applied_at.get(table, 0.0), float(applied_at)
                )
            if epoch is not None and self._epochs.get(table, 0) != epoch:
                # Pulled before an invalidation landed: the rows may
                # predate the push behind it. Dropping costs one re-pull.
                return
            for raw_id, row in zip(ids, rows):
                # Copy: the caller's block is a scratch buffer.
                self._rows[(table, int(raw_id))] = np.array(row, np.float32)
                self._rows.move_to_end((table, int(raw_id)))
            while len(self._rows) > self.capacity:
                self._rows.popitem(last=False)
                evicted += 1
        if evicted:
            self._m_evictions.inc(evicted)

    def stats(self) -> dict:
        with self._lock:
            return {
                "rows": len(self._rows),
                "capacity": self.capacity,
                "versions": dict(self._versions),
            }


class HostRowResolver:
    """Inference-time resolution of host-table ids against the row plane.

    Rewrites a combined batch's raw-id features into (inverse map,
    bucket-padded row block) pairs, with the training engine's dedup and
    bucket discipline, so the shapes a model sees stay O(log unique
    ids) per table. Rows come from remote tables
    (``make_row_service_tables``) or any table-like with
    ``get(ids) -> (n, dim)``."""

    def __init__(self, host_serving: dict, tables: Dict,
                 feature_signature: Optional[dict] = None,
                 row_cache: Optional[HotRowCache] = None,
                 metrics_registry=None):
        self._id_keys = dict(host_serving["id_keys"])
        self._dims = {k: int(v) for k, v in host_serving["tables"].items()}
        self._prefix = host_serving.get("rows_feature_prefix",
                                        HOST_ROWS_FEATURE_PREFIX)
        missing = set(self._id_keys) - set(tables)
        if missing:
            raise ValueError(
                f"row source serves no table(s) {sorted(missing)} "
                f"required by the bundle"
            )
        self._tables = tables
        # Inverse maps in the dtype the bundle recorded for the id
        # feature (int32 without a signature), as the JAX artifact's
        # strict input check needs them.
        self._id_dtypes = {}
        signature = feature_signature or {}
        for table_name, key in self._id_keys.items():
            spec = signature.get(key) if isinstance(signature, dict) \
                else None
            self._id_dtypes[table_name] = np.dtype(
                spec["dtype"] if isinstance(spec, dict)
                and "dtype" in spec else np.int32
            )
        self._cache = row_cache

        registry = metrics_registry or default_registry()
        self._m_resolve_seconds = registry.histogram(
            "serving_row_resolve_seconds",
            "Sparse-feature resolution latency per predict batch "
            "(dedup + row fetch + bucket-pad)",
        )
        self._m_resolve_rows = registry.counter(
            "serving_row_resolve_rows_total",
            "Unique rows resolved, by source",
            labelnames=("source",),
        )
        # Push-to-servable freshness: the age of the row service's last
        # applied push at read time (pulls carry the stamp; cache hits
        # use the stamp recorded at fill).
        self._m_freshness = registry.histogram(
            "row_freshness_seconds",
            "Push-to-servable latency: age of the row service's last "
            "applied push at serving-read time",
            exemplars=True,
        )

    def resolve(self, features: dict) -> dict:
        if not isinstance(features, dict):
            raise TypeError(
                "row-service bundles need dict features carrying the "
                f"id keys {sorted(self._id_keys.values())}"
            )
        t0 = time.monotonic()
        cache_hits = 0
        pulled = 0
        out = dict(features)
        with tracing.span("row_resolve") as resolve_span:
            if self._cache is not None:
                self._cache.maybe_check_versions(self._tables)
            for table_name, key in self._id_keys.items():
                raw = np.asarray(out[key])
                uniq, inverse = np.unique(raw, return_inverse=True)
                bucket = bucket_size(len(uniq))
                dim = self._dims[table_name]
                rows = np.zeros((bucket, dim), np.float32)
                table = self._tables[table_name]
                applied_at = 0.0
                if self._cache is not None:
                    block = rows[: len(uniq)]
                    miss = self._cache.get_many(table_name, uniq, block)
                    if miss.any():
                        epoch = self._cache.table_epoch(table_name)
                        fetched = np.asarray(table.get(uniq[miss]),
                                             np.float32)
                        block[miss] = fetched
                        applied_at = float(getattr(
                            table, "last_applied_at", 0.0) or 0.0)
                        self._cache.put_many(
                            table_name, uniq[miss], fetched,
                            epoch=epoch, applied_at=applied_at,
                        )
                    else:
                        applied_at = self._cache.applied_at(table_name)
                    cache_hits += int(len(uniq) - miss.sum())
                    pulled += int(miss.sum())
                else:
                    rows[: len(uniq)] = np.asarray(table.get(uniq),
                                                   np.float32)
                    applied_at = float(getattr(
                        table, "last_applied_at", 0.0) or 0.0)
                    pulled += len(uniq)
                if applied_at > 0:
                    self._m_freshness.observe(
                        max(0.0, time.time() - applied_at)
                    )
                out[key] = inverse.reshape(raw.shape).astype(
                    self._id_dtypes[table_name]
                )
                out[self._prefix + table_name] = rows
            resolve_span.set(cache_hits=cache_hits, pulled=pulled,
                             tables=len(self._id_keys))
        if cache_hits:
            self._m_resolve_rows.labels(source="cache").inc(cache_hits)
        if pulled:
            self._m_resolve_rows.labels(source="pull").inc(pulled)
        self._m_resolve_seconds.observe(time.monotonic() - t0)
        return out


def make_row_service_tables(addr: str, host_serving: dict,
                            retries: int = 12,
                            backoff_secs: float = 0.5) -> Dict:
    """Pull-only remote tables over running row-service shard(s) (a
    comma list of addresses): the serving counterpart of
    ``make_remote_engine``; inference never pushes."""
    from elasticdl_tpu_torch.embedding.row_service import make_remote_engine

    engine = make_remote_engine(
        addr, id_keys=dict(host_serving["id_keys"]),
        retries=retries, backoff_secs=backoff_secs,
    )
    return engine.tables


class ServedModel:
    """One loaded, callable bundle version."""

    def __init__(self, path: str, version: int, meta: dict,
                 predictor: Callable,
                 resolver: Optional[HostRowResolver] = None):
        self.path = path
        self.version = int(version)
        self.meta = meta
        self._predictor = predictor
        self._resolver = resolver

    @property
    def batch_polymorphic(self) -> bool:
        return bool(self.meta.get("batch_polymorphic", False))

    @property
    def static_batch_size(self) -> Optional[int]:
        """The one batch size a non-polymorphic bundle serves."""
        if self.batch_polymorphic:
            return None
        return int(self.meta.get("batch_size", 0)) or None

    def predict(self, features):
        if self._resolver is not None:
            features = self._resolver.resolve(features)
        return np.asarray(self._predictor(features))


def load_served_model(bundle_dir: str, device=None,
                      model_fn: Optional[Callable] = None,
                      row_service_addr: str = "",
                      row_cache: Optional[HotRowCache] = None,
                      metrics_registry=None) -> ServedModel:
    """Load one bundle directory into a ``ServedModel``.

    A row-service bundle (``metadata.host_serving``) needs its row
    source, ``row_service_addr`` (a comma list of shards); dense
    bundles ignore it. ``row_cache`` is a shared ``HotRowCache`` the
    resolver reads before pulling."""
    with open(os.path.join(bundle_dir, META_FILE)) as f:
        meta = json.load(f)
    resolver = None
    host_serving = meta.get("host_serving")
    if host_serving:
        if not row_service_addr:
            raise ValueError(
                f"bundle {bundle_dir} was exported in row-service "
                "mode; pass --row_service_addr so the server can pull "
                "rows at inference time"
            )
        resolver = HostRowResolver(
            host_serving,
            make_row_service_tables(row_service_addr, host_serving),
            feature_signature=meta.get("feature_signature"),
            row_cache=row_cache, metrics_registry=metrics_registry,
        )
    predictor = load_predictor(bundle_dir, device=device, model_fn=model_fn)
    # A JAX bundle is batch-polymorphic when its StableHLO was; the
    # port's module serves any batch either way.
    meta = dict(meta, batch_polymorphic=True)
    return ServedModel(bundle_dir, meta.get("model_version", 0), meta,
                       predictor, resolver)


class ModelStore:
    """Version discovery + atomic hot reload + N-version rollback.

    ``device`` is resolved at construction (CUDA unless "cpu"; raises
    with no GPU); every version loads onto it through ``model_fn`` when
    given, and reads its rows from ``row_service_addr``.
    ``row_cache_capacity`` > 0 shares one ``HotRowCache`` across every
    version."""

    def __init__(self, root: str, device=None,
                 model_fn: Optional[Callable] = None,
                 row_service_addr: str = "",
                 retain: int = 1, poll_seconds: float = 2.0,
                 row_cache_capacity: int = 0,
                 row_cache_version_check_secs: float = 0.05,
                 metrics_registry=None):
        self.root = root
        self.device = resolve_device(device)
        self._retain = max(0, int(retain))
        self._poll_seconds = float(poll_seconds)
        self.row_cache: Optional[HotRowCache] = None
        if row_cache_capacity > 0:
            self.row_cache = HotRowCache(
                row_cache_capacity,
                version_check_secs=row_cache_version_check_secs,
                metrics_registry=metrics_registry,
            )
        self._model_fn = model_fn
        self._row_service_addr = row_service_addr
        self._metrics_registry = metrics_registry
        self._lock = threading.Lock()
        self._current: Optional[ServedModel] = None
        self._previous: List[ServedModel] = []  # newest last
        self._rejected = set()  # rolled-back versions (operator pin)
        # Load failures back off instead of pinning: a row-service
        # bundle can fail while its row plane restarts, and re-exporting
        # a checkpoint reuses its version number.
        # {version: (consecutive failures, next retry time, backoff)}
        self._load_failures: Dict[int, tuple] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        registry = metrics_registry or default_registry()
        self._m_version = registry.gauge(
            "serving_model_version", "Model version currently served",
        )
        self._m_reloads = registry.counter(
            "serving_model_reloads_total", "Successful hot reloads",
            labelnames=("result",),
        )
        self._m_load_seconds = registry.histogram(
            "serving_model_load_seconds",
            "Bundle load (deserialize + warm) latency",
        )

    # ---- discovery -----------------------------------------------------

    def _candidates(self) -> List[str]:
        """Complete bundle dirs under root (root itself counts)."""
        if os.path.exists(os.path.join(self.root, META_FILE)):
            return [self.root]
        if not os.path.isdir(self.root):
            return []
        out = []
        for name in sorted(os.listdir(self.root)):
            path = os.path.join(self.root, name)
            if os.path.exists(os.path.join(path, META_FILE)):
                out.append(path)
        return out

    @staticmethod
    def _bundle_version(path: str) -> int:
        try:
            with open(os.path.join(path, META_FILE)) as f:
                return int(json.load(f).get("model_version", 0))
        except (OSError, ValueError):
            return -1

    def newest_available(self):
        """(version, path) of the newest complete bundle that is neither
        rolled back nor inside its failure backoff window."""
        best = None
        for path in self._candidates():
            version = self._bundle_version(path)
            if version < 0 or version in self._rejected:
                continue
            next_retry = self._load_failures.get(version, (0, 0.0, 0.0))[1]
            if time.monotonic() < next_retry:
                continue
            if best is None or version > best[0]:
                best = (version, path)
        return best

    # ---- load / swap / rollback ---------------------------------------

    def current(self) -> Optional[ServedModel]:
        return self._current

    def versions(self) -> List[int]:
        """Resident versions, current last."""
        with self._lock:
            out = [m.version for m in self._previous]
            if self._current is not None:
                out.append(self._current.version)
            return out

    def load_initial(self) -> ServedModel:
        """Blocking first load (the server refuses to start empty)."""
        found = self.newest_available()
        if found is None:
            raise FileNotFoundError(
                f"no complete serving bundle under {self.root}"
            )
        self._swap(self._load(found[1]))
        return self._current

    def _load(self, path: str) -> ServedModel:
        t0 = time.monotonic()
        model = load_served_model(
            path, device=self.device, model_fn=self._model_fn,
            row_service_addr=self._row_service_addr,
            row_cache=self.row_cache,
            metrics_registry=self._metrics_registry,
        )
        self._m_load_seconds.observe(time.monotonic() - t0)
        return model

    def _swap(self, model: ServedModel):
        with self._lock:
            if self._current is not None:
                self._previous.append(self._current)
                if self._retain:
                    del self._previous[:-self._retain]
                else:
                    self._previous.clear()
            self._current = model
        self._m_version.set(model.version)
        logger.info(
            "Serving model version %d from %s", model.version, model.path
        )

    def rollback(self) -> ServedModel:
        """Swap back to the most recent retained version; the dropped
        version is pinned out of future polls until a newer export
        appears."""
        with self._lock:
            if not self._previous:
                raise RuntimeError("no previous version retained")
            bad = self._current
            self._current = self._previous.pop()
            self._rejected.add(bad.version)
            current = self._current
        self._m_version.set(current.version)
        self._m_reloads.labels(result="rollback").inc()
        logger.warning(
            "Rolled back serving model %d -> %d",
            bad.version, current.version,
        )
        return current

    def poll_once(self) -> bool:
        """One discovery+reload cycle; True if a new version went live."""
        from elasticdl_tpu_torch.comm import overload
        from elasticdl_tpu_torch.comm.rpc import decorrelated_jitter

        found = self.newest_available()
        if found is None:
            return False
        version, path = found
        current = self._current
        if current is not None and version <= current.version:
            return False
        try:
            model = self._load(path)
        except Exception:
            failures, _, prev = self._load_failures.get(
                version, (0, 0.0, 0.0))
            failures += 1
            # Decorrelated jitter: replicas watching one bad bundle must
            # not re-load it in lockstep.
            backoff = decorrelated_jitter(prev, base=self._poll_seconds,
                                          cap=300.0)
            if (overload.controls_enabled()
                    and not overload.retry_budget_for(
                        "ModelStore:load").try_spend()):
                backoff = max(backoff, self._poll_seconds * 4)
            self._load_failures[version] = (
                failures, time.monotonic() + backoff, backoff
            )
            logger.exception(
                "Failed to load bundle %s (version %d, attempt %d); "
                "retrying in %.0fs", path, version, failures, backoff,
            )
            self._m_reloads.labels(result="error").inc()
            return False
        if version in self._load_failures and overload.controls_enabled():
            overload.retry_budget_for("ModelStore:load").on_success()
        self._load_failures.pop(version, None)
        self._swap(model)
        self._m_reloads.labels(result="ok").inc()
        return True

    def _poll_loop(self):
        while not self._stop.wait(self._poll_seconds):
            try:
                self.poll_once()
            except Exception:
                logger.exception("model store poll failed")

    def start_polling(self) -> "ModelStore":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._poll_loop, daemon=True,
                name="model-store-poll",
            )
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self.row_cache is not None:
            self.row_cache.stop()
