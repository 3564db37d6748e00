"""Checkpoint layout, GC, validity, delta chains, and repartitioning
(copy of elasticdl_tpu/checkpoint/saver.py: the same files, byte for
byte, for the same named arrays and rows).

Layout parity with the reference (``common/save_utils.py:101-118``,
``pkg/ps/checkpoint.go:122-127``), extended with incremental deltas:

    {dir}/version-{v}/variables-{i}-of-{N}.ckpt     # full base
    {dir}/delta-{v}/chain.json                      # {version, base, prev}
    {dir}/delta-{v}/rows-{i}-of-{N}.ckpt            # dirty rows only

Each shard file is a CRC32-framed msgpack blob
(``state_io.frame_shard_blob``) of

    {"meta": {"version": v, "shard": i, "num_shards": N, ...},
     "dense": {leaf_name: ndarray},           # by string_to_id(name) % N
     "embeddings": {table: IndexedSlices}}    # rows by id % N

A **full base** carries every dense leaf and every materialized row.
A **delta** carries every dense leaf (dense state has no sparsity to
exploit) but only the embedding rows dirtied since the previous
element; ``chain.json`` names its base and predecessor so restore can
replay ``base → delta → delta → …`` in order. A bounded chain length
(``delta_chain_max``) forces compaction into a fresh base.

Restore reads *all* shard files of each element, so loading onto a
different shard count (the reference's repartition restore,
save_utils.py:206-259) works across a whole chain. A dir is valid iff
the file count equals every file's recorded ``num_shards``
("slowest-PS-wins" validity, save_utils.py:154-167); a torn delta
truncates the chain to its longest intact prefix, extending the
corrupt-version fallback semantics to chains.
"""

import json
import os
import re
import shutil
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.common.hash_utils import string_to_id
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.checkpoint.state_io import (
    CorruptCheckpointError,
    frame_shard_blob,
    unframe_shard_blob,
    validate_shard_payload,
)
from elasticdl_tpu_torch.embedding.table import EmbeddingTable

logger = get_logger(__name__)

# ---- chaos seam (the JAX package's chaos/interceptors.py installs it
# there; the port keeps the seam for its own fault tests) ---------------
# _post_save_hook(checkpoint_dir, version, vdir): after a version dir is
#   published (fault plans corrupt files here); _post_restore_hook(
#   checkpoint_dir, version): after a successful restore (the version-
#   monotonicity invariant checker observes restores here);
# _fsync_hook("checkpoint"): ahead of each shard file's fsync inside
#   _publish_dir — a fault plan's ``fsync_stall`` sleeps here (slow
#   checkpoint disk stretches the save, never tears it: publish stays
#   behind the tmp-dir rename).
_post_save_hook: Optional[Callable] = None
_post_restore_hook: Optional[Callable] = None
_fsync_hook: Optional[Callable] = None


def set_chaos_hooks(post_save: Optional[Callable] = None,
                    post_restore: Optional[Callable] = None,
                    fsync: Optional[Callable] = None):
    global _post_save_hook, _post_restore_hook, _fsync_hook
    _post_save_hook = post_save
    _post_restore_hook = post_restore
    _fsync_hook = fsync

_VERSION_RE = re.compile(r"^version-(\d+)$")
_DELTA_RE = re.compile(r"^delta-(\d+)$")
_SHARD_RE = re.compile(r"^variables-(\d+)-of-(\d+)\.ckpt$")
_DELTA_SHARD_RE = re.compile(r"^rows-(\d+)-of-(\d+)\.ckpt$")
CHAIN_FILE = "chain.json"


def _version_dir(checkpoint_dir: str, version: int) -> str:
    return os.path.join(checkpoint_dir, f"version-{version}")


def _delta_dir(checkpoint_dir: str, version: int) -> str:
    return os.path.join(checkpoint_dir, f"delta-{version}")


def _table_arrays(embeddings) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Normalize {name: table-like | (ids, rows)} to plain arrays —
    the boundary between capture (caller's thread, under the caller's
    locks) and the write pipeline (possibly a background thread)."""
    out = {}
    for name, table in (embeddings or {}).items():
        if isinstance(table, tuple):
            ids, rows = table
        else:
            ids, rows = table.to_arrays()
        out[name] = (np.asarray(ids, np.int64), np.asarray(rows))
    return out


def _fsync_dir(path: str):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointSaver:
    """Save/restore named dense leaves + host embedding tables.

    ``delta_chain_max`` > 0 enables incremental saves via
    ``plan_next``/``save_delta``: up to that many deltas ride one base
    before a save compacts into a fresh full base. 0 keeps the classic
    full-snapshot-only behavior (and still *restores* chains written
    by other configurations)."""

    def __init__(
        self,
        checkpoint_dir: str,
        num_shards: int = 1,
        keep_max: int = 3,
        delta_chain_max: int = 0,
        io_workers: int = 0,
    ):
        if not checkpoint_dir:
            raise ValueError("checkpoint_dir must be non-empty")
        self.checkpoint_dir = checkpoint_dir
        self.num_shards = max(1, int(num_shards))
        self.keep_max = int(keep_max)
        self.delta_chain_max = max(0, int(delta_chain_max))
        # Per-shard parallel serialize+write: shard files of one
        # version are independent, so slow storage amortizes across
        # them. 0 = auto.
        self._io_workers = int(io_workers) or min(4, self.num_shards)
        self._io_pool = None
        # Caller-supplied meta of the newest element the last restore
        # applied (tip wins along a chain): how the row service's
        # shard map rides the checkpoint (row_service._restore_latest).
        self.last_restored_meta: dict = {}
        os.makedirs(checkpoint_dir, exist_ok=True)

    # ---- write pipeline ------------------------------------------------

    def _pool(self):
        if self._io_pool is None and self._io_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._io_pool = ThreadPoolExecutor(
                max_workers=self._io_workers,
                thread_name_prefix="ckpt-shard",
            )
        return self._io_pool

    def _build_payloads(self, version: int, dense: Dict[str, np.ndarray],
                        table_arrays, file_prefix: str,
                        extra_meta: Optional[dict] = None) -> Dict[str, dict]:
        n = self.num_shards
        # Per-shard masks are vectorized (int_to_id is id % n for
        # non-negative row ids).
        shard_of = {
            tname: ids % n for tname, (ids, _rows) in table_arrays.items()
        }
        payloads = {}
        for shard in range(n):
            # Caller meta first: the structural keys (version/shard/
            # num_shards) are load-bearing for restore and must win.
            meta = dict(extra_meta or {})
            meta.update({
                "version": int(version),
                "shard": shard,
                "num_shards": n,
            })
            payload = {
                "meta": meta,
                "dense": {
                    name: np.asarray(arr)
                    for name, arr in dense.items()
                    if string_to_id(name, n) == shard
                },
                "embeddings": {},
            }
            for tname, (ids, rows) in table_arrays.items():
                keep = shard_of[tname] == shard
                payload["embeddings"][tname] = tensor_utils.IndexedSlices(
                    values=rows[keep], ids=ids[keep]
                )
            payloads[f"{file_prefix}-{shard}-of-{n}.ckpt"] = payload
        return payloads

    def _publish_dir(self, final_dir: str, payloads: Dict[str, dict],
                     chain_info: Optional[dict] = None) -> int:
        """Serialize + write + fsync every shard file into a tmp dir
        (shards in parallel), then rename into place and fsync the
        parent: **no version is published until fully durable**, so a
        crash at any point leaves either the previous state or a
        ``.tmp`` dir the validity scan never sees."""
        tmp = final_dir + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        def write_one(item) -> int:
            fname, payload = item
            blob = frame_shard_blob(tensor_utils.dumps(payload))
            path = os.path.join(tmp, fname)
            with open(path, "wb") as f:
                f.write(blob)
                f.flush()
                hook = _fsync_hook
                if hook is not None:
                    hook("checkpoint")
                os.fsync(f.fileno())
            return len(blob)

        pool = self._pool()
        items = sorted(payloads.items())
        if pool is not None and len(items) > 1:
            bytes_written = sum(pool.map(write_one, items))
        else:
            bytes_written = sum(write_one(item) for item in items)
        if chain_info is not None:
            chain_path = os.path.join(tmp, CHAIN_FILE)
            with open(chain_path, "w") as f:
                json.dump(chain_info, f)
                f.flush()
                os.fsync(f.fileno())
            bytes_written += os.path.getsize(chain_path)
        # The tmp dir's own entries must be durable BEFORE the rename:
        # fsyncing only the files and the parent leaves a window where
        # the published dir survives a power loss with entries missing.
        _fsync_dir(tmp)
        if os.path.exists(final_dir):
            shutil.rmtree(final_dir)
        os.rename(tmp, final_dir)
        _fsync_dir(os.path.dirname(final_dir) or ".")
        return bytes_written

    def _record_save(self, version: int, vdir: str, kind: str,
                     bytes_written: int, t0: float):
        from elasticdl_tpu_torch.observability import default_registry

        registry = default_registry()
        registry.histogram(
            "checkpoint_save_seconds", "Checkpoint save duration",
        ).observe(time.monotonic() - t0)
        registry.counter(
            "checkpoint_saved_bytes_total", "Checkpoint payload bytes",
        ).inc(bytes_written)
        registry.counter(
            "checkpoint_bytes_written_total",
            "Checkpoint bytes written per element kind",
            ["kind"],
        ).labels(kind).inc(bytes_written)
        registry.counter(
            "checkpoint_saves_total", "Checkpoint versions written",
        ).inc()
        chains = self.chains()
        registry.gauge(
            "checkpoint_delta_chain_length",
            "Deltas riding the newest checkpoint base",
        ).set(float(len(chains[-1]["deltas"]) if chains else 0))
        if _post_save_hook is not None:
            _post_save_hook(self.checkpoint_dir, int(version), vdir)
        self.gc(chains=chains)

    # ---- save ----------------------------------------------------------

    def save(
        self,
        version: int,
        dense: Dict[str, np.ndarray],
        embeddings=None,
        meta: Optional[dict] = None,
    ) -> str:
        """Write all shards of one FULL version, then GC old chains.
        ``embeddings`` maps table name to a table-like (``to_arrays``)
        or a pre-captured ``(ids, rows)`` tuple. ``meta`` rides every
        shard file's meta dict and surfaces on restore via
        ``last_restored_meta`` (reserved keys version/shard/num_shards
        win)."""
        t0 = time.monotonic()
        vdir = _version_dir(self.checkpoint_dir, version)
        payloads = self._build_payloads(
            version, dense, _table_arrays(embeddings), "variables",
            extra_meta=meta,
        )
        bytes_written = self._publish_dir(vdir, payloads)
        logger.info(
            "Saved checkpoint version %s (%s shards)",
            version, self.num_shards,
        )
        self._record_save(version, vdir, "full", bytes_written, t0)
        return vdir

    def save_delta(
        self,
        version: int,
        dense: Dict[str, np.ndarray],
        embeddings,
        base_version: int,
        prev_version: int,
        meta: Optional[dict] = None,
    ) -> str:
        """Write one DELTA element against ``base_version`` whose
        predecessor in the chain is ``prev_version`` (the base itself
        for the first delta). ``embeddings`` carries only the dirty
        rows; dense leaves ride in full (dense state has no sparsity
        to exploit — every leaf changes every step). ``meta`` as in
        ``save`` (chain keys win)."""
        t0 = time.monotonic()
        chain_info = {
            "version": int(version),
            "base": int(base_version),
            "prev": int(prev_version),
            "num_shards": self.num_shards,
        }
        vdir = _delta_dir(self.checkpoint_dir, version)
        extra = dict(meta or {})
        extra.update({"base": int(base_version),
                      "prev": int(prev_version)})
        payloads = self._build_payloads(
            version, dense, _table_arrays(embeddings), "rows",
            extra_meta=extra,
        )
        bytes_written = self._publish_dir(vdir, payloads, chain_info)
        logger.info(
            "Saved delta checkpoint %s (base %s, prev %s)",
            version, base_version, prev_version,
        )
        self._record_save(version, vdir, "delta", bytes_written, t0)
        return vdir

    def plan_next(self) -> Tuple[str, Optional[int], Optional[int]]:
        """What the next save should write, from ON-DISK state:
        ``("full", None, None)`` or ``("delta", base, prev)``. Deltas
        require ``delta_chain_max`` > 0, an existing restorable chain,
        and headroom under the bound — a full chain compacts into a
        fresh base. Async callers must plan through a ``ChainPlanner``
        instead: disk lags the write queue, and planning from it can
        fork the chain."""
        if self.delta_chain_max <= 0:
            return ("full", None, None)
        chains = self.chains()
        if not chains:
            return ("full", None, None)
        tip_chain = chains[-1]
        if len(tip_chain["deltas"]) >= self.delta_chain_max:
            return ("full", None, None)
        return ("delta", tip_chain["base"], tip_chain["tip"])

    # ---- enumerate / validate -----------------------------------------

    def _scan(self, pattern) -> List[int]:
        out = []
        if not os.path.isdir(self.checkpoint_dir):
            return out
        for entry in os.listdir(self.checkpoint_dir):
            m = pattern.match(entry)
            if m and os.path.isdir(
                os.path.join(self.checkpoint_dir, entry)
            ):
                out.append(int(m.group(1)))
        return sorted(out)

    def list_versions(self):
        """Full-base versions only (the classic listing)."""
        return self._scan(_VERSION_RE)

    def list_deltas(self):
        return self._scan(_DELTA_RE)

    @staticmethod
    def _dir_valid(vdir: str, shard_re) -> bool:
        if not os.path.isdir(vdir):
            return False
        shards = [f for f in os.listdir(vdir) if shard_re.match(f)]
        if not shards:
            return False
        counts = {int(shard_re.match(f).group(2)) for f in shards}
        return len(counts) == 1 and counts.pop() == len(shards)

    def is_valid_version(self, version: int) -> bool:
        """Valid iff shard file count matches the recorded num_shards
        (save_utils.py:154-167)."""
        return self._dir_valid(
            _version_dir(self.checkpoint_dir, version), _SHARD_RE
        )

    def is_valid_delta(self, version: int) -> bool:
        return self._dir_valid(
            _delta_dir(self.checkpoint_dir, version), _DELTA_SHARD_RE
        )

    def element_exists(self, version: int) -> bool:
        """A durable element (base or delta) for ``version`` is on
        disk. Async delta writers check their PREDECESSOR with this
        before writing: the writer is FIFO, so by the time a delta
        executes, its planned prev either landed or failed — and a
        delta written over a failed prev would be unrestorable while
        its drained dirty rows report durable."""
        return self.is_valid_version(version) or self.is_valid_delta(
            version
        )

    def delta_chain_info(self, version: int) -> Optional[dict]:
        """The delta's ``chain.json`` ({version, base, prev,
        num_shards}); None when unreadable/inconsistent."""
        path = os.path.join(
            _delta_dir(self.checkpoint_dir, version), CHAIN_FILE
        )
        try:
            with open(path) as f:
                info = json.load(f)
        except (OSError, ValueError):
            return None
        try:
            if int(info["version"]) != int(version):
                return None
            int(info["base"]), int(info["prev"])
        except (KeyError, TypeError, ValueError):
            return None
        return info

    def chains(self) -> List[dict]:
        """Restorable units, sorted by LINEAGE (base version)
        ascending: ``[{"base": b, "deltas": [d1, ...], "tip":
        newest}]``. A chain's deltas are the longest prefix whose
        ``prev`` links resolve (base → d1 → d2 → …) through valid
        delta dirs — exactly what restore can replay.

        Base order, not tip order: on a healthy disk they agree
        (versions are monotonic and deltas only ride the newest base),
        they disagree only when an older base's chain extends PAST a
        newer base — which can only be a dead pre-crash timeline (a
        restarted writer truncated its restore and opened a fresh
        base; the service then re-ran those versions with new data).
        Ranking that stale chain's numerically-newer tip above the
        fresh base would make restore() return pre-crash rows and
        gc() reclaim the good base under ``keep_max``."""
        bases = [
            v for v in self.list_versions() if self.is_valid_version(v)
        ]
        by_base: Dict[int, List[dict]] = {}
        for d in self.list_deltas():
            if not self.is_valid_delta(d):
                continue
            info = self.delta_chain_info(d)
            if info is None:
                continue
            by_base.setdefault(int(info["base"]), []).append(info)
        out = []
        for base in bases:
            deltas = []
            prev = base
            for info in sorted(
                by_base.get(base, []), key=lambda i: int(i["version"])
            ):
                v = int(info["version"])
                if v <= prev or int(info["prev"]) != prev:
                    break  # gap or fork: chain ends at the last link
                deltas.append(v)
                prev = v
            out.append({
                "base": base,
                "deltas": deltas,
                "tip": deltas[-1] if deltas else base,
            })
        out.sort(key=lambda c: c["base"])
        return out

    def get_valid_latest_version(self) -> Optional[int]:
        """Newest restorable version — the tip of the newest chain
        (== the newest valid base when no deltas exist)."""
        chains = self.chains()
        return chains[-1]["tip"] if chains else None

    # ---- restore -------------------------------------------------------

    def restore(
        self, version: Optional[int] = None
    ) -> Tuple[int, Dict[str, np.ndarray], Dict[str, EmbeddingTable]]:
        """Restore the newest readable state, replaying ``base +
        deltas`` in order — shard-count agnostic per element
        (repartition restore, save_utils.py:206-259), so an N-shard
        base plus M-shard deltas merge fine.

        With no explicit ``version``: a corrupt BASE skips the whole
        chain (older chains restore instead); a corrupt/torn DELTA
        truncates to the longest intact prefix — a replacement worker
        must resume from the freshest *readable* state, not crash-loop
        on a torn file. An explicit ``version`` raises
        ``CorruptCheckpointError`` — the caller asked for that one."""
        if version is not None:
            return self._restore_exact(version)
        chains = self.chains()
        if not chains:
            raise FileNotFoundError(
                f"No valid checkpoint under {self.checkpoint_dir}"
            )
        from elasticdl_tpu_torch.observability import default_registry

        for i, chain in enumerate(reversed(chains)):
            try:
                return self._restore_chain(
                    chain["base"], chain["deltas"], allow_prefix=True
                )
            except CorruptCheckpointError as exc:
                default_registry().counter(
                    "checkpoint_corrupt_versions_total",
                    "Checkpoint versions skipped at restore because a "
                    "shard file failed to decode",
                ).inc()
                older = len(chains) - i - 1
                logger.error(
                    "Checkpoint base %d is corrupt (%s); falling "
                    "back to %s older chain(s)",
                    chain["base"], exc, older,
                )
        raise FileNotFoundError(
            f"Every retained checkpoint chain under "
            f"{self.checkpoint_dir} is corrupt "
            f"(tried bases {[c['base'] for c in chains]})"
        )

    def _restore_exact(self, version: int):
        if self.is_valid_version(version):
            return self._restore_chain(version, [], allow_prefix=False)
        for chain in self.chains():
            if version in chain["deltas"]:
                idx = chain["deltas"].index(version)
                return self._restore_chain(
                    chain["base"], chain["deltas"][: idx + 1],
                    allow_prefix=False,
                )
        raise FileNotFoundError(
            f"Invalid checkpoint version "
            f"{_version_dir(self.checkpoint_dir, version)}"
        )

    def _restore_chain(self, base: int, deltas: List[int],
                       allow_prefix: bool):
        from elasticdl_tpu_torch.observability import default_registry

        dense: Dict[str, np.ndarray] = {}
        embeddings: Dict[str, EmbeddingTable] = {}
        self.last_restored_meta = {}
        # The base raises on corruption (nothing to fall back on within
        # this chain); the caller skips to an older chain.
        self._load_dir(
            _version_dir(self.checkpoint_dir, base), _SHARD_RE,
            dense, embeddings,
        )
        version = int(base)
        for d in deltas:
            try:
                self._load_dir(
                    _delta_dir(self.checkpoint_dir, d),
                    _DELTA_SHARD_RE, dense, embeddings,
                )
            except CorruptCheckpointError as exc:
                if not allow_prefix:
                    raise
                default_registry().counter(
                    "checkpoint_corrupt_versions_total",
                    "Checkpoint versions skipped at restore because a "
                    "shard file failed to decode",
                ).inc()
                logger.error(
                    "Delta %d is torn (%s); restoring the intact "
                    "chain prefix at version %d", d, exc, version,
                )
                break
            version = int(d)
        if _post_restore_hook is not None:
            _post_restore_hook(self.checkpoint_dir, version)
        return version, dense, embeddings

    def _load_dir(self, vdir: str, shard_re,
                  dense: Dict[str, np.ndarray],
                  embeddings: Dict[str, EmbeddingTable]):
        """Merge every shard file of one element into the accumulators
        (delta rows OVERRIDE earlier chain elements' rows; dense
        leaves replace wholesale)."""
        if not self._dir_valid(vdir, shard_re):
            raise FileNotFoundError(f"Invalid checkpoint element {vdir}")
        for fname in sorted(os.listdir(vdir)):
            if not shard_re.match(fname):
                continue
            path = os.path.join(vdir, fname)
            try:
                with open(path, "rb") as f:
                    payload = tensor_utils.loads(
                        unframe_shard_blob(f.read(), path)
                    )
            except CorruptCheckpointError:
                raise
            except Exception as exc:
                # msgpack raises assorted types on truncated/garbled
                # bytes; all mean the same thing here.
                raise CorruptCheckpointError(
                    f"cannot decode {path}: "
                    f"{type(exc).__name__}: {exc}"
                ) from exc
            validate_shard_payload(payload, path)
            # Tip-wins along a chain: each loaded element overwrites,
            # so after a chain restore this holds the newest element's
            # caller meta (e.g. the row service's shard map).
            self.last_restored_meta = dict(payload.get("meta") or {})
            dense.update(payload.get("dense", {}))
            for tname, slices in payload.get("embeddings", {}).items():
                # An empty (0, D) slice still carries the row dim; a shard
                # that happens to own zero rows of a table must not pin the
                # table to dim 0 (all its rows may live in later shards).
                dim = (
                    slices.values.shape[1]
                    if slices.values.ndim == 2 else 0
                )
                table = embeddings.get(tname)
                if table is not None and (
                    table.num_rows == 0 and slices.ids.size
                    and slices.values.dtype != table.dtype
                ):
                    # A row-less placeholder from an earlier empty shard
                    # must not pin the dtype either.
                    table = None
                if table is None or (table.dim == 0 and dim):
                    # Preserve the saved dtype: step counters serialize
                    # as float64 rows (exact ints past 2^24) and must
                    # not round through a float32 default on restore.
                    dtype = (
                        slices.values.dtype
                        if slices.ids.size else np.float32
                    )
                    fresh = EmbeddingTable(tname, dim, dtype=dtype)
                    if table is not None and table.num_rows:
                        prev_ids, prev_rows = table.to_arrays()
                        fresh.set(prev_ids, prev_rows)
                    table = fresh
                    embeddings[tname] = table
                if slices.ids.size:
                    table.set(slices.ids, slices.values)

    # ---- GC ------------------------------------------------------------

    def gc(self, chains: Optional[List[dict]] = None):
        """Keep the newest ``keep_max`` restorable CHAINS — a base and
        the deltas riding it live and die together, so ``keep_max``
        can never delete a base whose deltas are still the newest
        restorable state (save_utils.py:188-204, extended). Orphaned
        deltas (base gone / linkage broken) are unrestorable garbage
        and are reclaimed too. ``chains`` lets a caller that just
        computed them (the per-save path) skip a second dir scan."""
        if self.keep_max <= 0:
            return
        if chains is None:
            chains = self.chains()
        kept = chains[-self.keep_max:]
        keep_dirs = set()
        for chain in kept:
            keep_dirs.add(_version_dir(self.checkpoint_dir,
                                       chain["base"]))
            for d in chain["deltas"]:
                keep_dirs.add(_delta_dir(self.checkpoint_dir, d))
        for entry in os.listdir(self.checkpoint_dir):
            path = os.path.join(self.checkpoint_dir, entry)
            if entry.endswith(".tmp") and (
                _VERSION_RE.match(entry[:-4])
                or _DELTA_RE.match(entry[:-4])
            ):
                # Stale partial publish: saves to one dir are
                # serialized through one writer and gc runs on that
                # same thread after each publish, so any tmp still
                # present lost its rename (crash/ENOSPC) — and
                # versions are monotonic, so it never gets one.
                if os.path.isdir(path):
                    shutil.rmtree(path, ignore_errors=True)
                continue
            if not (_VERSION_RE.match(entry) or _DELTA_RE.match(entry)):
                continue
            if os.path.isdir(path) and path not in keep_dirs:
                shutil.rmtree(path, ignore_errors=True)


def capture_tables(tables, delta: bool):
    """Capture ``{name: (ids, rows)}`` for one save from table-like
    views (the caller's views self-lock). A ``delta`` capture DRAINS
    each tracked view's dirty set and returns the drained ids so a
    failed write can ``remark_dirty`` them; untracked views (seq
    maps, step counters — tiny by construction) ride every delta in
    full. A full capture also drains tracked views (discarding the
    ids): the base holds everything, and undrained dirt would make
    the first delta after it re-ship the whole table."""
    captured, dirty_ids = {}, {}
    for name, view in tables.items():
        tracked = getattr(view, "supports_dirty_rows", False)
        if delta and tracked:
            ids, rows = view.dirty_arrays()
            dirty_ids[name] = ids
        elif tracked and hasattr(view, "capture_arrays"):
            # Self-locking views (the hook's _LockedTable): snapshot
            # + dirty-drain must be ONE lock acquisition — a row
            # mutated between separate to_arrays()/clear_dirty()
            # calls would lose its dirty mark without riding the
            # snapshot, and never ride any later delta either.
            ids, rows = view.capture_arrays()
        else:
            ids, rows = view.to_arrays()
            if tracked:
                view.clear_dirty()
        captured[name] = (ids, rows)
    return captured, dirty_ids


def remark_dirty(tables, dirty_ids):
    """Put drained dirty ids back after a failed/refused write — or
    they silently vanish from every future delta."""
    for name, ids in dirty_ids.items():
        view = tables.get(name)
        if view is not None and len(ids):
            view.mark_dirty(ids)


class ChainPlanner:
    """In-memory delta-chain planner for (possibly async) savers.

    ``CheckpointSaver.plan_next`` reads the DISK, which lags a bounded
    write queue: planning save N+1 from disk while save N is still
    queued forks the chain — two deltas naming the same ``prev``, and
    the chain walk drops everything past the fork, silently losing the
    second delta's rows from every restore. The planner instead tracks
    the chain the queued writes will produce, updated optimistically
    at capture time (writes land FIFO, so disk converges).

    Starts conservative (``None`` → next save is a full base): a fresh
    process cannot know whether queued writes from a predecessor
    landed, and one compaction per restart is cheap hygiene. A write
    FAILURE calls ``reset()`` so the next save compacts into a fresh
    base, healing any queued deltas that linked through the failure.
    """

    def __init__(self, delta_chain_max: int):
        self._max = max(0, int(delta_chain_max))
        self._chain: Optional[dict] = None

    def plan(self, version: int) -> Tuple[str, Optional[int],
                                          Optional[int]]:
        """Decide full-vs-delta for ``version`` and advance the
        tracked chain as if the write will succeed."""
        version = int(version)
        chain = self._chain
        if (
            self._max <= 0
            or chain is None
            or chain["len"] >= self._max
            or version <= chain["tip"]
        ):
            self._chain = {"base": version, "len": 0, "tip": version}
            return ("full", None, None)
        base, prev = chain["base"], chain["tip"]
        chain["len"] += 1
        chain["tip"] = version
        return ("delta", base, prev)

    def reset(self):
        self._chain = None
