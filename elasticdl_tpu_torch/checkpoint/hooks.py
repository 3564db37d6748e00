"""Shared checkpoint wiring for executors and workers (port of
elasticdl_tpu/checkpoint/hooks.py).

One implementation of "restore at init / save every N versions / final
save" (reference spreads this across ps/parameter_server.py:49-66 and
ps/servicer.py:242-257). Two backends, as in the JAX package: the
native shard files (``saver.py``) and, for a job whose model spans
processes, ``backend="orbax"`` (``orbax_backend.py``: the JAX names,
``torch.distributed.checkpoint`` files in ``orbax-<version>``
directories). A restore picks the backend from the directory.
"""

import os
import re
import time

from elasticdl_tpu_torch.bridge import is_jax_named, port_leaves_from_jax
from elasticdl_tpu_torch.checkpoint.saver import (
    ChainPlanner,
    CheckpointSaver,
    capture_tables,
    remark_dirty,
)
from elasticdl_tpu_torch.checkpoint.state_io import (
    CorruptCheckpointError,
    named_leaves_from_state,
    restore_state_from_named_leaves,
)
from elasticdl_tpu_torch.checkpoint.writer import CheckpointWriter
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.observability import default_registry

logger = get_logger(__name__)

def _has_orbax_versions(checkpoint_dir: str) -> bool:
    # Finalized versions only — orbax's in-progress
    # *.orbax-checkpoint-tmp-* dirs must not route restore here.
    pattern = re.compile(r"^orbax-\d+$")
    try:
        return any(
            pattern.match(name) for name in os.listdir(checkpoint_dir)
        )
    except OSError:
        return False


def has_valid_checkpoint(checkpoint_dir: str) -> bool:
    """Either backend has a restorable version here (the elastic-relaunch
    resume decision, worker/main.py)."""
    if not checkpoint_dir:
        return False
    if _has_orbax_versions(checkpoint_dir):
        return True
    try:
        return (
            CheckpointSaver(checkpoint_dir).get_valid_latest_version()
            is not None
        )
    except OSError:
        return False


def restore_from_dir(state, checkpoint_dir: str, required: bool = True,
                     host_tables=None):
    """Restore a train state's leaves, in place, from the latest valid
    version, and return it. The backend is read off the directory:
    ``orbax-<version>`` directories (multi-host jobs write those) restore
    onto the state's own layout, each process reading the regions it
    holds (``orbax_backend.restore_state``), collectively where the
    state spans processes; otherwise the native shard files (base plus
    deltas).

    ``required=False`` is the elastic-relaunch path: a replacement worker
    is pointed at the job's checkpoint dir, which legitimately has no
    valid version yet if the job died before the first checkpoint — start
    fresh instead of crash-looping the replacement pod.

    ``host_tables`` ({name: EmbeddingTable-like}): host-tier tables to
    refill from the checkpoint's embedding rows. The seconds the restore
    took (read, decode and copy into the state) go to the registry's
    ``checkpoint_restore_seconds`` (a family of the port's own).
    """
    t0 = time.monotonic()
    if _has_orbax_versions(checkpoint_dir):
        return _restore_orbax(state, checkpoint_dir, required, host_tables,
                              t0)
    try:
        _, dense, embeddings = CheckpointSaver(checkpoint_dir).restore()
    except FileNotFoundError:
        if required:
            raise
        logger.warning(
            "No valid checkpoint under %s; starting fresh", checkpoint_dir
        )
        return state
    if is_jax_named(dense):
        # A directory the JAX package wrote: the same files, its leaf
        # names; the strict check below runs on the mapped names.
        dense = port_leaves_from_jax(state, dense)
        logger.info("Read %s as a JAX-written checkpoint", checkpoint_dir)
    state = restore_state_from_named_leaves(state, dense)
    missing = [n for n in (host_tables or {}) if n not in embeddings]
    if missing:
        # Loud: continuing would silently lazy-reinit every trained row
        # and optimizer slot.
        raise ValueError(
            f"checkpoint at {checkpoint_dir} (version {int(state.step)}) "
            f"carries no host-table payload for {sorted(missing)}; "
            "was it written without host_tables, or with a different "
            "row optimizer?"
        )
    for name, table in (host_tables or {}).items():
        ids, rows = embeddings[name].to_arrays()
        if ids.size:
            table.set(ids, rows)
        if getattr(table, "supports_dirty_rows", False):
            # The refill marked every restored row dirty; the on-disk
            # state it came from already holds them, so the next delta
            # must not re-ship the whole table.
            table.clear_dirty()
    default_registry().histogram(
        "checkpoint_restore_seconds",
        "Checkpoint restore duration (read, decode, copy into the state)",
    ).observe(time.monotonic() - t0)
    logger.info(
        "Restored state at version %d from %s",
        int(state.step), checkpoint_dir,
    )
    return state


def _restore_orbax(state, checkpoint_dir, required, host_tables, t0):
    if host_tables:
        # Symmetric with CheckpointHook: these checkpoints carry no host
        # rows; continuing would lazy-reinit every trained row.
        raise ValueError(
            "host_tables restore requires a native-backend "
            f"checkpoint; {checkpoint_dir} is orbax-backed"
        )
    from elasticdl_tpu_torch.checkpoint.orbax_backend import (
        OrbaxSaver,
        restore_state,
    )

    saver = OrbaxSaver(checkpoint_dir, collective=getattr(
        state, "global_batch", None) is not None)
    try:
        state = restore_state(saver, state)
    except FileNotFoundError:
        if required:
            raise
        logger.warning(
            "No valid orbax checkpoint under %s; starting fresh",
            checkpoint_dir,
        )
        return state
    default_registry().histogram(
        "checkpoint_restore_seconds",
        "Checkpoint restore duration (read, decode, copy into the state)",
    ).observe(time.monotonic() - t0)
    logger.info(
        "Restored state at version %d from %s (orbax)",
        int(state.step), checkpoint_dir,
    )
    return state


class CheckpointHook:
    """Periodic + final checkpoint writer. ``maybe_save`` is a no-op when
    no dir or no interval is configured; ``save_final`` always writes the
    current version when a dir is configured (so the last steps of a run
    are never lost to interval rounding)."""

    def __init__(
        self,
        checkpoint_dir: str = "",
        checkpoint_steps: int = 0,
        num_shards: int = 1,
        keep_max: int = 3,
        async_save: bool = True,
        backend: str = "native",
        host_tables=None,
        delta_chain_max: int = 0,
    ):
        if backend not in ("native", "orbax"):
            raise ValueError(f"unknown checkpoint backend {backend!r}")
        # host_tables ({name: EmbeddingTable-like}): host-tier rows are
        # saved alongside the state (native backend; the saver shards
        # rows by id % N like the reference Go checkpoint).
        if host_tables and backend == "orbax":
            raise ValueError(
                "host_tables checkpointing requires the native backend"
            )
        self._host_tables = host_tables or {}
        for view in self._host_tables.values():
            # Turn dirty tracking on now that a consumer drains it
            # (tables default OFF so jobs without checkpointing never
            # pay for the marked-ids set).
            enable = getattr(view, "enable_dirty_tracking", None)
            if enable is not None:
                enable()
        # "orbax": a job whose model spans processes (no process holds
        # every leaf): every process writes its parts and restores onto
        # any layout. The backend runs its own background writer.
        self._orbax = None
        if backend == "orbax" and checkpoint_dir:
            from elasticdl_tpu_torch.checkpoint.orbax_backend import (
                OrbaxSaver,
            )

            self._orbax = OrbaxSaver(checkpoint_dir, keep_max=keep_max,
                                     async_save=async_save)
        self.saver = self._orbax or (
            CheckpointSaver(checkpoint_dir, num_shards=num_shards,
                            keep_max=keep_max,
                            delta_chain_max=delta_chain_max)
            if checkpoint_dir else None
        )
        self.checkpoint_steps = int(checkpoint_steps)
        self._last_saved = None
        # The newest version handed to the writer. The interval and
        # save_final count from it: _last_saved is set only when a write
        # lands, so reading it alone (as the JAX hook does) saves again
        # while an async write is still queued: a spurious interval save
        # a version later, and the final version written twice.
        self._last_submitted = None
        # Capture/write split: the device->host copy + host-table
        # capture stay on the caller's thread (they must observe a
        # consistent state), but serialization, checksumming, and disk
        # IO move to the bounded background CheckpointWriter — the
        # training step doesn't wait on storage, and a slow disk
        # backpressures (bounded queue) instead of piling up full host
        # model copies. A crash mid-write leaves a torn ``.tmp`` dir
        # the saver's validity scan never sees.
        self._writer = CheckpointWriter(max_pending=1,
                                        sync=not async_save)
        # In-memory chain planning: disk lags the write queue, so
        # planning from it could fork the chain (see ChainPlanner).
        self._planner = ChainPlanner(delta_chain_max)
        self._m_stall = default_registry().histogram(
            "checkpoint_stall_seconds",
            "Step/push-path time spent capturing + enqueuing a "
            "checkpoint (the part the hot path actually waits on)",
            exemplars=True,
        )

    def flush(self):
        """Wait for in-flight async writes; raise a deferred failure
        (unless a newer write has since succeeded and superseded it)."""
        if self._orbax is not None:
            self._orbax.wait()
        self._writer.flush()

    def note_version(self, version: int):
        """Seed the save baseline after a checkpoint restore, so the
        interval-crossing rule doesn't count pre-restore steps and write
        a spurious (non-multiple) checkpoint on the first step."""
        if self._last_saved is None:
            self._last_saved = int(version)

    def maybe_save(self, state) -> bool:
        """Reads ``state.step`` (a host int) and nothing else unless the
        interval is due: the step path never syncs on the card here."""
        if (
            self.saver is None
            or not self.checkpoint_steps
            or state is None
        ):
            return False
        version = int(state.step)
        if version == 0 or version in (self._last_saved,
                                       self._last_submitted):
            return False
        # Save on exact multiples (per-step callers) or whenever the
        # interval was crossed since the last save — fused task execution
        # advances the version several steps per call and may never land
        # exactly on a multiple.
        last = (self._last_submitted if self._last_submitted is not None
                else self._last_saved)
        crossed = version - (last or 0) >= self.checkpoint_steps
        if version % self.checkpoint_steps != 0 and not crossed:
            return False
        self._save(version, state)
        return True

    def save_final(self, state) -> bool:
        if self.saver is None or state is None:
            # Even with nothing new to write, surface deferred failures.
            self.flush()
            return False
        version = int(state.step)
        if version in (self._last_saved, self._last_submitted):
            self.flush()
            return False
        self._save(version, state)
        self.flush()
        return True

    def _save(self, version: int, state):
        # CAPTURE on the caller's thread (a consistent snapshot before
        # the next step updates tensors in place and before further row
        # applies): copy every leaf to the host (synchronous), capture
        # host tables (dirty rows only when a delta is planned), then
        # hand serialization + IO to the background writer. The time
        # spent HERE is the whole step-path checkpoint cost —
        # checkpoint_stall_seconds measures it.
        t0 = time.monotonic()
        if self._orbax is not None:
            from elasticdl_tpu_torch.checkpoint.orbax_backend import (
                save_state,
            )

            save_state(self._orbax, state)
            self._last_submitted = self._last_saved = version
            self._m_stall.observe(time.monotonic() - t0)
            return
        # Incremental plan: only when host tables exist (a dense-only
        # delta saves nothing — the dense leaves ARE the payload and
        # ride in full either way).
        plan, base, prev = ("full", None, None)
        if self._host_tables:
            plan, base, prev = self._planner.plan(version)
        embeddings, dirty_ids = capture_tables(
            self._host_tables, delta=plan == "delta"
        )
        leaves = named_leaves_from_state(state)

        def write():
            try:
                if plan == "delta":
                    if not self.saver.element_exists(prev):
                        # The predecessor this delta was planned
                        # against failed ahead of us in the FIFO
                        # queue: writing would produce an
                        # unrestorable element whose success would
                        # also mask the predecessor's deferred error.
                        raise CorruptCheckpointError(
                            f"delta {version}: predecessor {prev} "
                            "never became durable; restarting chain"
                        )
                    self.saver.save_delta(
                        version, leaves, embeddings, base, prev
                    )
                else:
                    self.saver.save(version, leaves, embeddings=embeddings)
            except BaseException:
                # Drained dirty rows must re-enter the NEXT delta, and
                # the chain restarts from a fresh base (queued deltas
                # linking through the failure are unrestorable).
                remark_dirty(self._host_tables, dirty_ids)
                self._planner.reset()
                raise
            self._last_saved = version

        self._writer.submit(write, label=f"v{version}-{plan}")
        self._last_submitted = version
        self._m_stall.observe(time.monotonic() - t0)
