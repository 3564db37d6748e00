"""Host-tier embedding training: tables larger than the card's memory
(port of elasticdl_tpu/embedding/host_engine.py).

The reference trains huge tables by keeping rows on parameter-server
pods and shipping row batches over gRPC. Here the same deployment runs
in one process:

- the table lives in host RAM (``EmbeddingTable``, or the C++
  ``NativeEmbeddingTable`` through ``native.row_store.make_host_table``);
- per batch, ids are deduplicated on the host (``np.unique``) and their
  rows pulled into a (bucket, D) block whose leading dim is padded to
  the next power of two (``bucket_size``), so a batch's shapes come
  from a small set;
- the model reads those rows through ``HostEmbedding``, from the
  ``host_rows={table: (bucket, D)}`` keyword of its forward, and
  indexes them with the batch's inverse map;
- the step differentiates w.r.t. the row block (a leaf that requires a
  gradient); the engine applies the row gradients back through a row
  optimizer (``HostOptimizerWrapper`` or the native one). Padded rows'
  gradients are dropped.

``HostStepRunner`` is the step runner the Local executor drives for a
zoo module with ``make_host_runner``. Under its default async apply,
the row gradients leave the card on a side stream that waits only on
an event recorded after the step, into pinned memory, and a single
applier thread applies them in order; reads that must see every apply
(eval, ``host_tables``, ``init_state``) flush first. A pull may then
read a shared id one apply behind (the reference's asynchronous
parameter-server window); ``async_apply=False`` applies inside the step
and is exact.

The remote engine is ``embedding/row_service.make_remote_engine``: its
tables pull rows from a shared row service over RPC and its optimizer
pushes the row gradients back. Both declare ``concurrent_safe``, so
pulls and pushes skip the engine lock and a multi-table batch fans its
tables out on a pool; ``HostStepRunner.host_tables`` is None on it,
because the service checkpoints its own rows.

The JAX engine's telemetry (its lookup, pull, pad and update histograms
and its dedup spans) is not ported yet (ROADMAP Queue 1, item 8): a
``metrics_registry`` raises.
"""

import queue
import threading
import weakref
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.core.step import _call_loss
from elasticdl_tpu_torch.core.train_state import init_train_state
from elasticdl_tpu_torch.data.batcher import tree_map
from elasticdl_tpu_torch.embedding.combiner import RaggedIds, combine
from elasticdl_tpu_torch.embedding.table import supports_dirty_rows


class PreparedBatch(NamedTuple):
    """A batch whose host half is done (rows pulled, ids inverse-mapped):
    what ``prepared_batches`` yields, so the pull for batch N+1 can run
    while batch N's step executes.

    ``device_rows``/``device_batch`` are filled by the placement stage
    (``prepared_batches(place_rows=True)``): the row blocks and the
    batch already on the card, copied from pinned memory while the
    previous batch steps. None means the step copies them itself."""

    raw: dict       # the original batch
    batch: dict     # features with inverse maps substituted
    host_rows: dict
    uniques: dict
    device_rows: Optional[dict] = None
    device_batch: Optional[dict] = None


MIN_BUCKET = 8


def bucket_size(n: int, min_bucket: int = MIN_BUCKET) -> int:
    """Next power of two >= n (>= min_bucket): bounds the number of
    distinct row-block shapes to O(log vocab) per table."""
    b = min_bucket
    while b < n:
        b *= 2
    return b


class HostEmbedding(nn.Module):
    """Embedding lookup over the engine's per-batch row block.

    The input is the batch's **inverse map** (positions -> slots of the
    row block) from ``HostEmbeddingEngine.prepare_batch``, not raw ids;
    dense and ``RaggedIds`` + combiner inputs as the ``Embedding``
    layer. The module holds no parameter: the rows come from the
    ``host_rows`` keyword of the model's forward."""

    def __init__(self, table_name: str, output_dim: int,
                 combiner: Optional[str] = None):
        super().__init__()
        self.table_name = table_name
        self.output_dim = output_dim
        self.combiner = combiner

    def forward(self, inverse, host_rows):
        if not host_rows or self.table_name not in host_rows:
            raise ValueError(
                f"no row block for table {self.table_name!r}: the host "
                "runner passes host_rows={table: (bucket, D)} to the "
                "model's forward"
            )
        rows = host_rows[self.table_name]
        if isinstance(inverse, RaggedIds):
            if self.combiner is None:
                raise ValueError("RaggedIds input requires a combiner")
            ragged = inverse.to(rows.device)
            return combine(rows[ragged.ids.long()], ragged.weights,
                           self.combiner)
        return rows[torch.as_tensor(inverse, device=rows.device).long()]


def host_rows_template(model: nn.Module) -> Dict[str, int]:
    """{table name: output_dim} of the model's ``HostEmbedding``
    modules. Table names must be unique across the model."""
    names = [m.table_name for m in model.modules()
             if isinstance(m, HostEmbedding)]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise ValueError(
            f"host table names must be unique across the model: {dupes}"
        )
    return {m.table_name: m.output_dim for m in model.modules()
            if isinstance(m, HostEmbedding)}


def _to_device(tree, device):
    def put(x):
        if isinstance(x, RaggedIds):
            return x.to(device)
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return torch.as_tensor(np.asarray(x), device=device)

    return tree_map(put, tree)


def _apply_model(state, features, host_rows, training: bool):
    model = state.model
    model.train(training)
    if training and state.model_takes_generator:
        return model(features, host_rows=host_rows,
                     generator=state.generator)
    return model(features, host_rows=host_rows)


def build_host_train_step(loss_fn: Callable, rows_template) -> Callable:
    """``(state, batch, host_rows) -> (state, row_grads, metrics)``.

    The core step's contract plus the row block: ``host_rows`` (flat
    {table: (bucket, D)}, numpy or tensors) enters as leaves that
    require a gradient; their gradients come back flat, on the state's
    device (zeros for a table the model does not read), for the engine
    to apply. The model sees the tables of ``rows_template``
    (``host_rows_template(model)``). The dense parameters take their
    optimizer step in place."""
    call_loss = _call_loss(loss_fn)

    def train_step(state, batch, host_rows):
        dev = state.device
        features = _to_device(batch["features"], dev)
        labels = _to_device(batch["labels"], dev)
        mask = torch.as_tensor(batch["mask"], device=dev)
        rows = {name: torch.as_tensor(block, device=dev).detach()
                .requires_grad_(True) for name, block in host_rows.items()}
        state.optimizer.zero_grad(set_to_none=True)
        preds = _apply_model(state, features,
                             {name: rows[name] for name in rows_template},
                             training=True)
        loss = call_loss(labels, preds, mask)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        row_grads = {name: (r.grad if r.grad is not None
                            else torch.zeros_like(r))
                     for name, r in rows.items()}
        return state, row_grads, {"loss": loss.detach()}

    return train_step


def build_host_eval_step(rows_template) -> Callable:
    """``(state, batch, host_rows) -> predictions``."""

    def eval_step(state, batch, host_rows):
        dev = state.device
        features = _to_device(batch["features"], dev)
        rows = {name: torch.as_tensor(host_rows[name], device=dev)
                for name in rows_template}
        with torch.no_grad():
            return _apply_model(state, features, rows, training=False)

    return eval_step


def dedup_ids(raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(sorted unique ids, inverse map shaped like ``raw``, int32)."""
    uniq, inverse = np.unique(raw, return_inverse=True)
    return uniq, inverse.reshape(raw.shape).astype(np.int32)


def pad_rows(pulled: np.ndarray, dim: int) -> np.ndarray:
    """The pulled (u, D) rows in a zeroed (bucket_size(u), D) f32 block."""
    rows = np.zeros((bucket_size(len(pulled)), dim), np.float32)
    rows[:len(pulled)] = pulled
    return rows


def _pinned_to(x, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``: on the card, staged in
    pinned memory and copied with ``non_blocking=True``."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class HostEmbeddingEngine:
    """Pull, dedup and pad rows per batch; apply row gradients after.

    ``tables``:    {name: EmbeddingTable-like} (host or native),
    ``optimizer``: a ``HostOptimizerWrapper``-like object
                   (``apply_gradients(table, ids, grads)``),
    ``id_keys``:   {table_name: feature_key}: the feature carrying each
                   table's raw ids; ``prepare_batch`` replaces it with
                   the inverse map.

    Over concurrent-safe stores (the row service) a multi-table batch
    pulls and applies its tables on a pool, so it pays the slowest
    table, not their sum; other stores take the serial loop.
    """

    def __init__(self, tables: Dict, optimizer, id_keys: Dict[str, str],
                 metrics_registry=None):
        if metrics_registry is not None:
            raise NotImplementedError(
                "metrics_registry: the host engine's telemetry is not "
                "ported yet (ROADMAP Queue 1, item 8)")
        # Serialises host-side table access: neither the dict table nor
        # the C++ open-addressing map (which rehashes on growth) is safe
        # under concurrent mutation, and the applier thread writes while
        # the caller pulls. Stores that are safe under concurrent IO
        # (the row service's tables, whose server serialises row access)
        # declare ``concurrent_safe = True`` and skip the lock, so a
        # pull-ahead pull can be in flight while the applier pushes.
        self.lock = threading.RLock()
        self.concurrent_io = (
            all(getattr(t, "concurrent_safe", False)
                for t in tables.values())
            and getattr(optimizer, "concurrent_safe", False)
        )
        unknown = set(id_keys) - set(tables)
        if unknown:
            raise ValueError(f"id_keys reference unknown tables {unknown}")
        keys = list(id_keys.values())
        dupes = {k for k in keys if keys.count(k) > 1}
        if dupes:
            # Two tables sharing one feature would read the first
            # table's inverse map as the second's raw ids.
            raise ValueError(
                f"feature keys must be unique across tables: {dupes}"
            )
        self.tables = tables
        self.optimizer = optimizer
        self.id_keys = id_keys
        # Set by make_remote_engine: the service owns the rows'
        # checkpoints (HostStepRunner.host_tables is None).
        self.remote = False
        # Per-table fan-out pool (lazy; only for multi-table engines over
        # concurrent-safe stores): a batch pays max(table pull), not sum.
        # It is distinct from the sharded client's pool: a table task
        # waiting on its own shard sub-tasks in one bounded pool could
        # deadlock it.
        self._table_pool = None
        self._table_pool_lock = threading.Lock()

    def prepare_batch(self, batch: dict) -> Tuple[dict, dict, dict]:
        """The host half of the step: dedup ids, pull rows, bucket-pad.

        Returns (batch', host_rows, uniques):
        - batch': ``batch`` with each id feature replaced by its int32
          inverse map into the row block,
        - host_rows: {table: (bucket, D) float32}; rows[u:] are zero
          padding whose gradients are dropped,
        - uniques: {table: (unique_ids, u)} for ``apply_row_grads``.
        """
        if self.concurrent_io:
            return self._prepare_batch_locked(batch)
        with self.lock:
            return self._prepare_batch_locked(batch)

    def _get_table_pool(self):
        from concurrent.futures import ThreadPoolExecutor

        with self._table_pool_lock:
            if self._table_pool is None:
                self._table_pool = ThreadPoolExecutor(
                    max_workers=min(2 * len(self.id_keys), 16),
                    thread_name_prefix="table-fanout",
                )
                # A dropped engine must not leak its pool threads.
                weakref.finalize(self, self._table_pool.shutdown,
                                 wait=False)
            return self._table_pool

    def close(self):
        """Shut down the per-table fan-out pool (idempotent)."""
        with self._table_pool_lock:
            pool, self._table_pool = self._table_pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def _prepare_table(self, table_name, ids):
        """One table's prepare: dedup → pull → pad."""
        ragged = isinstance(ids, RaggedIds)
        raw = np.asarray(ids.ids if ragged else ids)
        uniq, inv = dedup_ids(raw)
        table = self.tables[table_name]
        rows = pad_rows(table.get(uniq), table.dim)
        feature = RaggedIds(ids=inv, weights=ids.weights) if ragged else inv
        return feature, rows, (uniq, len(uniq))

    def _prepare_batch_locked(self, batch):
        if not isinstance(batch["features"], dict):
            raise TypeError(
                "host-tier batches need dict features (id_keys names the "
                "feature carrying each table's ids); got "
                f"{type(batch['features']).__name__}"
            )
        features = dict(batch["features"])
        host_rows, uniques = {}, {}
        items = list(self.id_keys.items())
        if len(items) > 1 and self.concurrent_io:
            pool = self._get_table_pool()
            futures = [(name, key, pool.submit(self._prepare_table, name,
                                               features[key]))
                       for name, key in items]
            results = [(name, key, f.result()) for name, key, f in futures]
        else:
            results = [(name, key, self._prepare_table(name, features[key]))
                       for name, key in items]
        for name, key, (feature, rows, uniq_u) in results:
            features[key] = feature
            host_rows[name] = rows
            uniques[name] = uniq_u
        out = dict(batch)
        out["features"] = features
        return out, host_rows, uniques

    def place_on_device(self, prepared: PreparedBatch,
                        device) -> PreparedBatch:
        """The placement stage: the row blocks and the batch copied to
        ``device`` (from pinned memory, ``non_blocking``) for an
        upcoming step while the current one executes."""
        device = torch.device(device)

        def put(x):
            if isinstance(x, RaggedIds):
                return RaggedIds(ids=_pinned_to(x.ids, device),
                                 weights=_pinned_to(x.weights, device))
            return _pinned_to(x, device)

        return prepared._replace(
            device_rows={k: put(v) for k, v in prepared.host_rows.items()},
            device_batch=tree_map(put, prepared.batch),
        )

    def apply_row_grads(self, row_grads: dict, uniques: dict) -> None:
        """Apply the step's row gradients (numpy, (>= u, D) a table) to
        the host tables: look up, apply, write back."""
        if self.concurrent_io:
            self._apply_row_grads_inner(row_grads, uniques)
            return
        with self.lock:
            self._apply_row_grads_inner(row_grads, uniques)

    def _apply_row_grads_inner(self, row_grads, uniques):
        items = list(uniques.items())
        if len(items) > 1 and self.concurrent_io:
            # Tables are disjoint row spaces, so their applies commute;
            # one batch's futures are joined before the next batch's.
            pool = self._get_table_pool()
            futures = [pool.submit(self._apply_table, name, uniq, u,
                                   row_grads[name])
                       for name, (uniq, u) in items]
            for f in futures:
                f.result()
        else:
            for name, (uniq, u) in items:
                self._apply_table(name, uniq, u, row_grads[name])

    def _apply_table(self, table_name, uniq, u, grads):
        self.optimizer.apply_gradients(self.tables[table_name], uniq,
                                       np.asarray(grads)[:u])

    def prepared_batches(self, batches: Iterable[dict], depth: int = 2,
                         place_rows: bool = False, device=None):
        """Iterator of ``PreparedBatch``: rows for upcoming batches are
        pulled on a thread while the current batch trains.
        ``place_rows`` adds the placement stage on a second thread
        (``place_on_device`` to ``device``).

        Staleness: a prefetched batch can read a shared id up to
        ``depth + 1`` applies behind (``depth + 3`` with the placement
        stage: its queue slot and the copy in flight).

        Returns a PrefetchIterator; ``close()`` it (or use it as a
        context manager) when abandoning it mid-stream: closing the last
        stage tears down the chain."""
        from elasticdl_tpu_torch.data.prefetch import prefetch, staged

        prepared = prefetch(
            (PreparedBatch(b, *self.prepare_batch(b)) for b in batches),
            depth=depth,
        )
        if not place_rows:
            return prepared
        if device is None:
            raise ValueError("place_rows=True needs the step's device")
        return staged(prepared,
                      lambda pb: self.place_on_device(pb, device), depth=1)


class _HostGrads:
    """A step's row gradients on their way to the host: the first ``u``
    rows of each table's (bucket, D) block. On the card (``stream``
    given) they are copied into pinned memory on ``stream``, which waits
    on an event recorded after the step on the caller's stream, so the
    copy never waits on the next step's kernels; ``wait`` blocks on that
    copy alone. Elsewhere they are read at once."""

    def __init__(self, row_grads: dict, uniques: dict, stream=None):
        self._done = None
        if stream is None:
            self._arrays = {name: g[:uniques[name][1]].detach().cpu()
                            .numpy() for name, g in row_grads.items()}
            return
        after = torch.cuda.Event()
        after.record()
        stream.wait_event(after)
        self._arrays = {}
        with torch.cuda.stream(stream):
            for name, g in row_grads.items():
                n = uniques[name][1]
                buf = torch.empty((n,) + tuple(g.shape[1:]), dtype=g.dtype,
                                  pin_memory=True)
                buf.copy_(g[:n], non_blocking=True)
                g.record_stream(stream)
                self._arrays[name] = buf
        self._done = torch.cuda.Event()
        self._done.record(stream)

    def wait(self) -> Dict[str, np.ndarray]:
        if self._done is None:
            return self._arrays
        self._done.synchronize()
        return {name: buf.numpy() for name, buf in self._arrays.items()}


class HostStepRunner:
    """Step runner (``init_state``/``train_step``/``eval_step``) for
    host-tier models: pull and apply happen inside the wrapped step, so
    the executor's (state, batch) contract is unchanged.

    - **Async apply** (default): the step hands its row gradients
      (``_HostGrads``, copied off the card without waiting on later
      kernels) to a single applier thread through a queue of depth 2,
      so the applier falls at most one step behind; writes stay in
      order. ``flush`` is the read barrier.
    - **Pull-ahead**: ``iter_prepared`` wraps a batch stream so rows for
      upcoming batches are pulled on a prefetch thread while the current
      batch trains, and (``place_rows``) placed on the card by a second
      stage.
    """

    def __init__(self, engine: HostEmbeddingEngine,
                 async_apply: bool = True):
        self.engine = engine
        self._template = None
        self._device = None
        self._copy_stream = None
        self._async_apply = async_apply
        self._apply_queue = None
        self._apply_thread = None
        self._apply_error = None

    # ---- async applier --------------------------------------------------

    def _applier_loop(self):
        while True:
            item = self._apply_queue.get()
            try:
                if item is None:
                    return
                grads, uniques = item
                try:
                    self.engine.apply_row_grads(grads.wait(), uniques)
                except BaseException as exc:  # surfaced on next step/flush
                    self._apply_error = exc
            finally:
                self._apply_queue.task_done()

    def _enqueue_apply(self, grads: _HostGrads, uniques):
        if self._apply_thread is None:
            self._apply_queue = queue.Queue(maxsize=2)
            self._apply_thread = threading.Thread(
                target=self._applier_loop, daemon=True,
                name="host-row-applier",
            )
            self._apply_thread.start()
        self._raise_pending()
        self._apply_queue.put((grads, uniques))

    def _raise_pending(self):
        if self._apply_error is not None:
            exc, self._apply_error = self._apply_error, None
            raise exc

    def flush(self):
        """Wait for every enqueued row apply to land; re-raises applier
        failures."""
        if self._apply_queue is not None:
            self._apply_queue.join()
        self._raise_pending()

    @property
    def pull_ahead(self) -> bool:
        """Whether a task loop should wrap batches in ``iter_prepared``:
        only under async apply (a synchronous runner promised exact
        semantics, and pull-ahead reads stale rows)."""
        return self._async_apply

    def iter_prepared(self, batches: Iterable[dict], depth: int = 2,
                      place_rows: bool = True):
        """Pull-ahead iterator of ``PreparedBatch`` (the engine's
        ``prepared_batches`` onto this runner's device); ``close()`` it
        when abandoning it mid-stream."""
        if place_rows and self._device is None:
            raise RuntimeError("init_state() before iter_prepared(place_rows"
                               "=True): the runner learns its device there")
        return self.engine.prepared_batches(
            batches, depth=max(1, int(depth)), place_rows=place_rows,
            device=self._device,
        )

    @property
    def host_tables(self) -> Dict:
        """Everything a checkpoint must carry: the main tables plus the
        row optimizer's slot tables and per-table step counters, each
        behind a view that drains pending applies and takes the engine's
        lock. None for a remote engine: the row service checkpoints its
        rows, as the reference's parameter server did."""
        if self.engine.remote:
            return None
        return locked_checkpoint_tables(
            self.engine.tables, self.engine.optimizer, self.engine.lock,
            flush=self.flush,
        )

    def init_state(self, model, make_optimizer, batch, seed: int = 0):
        self.flush()
        self._template = host_rows_template(model)
        state = init_train_state(model, make_optimizer, seed=seed)
        self._device = state.device
        if self._device.type == "cuda" and self._async_apply:
            self._copy_stream = torch.cuda.Stream(self._device)
        return state

    def _built(self):
        if self._template is None:
            raise RuntimeError("init_state() before building a step")
        return self._template

    def train_step(self, loss_fn: Callable) -> Callable:
        host_step = build_host_train_step(loss_fn, self._built())
        engine = self.engine

        def step(state, batch):
            if isinstance(batch, PreparedBatch):
                prepared = (batch.device_batch
                            if batch.device_batch is not None
                            else batch.batch)
                host_rows = (batch.device_rows
                             if batch.device_rows is not None
                             else batch.host_rows)
                uniques = batch.uniques
            else:
                prepared, host_rows, uniques = engine.prepare_batch(batch)
            state, row_grads, metrics = host_step(state, prepared,
                                                  host_rows)
            if self._async_apply:
                self._enqueue_apply(
                    _HostGrads(row_grads, uniques, self._copy_stream),
                    uniques)
            else:
                engine.apply_row_grads(
                    _HostGrads(row_grads, uniques).wait(), uniques)
            return state, metrics

        return step

    def eval_step(self) -> Callable:
        host_eval = build_host_eval_step(self._built())
        engine = self.engine

        def step(state, batch):
            # Eval must see every trained row: drain pending applies.
            self.flush()
            if isinstance(batch, PreparedBatch):
                # Pulled before the flush: re-pull from the raw batch.
                batch = batch.raw
            prepared, host_rows, _ = engine.prepare_batch(batch)
            return host_eval(state, prepared, host_rows)

        return step


def locked_checkpoint_tables(tables: Dict, optimizer, lock,
                             flush=None) -> Dict:
    """Main tables plus the optimizer's slot tables and step counters,
    each behind a lock-guarded view. ``flush`` (the runner's async-apply
    drain) runs before any read, so a snapshot never misses an apply in
    flight."""
    out = dict(tables)
    state_tables = getattr(optimizer, "state_tables", None)
    if state_tables is not None:
        out.update(state_tables(tables))
    return {name: _LockedTable(table, lock, flush)
            for name, table in out.items()}


class _LockedTable:
    """Lock-guarded view over a host table (or checkpoint adapter):
    snapshots and restores run under the engine's lock, never racing
    the applier; reads drain pending applies first. Dirty-row tracking
    passes through under the same lock."""

    def __init__(self, table, lock, flush=None):
        self._table = table
        self._lock = lock
        self._flush = flush

    def _drain(self):
        if self._flush is not None:
            self._flush()

    def to_arrays(self):
        self._drain()
        with self._lock:
            return self._table.to_arrays()

    @property
    def supports_dirty_rows(self) -> bool:
        return supports_dirty_rows(self._table)

    def dirty_arrays(self):
        self._drain()
        with self._lock:
            return self._table.dirty_arrays()

    def capture_arrays(self):
        """Full snapshot + dirty drain under ONE lock acquisition: split,
        a write landing between them would be excluded from the
        snapshot with its dirty mark wiped."""
        self._drain()
        with self._lock:
            ids, rows = self._table.to_arrays()
            if supports_dirty_rows(self._table):
                self._table.clear_dirty()
            return ids, rows

    def mark_dirty(self, ids):
        with self._lock:
            self._table.mark_dirty(ids)

    def clear_dirty(self):
        with self._lock:
            self._table.clear_dirty()

    @property
    def dirty_count(self) -> int:
        with self._lock:
            return self._table.dirty_count

    def set(self, ids, values):
        self._drain()
        with self._lock:
            return self._table.set(ids, values)

    def get(self, ids):
        self._drain()
        with self._lock:
            return self._table.get(ids)

    @property
    def num_rows(self):
        self._drain()
        with self._lock:
            return self._table.num_rows

    def __getattr__(self, name):
        return getattr(self._table, name)
