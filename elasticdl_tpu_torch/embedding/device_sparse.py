"""Device-tier sparse embedding training: the parameter server's hot
path in HBM (port of elasticdl_tpu/embedding/device_sparse.py).

The reference trains big embedding tables on parameter-server pods:
pull rows, compute, push row gradients, C++ kernels apply them. When the
table fits in the card's memory it stays next to the model and a step
keeps the sparse structure:

- **forward** reads the table through ``ops/pallas_embedding
  .lookup_combine`` (the lookup kernel where ``use_pallas="always"`` pins
  it, the library gather otherwise); the table is not differentiated, so
  no dense (V, D) gradient ever exists;
- **backward** gives gradients of the batch's unique ids only (the
  transpose of the combiner, ``_row_grads``);
- **update** goes through ``embedding/optimizer.sparse_apply``: the row
  kernels under "always"/"fused", the library route otherwise.

Tables, slot tables and the dense parameters are updated IN PLACE, as
the TPU kernels alias them (``input_output_aliases``) and the JAX step
donates its state: a step returns the state object it was given.
``table_steps`` are host integers (the per-table apply count for Adam's
bias correction), so nothing on a step reads a value back from the card.

Models read each table's (B, D) combined embedding through
``SparseEmbed``, from the ``sparse_emb={table: tensor}`` keyword of their
forward, which takes the place of flax's ``sparse_emb`` collection.

With a mesh (``DeviceSparseRunner(mesh=, axis=)``), each table over the
size threshold whose vocab the axis divides is ROW-SHARDED: entry i
holds rows [i·V/n, (i+1)·V/n) of the table and of its slot tables as
tensors of its own (``parallel.mesh.ShardedTensor``). The JAX step's
``shard_map`` bodies run shard by shard: the lookup through
``ops/pallas_embedding.lookup_combine_sharded`` (kernel #6 once a
shard), the update through ``sparse_apply_sharded`` (kernel #7, or #8
under "fused", once a shard) on the globally deduplicated ids. The
dense model runs the global batch once, its optimizer replicated, as
in the JAX runner.

Over a mesh that spans processes (``parallel/multihost.py``) a process
holds only its entries' shards; its rows, drawn from the seed's whole
table on the host, are the same rows a single process draws. A step
all-gathers the processes' ids and weights, so every process launches
#6 once for each of its shards over the global batch's ids; the
partials are all-reduced over the data group and each process keeps
its rows. The loss is weighed by the process's share of the global
mask count before the backward (``core/step._loss_share``); after it
the dense gradients and the loss are all-reduced, the embeddings'
gradients (B_local x D, the smallest of the step's cotangents)
all-gathered, and every process derives the row gradients of the
global unique ids and launches #7 (or #8) once a shard on the ids of
its range.
"""

from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, Tuple

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.core.step import (
    _call_loss,
    _loss_share,
    _sum_over_processes,
)
from elasticdl_tpu_torch.core.train_state import TrainState, init_train_state
from elasticdl_tpu_torch.data.batcher import tree_map
from elasticdl_tpu_torch.embedding.combiner import COMBINERS, RaggedIds, combine
from elasticdl_tpu_torch.embedding.optimizer import (
    RowOptimizer,
    init_slot_tables,
    pack_table,
    sparse_apply,
    sparse_apply_packed,
    unique_pad,
)
from elasticdl_tpu_torch.embedding.partition import (
    DEFAULT_PARTITION_THRESHOLD_BYTES,
)
from elasticdl_tpu_torch.parallel import multihost
from elasticdl_tpu_torch.parallel.mesh import (
    NamedSharding,
    ShardedTensor,
    whole,
)
from elasticdl_tpu_torch.parallel.rules import PartitionSpec


@dataclass(frozen=True)
class TableSpec:
    """One device-resident sparse table: ``feature_key`` names the batch
    feature carrying its RaggedIds (or dense (B, L) ids)."""

    name: str
    vocab: int
    dim: int
    combiner: str = "sum"
    feature_key: str = "ids"

    def __post_init__(self):
        if self.combiner not in COMBINERS:
            raise ValueError(f"combiner must be one of {COMBINERS}")


class SparseEmbed(nn.Module):
    """The runner-computed (B, output_dim) combined embedding of one
    table, read from the model's ``sparse_emb`` forward keyword. The
    model never touches the (V, D) table: the sparse step owns lookup
    and update."""

    def __init__(self, table_name: str, output_dim: int):
        super().__init__()
        self.table_name = table_name
        self.output_dim = output_dim

    def forward(self, sparse_emb):
        if not sparse_emb or self.table_name not in sparse_emb:
            raise ValueError(
                f"no combined embedding for table {self.table_name!r}: "
                "the sparse runner passes sparse_emb={table: (B, D)} to "
                "the model's forward"
            )
        return sparse_emb[self.table_name]


def sparse_template(model: nn.Module) -> Dict[str, int]:
    """{table name: output_dim} of the model's ``SparseEmbed`` modules
    (the JAX step's ``sparse_emb`` collection structure)."""
    return {m.table_name: m.output_dim for m in model.modules()
            if isinstance(m, SparseEmbed)}


@dataclass
class SparseTrainState(TrainState):
    """TrainState + the sparse plane: {table: (V, D)} main tables, their
    slot tables, and per-table host apply counts."""

    tables: Dict[str, torch.Tensor] = field(default_factory=dict)
    slot_tables: Dict[str, Dict[str, torch.Tensor]] = field(
        default_factory=dict)
    table_steps: Dict[str, int] = field(default_factory=dict)


def _iter_leaves(node, out=None):
    out = [] if out is None else out
    for key, value in node.items():
        if isinstance(value, dict):
            _iter_leaves(value, out)
        else:
            out.append((key, value))
    return out


def _nest_rows(template, flat):
    """Flat {table: rows} -> the template's (nested) shape."""
    return {
        key: (_nest_rows(value, flat) if isinstance(value, dict)
              else flat[key])
        for key, value in template.items()
    }


def _ragged(ids, device) -> RaggedIds:
    if isinstance(ids, RaggedIds):
        return ids.to(device)
    ids = torch.as_tensor(ids, device=device).to(torch.int32)
    return RaggedIds(ids=ids, weights=torch.ones(
        ids.shape, dtype=torch.float32, device=device))


def _to_device(tree, device):
    return tree_map(
        lambda x: x.to(device) if isinstance(x, RaggedIds)
        else torch.as_tensor(np.asarray(x), device=device), tree)


def _unique_pad(ids_flat, vocab: int):
    """Static-shape dedup of a step's ids: (uids, inverse), int32, uids
    padded to ``ids_flat.numel()`` with the out-of-range ``vocab`` (the
    pad every row kernel skips); nothing read back to the host."""
    uids, inverse = unique_pad(ids_flat, vocab)
    return uids.to(torch.int32), inverse.to(torch.int32)


def _row_grads(d_emb, uids, inverse, ragged: RaggedIds, combiner: str):
    """Exact row gradients: the transpose of the combiner, which is
    linear in the rows. (B, D) cotangent -> (U, D) gradients of the
    unique ids; a row's occurrences are summed with ``index_add_``
    (atomics on the card, so the order of a duplicate id's sum changes
    from run to run). Mean and sqrtn divide by the row's denominator; a
    zero denominator gives 0."""
    g = d_emb.float()
    w = ragged.weights
    if combiner == "sum":
        scaled = g
    else:
        if combiner == "mean":
            denom = w.sum(dim=-1, keepdim=True)
        else:
            denom = torch.sqrt((w * w).sum(dim=-1, keepdim=True))
        positive = denom > 0
        scaled = torch.where(positive, g / torch.where(positive, denom, 1.0),
                             0.0)
    contrib = scaled[:, None, :] * w[..., None]          # (B, L, D)
    rows_ct = torch.zeros(uids.shape[0], g.shape[-1], dtype=torch.float32,
                          device=g.device)
    rows_ct.index_add_(0, inverse.reshape(-1),
                       contrib.reshape(-1, g.shape[-1]))
    return rows_ct


def _lookups(state, features, specs, use_pallas: str, packed_slots: bool):
    """Each table's (B, D) combined embedding from the live table (a
    row-sharded one shard by shard), and its ragged ids. Over a global
    batch (``state.global_batch``, a mesh across processes): the ids and
    weights are the global batch's, all-gathered; a sharded table's
    partials are all-reduced, and the embeddings keep this process's
    rows; the ragged ids stay global."""
    from elasticdl_tpu_torch.ops.pallas_embedding import (
        lookup_combine,
        lookup_combine_sharded,
    )

    global_batch = state.global_batch
    embs, raggeds = {}, {}
    with torch.no_grad():
        for spec in specs:
            ragged = _ragged(features[spec.feature_key], state.device)
            local_rows = int(ragged.ids.shape[0])
            if global_batch is not None:
                ragged = RaggedIds(ids=global_batch.gather(ragged.ids),
                                   weights=global_batch.gather(
                                       ragged.weights))
            table = state.tables[spec.name]
            if packed_slots:
                # The packed rows narrowed to their first D columns.
                rows = table[ragged.ids.long()][..., :spec.dim]
                embs[spec.name] = combine(rows, ragged.weights,
                                          spec.combiner)
            elif isinstance(table, ShardedTensor):
                embs[spec.name] = lookup_combine_sharded(
                    table.shards, ragged.ids, ragged.weights, spec.combiner,
                    force_pallas=use_pallas == "always",
                    force_xla=use_pallas == "never",
                    first_shard=table.sharding.local_shards[0],
                    reduce=None if global_batch is None
                    else global_batch.sum)
            else:
                embs[spec.name] = lookup_combine(
                    table, ragged.ids, ragged.weights, spec.combiner,
                    force_pallas=use_pallas == "always",
                    force_xla=use_pallas == "never")
            if global_batch is not None:
                start = global_batch.rows(local_rows)[1]
                embs[spec.name] = embs[spec.name][start:start + local_rows]
            raggeds[spec.name] = ragged
    return embs, raggeds


def _apply_model(state, features, sparse_emb, training: bool):
    model = state.model
    model.train(training)
    if training and state.model_takes_generator:
        return model(features, sparse_emb=sparse_emb,
                     generator=state.generator)
    return model(features, sparse_emb=sparse_emb)


def sparse_apply_sharded(opt: RowOptimizer, table: ShardedTensor,
                         slot_tables: Dict[str, ShardedTensor], unique_ids,
                         row_grads, step, use_pallas: str = "auto"):
    """``sparse_apply`` over a ROW-SHARDED table, shard by shard: entry i
    owns rows [i·V/n, (i+1)·V/n) and applies only the updates whose id
    lands in its range (contiguous row ranges, where the reference sends
    id % N to N parameter servers). Ids out of the local range, the
    global pad sentinel V among them, map to the local sentinel V/n,
    which ``sparse_apply`` skips, so remote ids and pads cost a shard
    nothing. ``unique_ids`` must be deduplicated globally
    (``_unique_pad`` over the global batch): each real id then updates
    exactly one shard exactly once. In place; returns ``(table,
    slot_tables)``."""
    shard_rows = int(table.shards[0].shape[0])
    ids = unique_ids.to(torch.int32)
    for i, shard in zip(table.sharding.local_shards, table.shards):
        local = ids - i * shard_rows
        in_range = (local >= 0) & (local < shard_rows)
        local = torch.where(in_range, local, shard_rows)
        sparse_apply(opt, shard,
                     {n: t.shards[i - table.sharding.local_shards[0]]
                      for n, t in slot_tables.items()},
                     local, row_grads, step=step, use_pallas=use_pallas)
    return table, slot_tables


def build_sparse_train_step(
    loss_fn: Callable,
    specs: Tuple[TableSpec, ...],
    row_opt: RowOptimizer,
    template,
    use_pallas: str = "auto",
    mesh=None,
    sharded_tables: FrozenSet[str] = frozenset(),
    packed_slots: bool = False,
) -> Callable:
    """``(SparseTrainState, batch) -> (state, metrics)``: lookup, model
    forward and backward, the sparse row update and the dense optimizer
    step, all in place. ``template`` is the model's ``sparse_template``.

    With ``mesh``, the tables in ``sharded_tables`` are row-sharded
    (``ShardedTensor`` leaves, which carry their placement): lookup through
    ``lookup_combine_sharded``, update through ``sparse_apply_sharded``;
    the same math partitioned by row range. Dedup and the dense model
    stay in the global view.

    ``packed_slots``: the slot tables live inside the main table's rows
    ((V, D*(1+n_slots)), ``optimizer.pack_table``), so the apply is one
    gather and one scatter (``sparse_apply_packed``); library route and
    single mesh only."""
    if sharded_tables and mesh is None:
        raise ValueError("sharded_tables requires a mesh")
    if packed_slots and (mesh is not None or sharded_tables):
        raise ValueError(
            "packed_slots is single-mesh only (the row-sharded path "
            "keeps split tables)"
        )
    if packed_slots and use_pallas in ("always", "fused"):
        raise ValueError(
            "packed_slots uses the library gather/scatter route; the row "
            "kernels (serial and fused) operate on split tables"
        )
    call_loss = _call_loss(loss_fn)

    def train_step(state: SparseTrainState, batch):
        dev = state.device
        features = _to_device(batch["features"], dev)
        labels = _to_device(batch["labels"], dev)
        mask = torch.as_tensor(batch["mask"], device=dev)
        embs, raggeds = _lookups(state, features, specs, use_pallas,
                                 packed_slots)
        for emb in embs.values():
            emb.requires_grad_(True)
        state.optimizer.zero_grad(set_to_none=True)
        preds = _apply_model(state, features, _nest_rows(template, embs),
                             training=True)
        loss = call_loss(labels, preds, mask)
        share = _loss_share(state.global_batch, batch["mask"], dev)
        if share is not None:
            loss = loss * share
        loss.backward()
        if share is not None:
            loss = _sum_over_processes(state, loss.detach())
        with torch.no_grad():
            for spec in specs:
                ragged = raggeds[spec.name]
                d_emb = embs[spec.name].grad
                if state.global_batch is not None:
                    d_emb = state.global_batch.gather(d_emb)
                uids, inverse = _unique_pad(ragged.ids.reshape(-1),
                                            spec.vocab)
                rows_ct = _row_grads(d_emb, uids, inverse, ragged,
                                     spec.combiner)
                step_count = state.table_steps[spec.name] + 1
                if packed_slots:
                    sparse_apply_packed(row_opt, state.tables[spec.name],
                                        uids, rows_ct, step_count, spec.dim)
                elif spec.name in sharded_tables:
                    sparse_apply_sharded(row_opt, state.tables[spec.name],
                                         state.slot_tables[spec.name], uids,
                                         rows_ct, step_count,
                                         use_pallas=use_pallas)
                else:
                    sparse_apply(row_opt, state.tables[spec.name],
                                 state.slot_tables[spec.name], uids,
                                 rows_ct, step=step_count,
                                 use_pallas=use_pallas)
                state.table_steps[spec.name] = step_count
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    return train_step


def build_sparse_multi_step(loss_fn, specs, row_opt, template,
                            use_pallas: str = "auto", mesh=None,
                            sharded_tables: FrozenSet[str] = frozenset(),
                            packed_slots: bool = False) -> Callable:
    """``(state, batches) -> (state, {"loss": (T,)})`` over batches
    stacked on a leading task dim T (``core.step.stack_batches``): T
    sparse steps in a loop (the JAX package's ``lax.scan``)."""
    step = build_sparse_train_step(
        loss_fn, specs, row_opt, template, use_pallas=use_pallas,
        mesh=mesh, sharded_tables=sharded_tables,
        packed_slots=packed_slots,
    )

    def multi_step(state, batches):
        losses = []
        for i in range(len(batches["mask"])):
            state, metrics = step(state, tree_map(lambda x: x[i], batches))
            losses.append(metrics["loss"])
        return state, {"loss": torch.stack(losses)}

    return multi_step


def init_sparse_state(
    model: nn.Module, make_optimizer: Callable, example_batch,
    specs: Tuple[TableSpec, ...], row_opt: RowOptimizer, seed: int = 0,
    table_dtype=torch.float32, packed_slots: bool = False,
    host_tables: FrozenSet[str] = frozenset(),
) -> Tuple[SparseTrainState, Dict[str, int]]:
    """The train state around ``model`` (built, on its device) plus the
    tables on the same device: each uniform in ±1/√D, drawn on the CPU
    from a generator seeded from ``seed`` and the table's index (so the
    card and the CPU start from the same tables), slots at their initial
    values. Tables named in ``host_tables`` (and their slots) stay on
    the CPU, for the caller to place (a row-sharded table's shards).
    Returns ``(state, template)``. With
    ``packed_slots`` each table is the (V, D*(1+n_slots)) packed store
    and ``slot_tables`` entries are empty."""
    template = sparse_template(model)
    names = [key for key, _ in _iter_leaves(template)]
    missing = {s.name for s in specs} - set(names)
    if missing:
        raise ValueError(
            f"model declares no SparseEmbed for tables {missing}"
        )
    features = example_batch["features"]
    absent = {s.feature_key for s in specs} - set(features)
    if absent:
        raise ValueError(f"the batch carries no features {absent}")
    base = init_train_state(model, make_optimizer, seed=seed)
    device = base.device
    tables, slot_tables, table_steps = {}, {}, {}
    for i, spec in enumerate(specs):
        gen = torch.Generator().manual_seed(int(seed) * 1_000_003 + i)
        scale = 1.0 / np.sqrt(spec.dim)
        place = torch.device("cpu") if spec.name in host_tables else device
        main = torch.empty((spec.vocab, spec.dim), dtype=table_dtype).uniform_(
            -scale, scale, generator=gen).to(place)
        slots = init_slot_tables(row_opt, spec.vocab, spec.dim,
                                 dtype=table_dtype, device=place)
        if packed_slots:
            tables[spec.name] = pack_table(main, slots, row_opt)
            slot_tables[spec.name] = {}
        else:
            tables[spec.name] = main
            slot_tables[spec.name] = slots
        table_steps[spec.name] = 0
    state = SparseTrainState(
        model=base.model, optimizer=base.optimizer,
        generator=base.generator,
        model_takes_generator=base.model_takes_generator,
        tables=tables, slot_tables=slot_tables, table_steps=table_steps,
    )
    return state, template


class DeviceSparseRunner:
    """Step runner (``init_state``/``train_step``/``train_multi_step``/
    ``eval_step``) for device-tier sparse models: what the Local
    executor and the worker drive for a zoo module with
    ``make_sparse_runner``.

    ``use_pallas``: "auto" and "never" take the library routes; "always"
    pins the lookup kernel and the row kernel (kernel #7) on every train
    and eval step; "fused" keeps the library lookup and takes the fused
    row kernel (#8) where it exists. ``packed_slots``: the slot tables
    ride inside the table's rows (library route, single mesh only).

    With ``mesh``, every table over ``partition_threshold_bytes`` whose
    vocab divides the ``axis`` size is row-sharded over the mesh, its
    slot tables with it (the reference co-locates slots with their
    table, ``ps/parameters.py:156``); the dense parameters and their
    optimizer stay whole (replicated). This is the N-parameter-server
    sparse plane (``docs/designs/parameter_server.md``, "Model
    Parameter Partition") with row ranges in place of id % N."""

    def __init__(self, specs: Tuple[TableSpec, ...], row_opt: RowOptimizer,
                 use_pallas: str = "auto", mesh=None, axis: str = "dp",
                 partition_threshold_bytes: int =
                 DEFAULT_PARTITION_THRESHOLD_BYTES,
                 packed_slots: bool = False):
        if packed_slots and mesh is not None:
            raise ValueError(
                "packed_slots is single-mesh only (row-sharded tables "
                "keep the split layout)"
            )
        if use_pallas not in ("auto", "never", "always", "fused"):
            raise ValueError(f"use_pallas={use_pallas!r}")
        if packed_slots and use_pallas in ("always", "fused"):
            raise ValueError(
                "packed_slots uses the library gather/scatter route; "
                f"use_pallas={use_pallas!r} pins split-table kernels"
            )
        self.specs = tuple(specs)
        self.row_opt = row_opt
        self.use_pallas = use_pallas
        self.partition_threshold_bytes = int(partition_threshold_bytes)
        self.packed_slots = bool(packed_slots)
        self.mesh = mesh
        self.axis = axis
        self.sharded_tables = self._sharded_tables_for(mesh)
        self._template = None

    def _sharded_tables_for(self, mesh) -> frozenset:
        """Which tables row-shard on ``mesh``: the vocab divides the axis
        and the table clears the size threshold. Re-derived on resize: a
        table that divides dp4 may not divide dp3."""
        if mesh is None:
            return frozenset()
        n = mesh.shape[self.axis]
        return frozenset(
            s.name for s in self.specs
            if s.vocab % n == 0
            and s.vocab * s.dim * 4 > self.partition_threshold_bytes
        )

    def _table_sharding(self, name) -> NamedSharding:
        spec = (PartitionSpec(self.axis, None)
                if name in self.sharded_tables else PartitionSpec())
        return NamedSharding(self.mesh, spec)

    def state_shardings(self, state) -> Dict[str, NamedSharding]:
        """{checkpoint leaf name: NamedSharding}: ``tables.<t>`` and
        ``slot_tables.<t>.<slot>`` on ``P(axis, None)`` for a sharded
        table, every other leaf replicated."""
        from elasticdl_tpu_torch.checkpoint.state_io import named_leaves

        rep = NamedSharding(self.mesh, PartitionSpec())
        out = {}
        for name, _ in named_leaves(state):
            field, _, rest = name.partition(".")
            table = rest.split(".")[0]
            out[name] = (self._table_sharding(table)
                         if field in ("tables", "slot_tables") else rep)
        return out

    def init_state(self, model, make_optimizer, batch, seed: int = 0):
        if self.mesh is not None:
            model = model.to(self.mesh.device)
        # A row-sharded table is drawn whole on the host and only its
        # local shards reach the card.
        state, self._template = init_sparse_state(
            model, make_optimizer, batch, self.specs, self.row_opt,
            seed=seed, packed_slots=self.packed_slots,
            host_tables=self.sharded_tables,
        )
        return self.place_state(state)

    def _placed(self, name, leaf, device):
        if self.mesh is None:
            return whole(leaf).to(device)
        sharding = self._table_sharding(name)
        if isinstance(leaf, ShardedTensor) and leaf.sharding == sharding:
            return leaf
        value = whole(leaf)
        if sharding.is_replicated:
            return value.to(device)
        return ShardedTensor.from_whole(sharding, value)

    def place_state(self, state):
        """Place ``state`` on the runner's mesh, in place: each table and
        slot table whole or row-sharded as the mesh says (a restored or
        resharded leaf is gathered and split again, one leaf at a time,
        so the card holds at most one extra table). No mesh: every leaf
        whole, on the model's device. The state and its model carry the
        mesh's ``multihost.GlobalBatch`` (``multihost.attach``)."""
        if self.mesh is not None:
            state.model.to(self.mesh.device)
        multihost.attach(state, self.mesh, (self.axis, "sp"))
        device = state.device
        for name in list(state.tables):
            state.tables[name] = self._placed(name, state.tables[name],
                                              device)
            slots = state.slot_tables.get(name, {})
            for slot in list(slots):
                slots[slot] = self._placed(name, slots[slot], device)
        return state

    def resize(self, new_mesh, state=None):
        """Move to ``new_mesh`` without a disk round trip
        (``parallel/reshard.live_reshard``): each row-sharded table's
        row ranges change (dp4 -> dp2 doubles each shard) and its slot
        tables move with it. On a failure the runner and the state stay
        on the old mesh and the error is raised. Returns the state (None
        before ``init_state``). Steps built before must be rebuilt."""
        from elasticdl_tpu_torch.parallel import reshard as reshard_lib
        from elasticdl_tpu_torch.parallel.mesh_runner import (
            refuse_process_resize,
        )

        refuse_process_resize(self.mesh, new_mesh)
        old_mesh = self.mesh

        def bind(mesh):
            self.mesh = mesh
            self.sharded_tables = self._sharded_tables_for(mesh)

        def undo(s):
            bind(old_mesh)
            self.place_state(s)

        try:
            bind(new_mesh)
            if state is None:
                return None
            return reshard_lib.live_reshard(state, self.state_shardings,
                                            self.place_state, undo)
        except Exception:
            bind(old_mesh)
            raise

    def _step_args(self):
        if self._template is None:
            raise RuntimeError("init_state() before building a step")
        return dict(specs=self.specs, row_opt=self.row_opt,
                    template=self._template, use_pallas=self.use_pallas,
                    mesh=self.mesh, sharded_tables=self.sharded_tables,
                    packed_slots=self.packed_slots)

    def train_step(self, loss_fn):
        return build_sparse_train_step(loss_fn, **self._step_args())

    def train_multi_step(self, loss_fn):
        return build_sparse_multi_step(loss_fn, **self._step_args())

    def eval_step(self):
        args = self._step_args()

        def step(state, batch):
            features = _to_device(batch["features"], state.device)
            embs, _ = _lookups(state, features, args["specs"],
                               args["use_pallas"], args["packed_slots"])
            with torch.no_grad():
                return _apply_model(state, features,
                                    _nest_rows(args["template"], embs),
                                    training=False)

        return step
