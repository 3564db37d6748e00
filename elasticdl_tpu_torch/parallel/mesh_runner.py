"""MeshRunner: data-parallel train/eval steps over a device mesh (port
of elasticdl_tpu/parallel/mesh_runner.py).

The JAX runner jits one global program per step: the batch sharded over
the data axis, parameters placed by rules (replicated unless a rule
places them), the optimizer state ZeRO-sharded, and GSPMD partitions
that program over the mesh. Its numbers are the global program's, so a
dp-N run equals dp-1 up to reduction order.

Within a process every entry of the port's mesh names one device
(``parallel/mesh.py``). The runner therefore

1. runs the dense forward and backward once, over the global batch, on
   that device: GSPMD's partitioned program for one device. That keeps
   JAX's semantics where running each entry's batch shard in turn would
   not: BatchNorm statistics are the global batch's (GSPMD all-reduces
   them inside the forward), the masked loss is ``sum(l·m)/sum(m)``
   over the global batch (not a mean of per-shard means, which differ
   when the padded rows fall in the last shard), and dropout masks are
   drawn for the global batch;
2. holds as separate per-entry tensors what the JAX runner places per
   device: each optimizer slot ZeRO-split by ``state_shardings``
   (``parallel/zero.ZeroOptimizer``: one torch optimizer over every
   entry's slice of every split parameter, a slot tensor a slice);
   ``NamedSharding`` is the one place data crosses between entries;
3. runs the update on the shards: entry e takes its slice of the global
   gradient (the reduce-scatter's result), applies the zoo's optimizer
   with its own slots and writes its slice of the replicated parameter
   in place (the all-gather); parameters whose slots no dim splits are
   updated once. A learning-rate schedule reaches every entry through
   the one optimizer.

Over a mesh that spans processes (``parallel/multihost.py``, one process
per card), each process's batch is its rows of the global batch
(``place_batch`` through ``multihost.make_global_batch``), and the state
and the model's layers it makes or places carry the mesh's
``multihost.GlobalBatch`` (``multihost.attach``): the forward and
backward run on the process's rows, BatchNorm's statistics are
all-reduced in the forward, each process's masked loss is weighed by its
share of the global mask count and the weighted losses and the gradients
are all-reduced before the apply (``core/step.py``), so every process
applies the same update, and each process steps its own entries' ZeRO
slices, all-gathered after the apply (``parallel/zero.py``). A live
resize over such a mesh raises, as in the JAX package: a multi-process
job changes its membership by the instance manager's gang restart
(``master/instance_manager.py``), every process relaunched under its
original id and resumed from the job's ``torch.distributed.checkpoint``
checkpoint.

Beside it, the reference's sync semantics (SURVEY.md §2.7):

- sync SGD ``grads_to_wait`` → ``accum_steps`` gradient accumulation:
  the optimizer applies every ``accum_steps`` calls, with the mean of
  the window's gradients;
- async staleness LR modulation → ``staleness_modulation=True``:
  microbatch j of a window of k is weighted 1/(k - j), normalised by the
  harmonic sum (the reference's lr/staleness).

BatchNorm statistics move with every microbatch of an accumulation
window, independently of the delayed optimizer apply, and keep their
old values after a batch with padded rows, as in the JAX runner
(``core/step.py``'s guard).

``resize`` moves the state to another mesh without a disk round trip
(``parallel/reshard.py``). Steps are memoised per (kind, loss function,
mesh), so a runner back on a mesh it has trained on reuses its steps.
Nothing reads a value back from the card: the accumulation window's
count is a host int.

A rule that splits a parameter (a ``tp``/``mp`` rule, or a table over
the 2 MB threshold row-split over the data axis: an ``Embedding``'s, a
``DenseFeatures``' or an ``nn.Embedding``'s) places it: the runner
records the sharding on the parameter's module (``_placed``, read by
``parallel/tensor_parallel``), the parameter holds the process's block
of it (the whole tensor on one process), and its slots are placed
alike. The layers that read a placed parameter compute each local
entry's share (the transformer's Megatron layers, the vocabulary- and
row-split lookups); a split across processes of a parameter whose
module does not read its placement raises (a plain ``nn.Embedding``
reads its table whole: a model builds such a table as a
``tensor_parallel.PlacedEmbedding``). A leaf may split two dims (the
experts' ``P("ep", None, "tp")``): it is placed, gathered for a
checkpoint and split again like a one-dim leaf. Over processes, a
gradient is summed over the processes that read other data and hold
the same shard of its parameter: the data axes (every axis but ``tp``,
``mp``, ``ep``) that its spec does not name. A mesh without the data
axis (the ``sp`` ring's) keeps every slot whole; on a dp × sp mesh the
ring runs over the global batch and the slots split over dp, as in JAX
(``tests/test_torch_mesh_runner.py`` holds the two runners together
there).
"""

from typing import Callable, Dict, Optional

import torch

from elasticdl_tpu_torch.callbacks import seek_lr_schedule
from elasticdl_tpu_torch.core import step as step_lib
from elasticdl_tpu_torch.core.train_state import (
    TrainState,
    init_train_state,
    statistic_buffers,
)
from elasticdl_tpu_torch.embedding import partition as partition_lib
from elasticdl_tpu_torch.parallel import mesh as mesh_lib
from elasticdl_tpu_torch.parallel import multihost
from elasticdl_tpu_torch.parallel import rules as rules_lib
from elasticdl_tpu_torch.parallel import tensor_parallel
from elasticdl_tpu_torch.parallel.zero import ZeroOptimizer, whole_slots



def _tree_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


class MeshRunner:
    """The Worker ``step_runner`` interface over a Mesh."""

    def __init__(self, mesh: Optional[mesh_lib.Mesh] = None,
                 data_axis: str = "dp", accum_steps: int = 1,
                 param_rule=None, batch_rule=None,
                 staleness_modulation: bool = False,
                 param_rule_factory=None):
        self.mesh = mesh if mesh is not None else mesh_lib.make_mesh()
        self.data_axis = data_axis
        self.accum_steps = accum_steps
        self.staleness_modulation = staleness_modulation
        # Optional (path, leaf) -> PartitionSpec for batch leaves; the
        # default is the leading dim over the data axis.
        self.batch_rule = batch_rule
        # Rules bake the mesh (axis sizes decide what divides), so
        # resize re-derives them from a factory; a bare param_rule is
        # kept as it is across resizes.
        # The ``nn.Embedding`` table names of the runner's model
        # (``partition.table_names``), set when it meets the model.
        self._tables = frozenset()
        if param_rule_factory is None and param_rule is None:
            param_rule_factory = self._table_rule
        self._param_rule_factory = param_rule_factory
        self.param_rule = param_rule
        self._bind(self.mesh)
        self._make_optimizer = None
        # Keyed on the loss function OBJECT (the memo pins it alive; an
        # id() could be recycled) and the mesh. The accumulation path is
        # not memoised: it carries a window across calls.
        self._step_memo: Dict = {}

    def _memoized(self, kind, fn_key, builder):
        key = (kind, fn_key, self.mesh)
        step = self._step_memo.get(key)
        if step is None:
            step = builder()
            self._step_memo[key] = step
        return step

    # ---- sharding rules ------------------------------------------------

    def _table_rule(self, mesh):
        """The default rule on ``mesh``: the 2 MB table rule over the
        data axis, for the tables of the runner's model."""
        return partition_lib.embedding_partition_rule(
            axis=self.data_axis, axis_size=mesh.shape.get(self.data_axis, 1),
            tables=self._tables)

    def _meet(self, model):
        """Take ``model`` as the runner's: its table names, the rule
        re-derived for them where they changed."""
        tables = partition_lib.table_names(model)
        if tables != self._tables:
            self._tables = tables
            self._bind(self.mesh)

    def _slot_sharding(self, name, leaf) -> mesh_lib.NamedSharding:
        """A parameter's slots: its rule's spec where that places it and
        fits, else ZeRO over the data axis (replicated on a mesh without
        one)."""
        spec = self.param_rule(name, leaf)
        if (any(a is not None for a in spec)
                and rules_lib.spec_fits(spec, leaf, self.mesh)):
            return mesh_lib.NamedSharding(self.mesh, spec)
        if self.data_axis not in self.mesh.shape:
            return mesh_lib.replicated(self.mesh)
        return mesh_lib.shard_leaf_over_axis(self.mesh, leaf, self.data_axis)

    def _check_placement(self, shardings, model=None):
        """Refuse what the port does not run: slots of an unplaced
        parameter on any axis but the data axis, and a parameter split
        across processes whose module does not read its placement (it
        would read its block as the whole)."""
        modules = dict(model.named_modules()) if model is not None else {}
        for name, sharding in shardings.items():
            if sharding.is_replicated:
                continue
            if name.startswith("opt_state."):
                param = shardings.get("params." + name[len("opt_state."):])
                if (param is None or param.is_replicated) and any(
                        a != self.data_axis for d in sharding.dims
                        for a in sharding.axes_of(d)):
                    raise NotImplementedError(
                        f"{name} split over {sharding.spec}: ZeRO splits "
                        f"slots over the data axis {self.data_axis!r}")
            elif name.startswith("params.") and sharding.spans_processes:
                owner = modules.get(name[len("params."):].rpartition(".")[0])
                if not getattr(owner, "reads_placed", False):
                    raise NotImplementedError(
                        f"{name} split across processes by "
                        f"{sharding.spec}: its module "
                        f"{type(owner).__name__} reads it whole (build "
                        "a table as tensor_parallel.PlacedEmbedding)")

    def param_shardings(self, model) -> Dict[str, mesh_lib.NamedSharding]:
        """{parameter name: NamedSharding} by the rule, fitted to the
        mesh (an axis it lacks, or one that does not divide, replicates
        that dim) and read off the parameters' whole shapes (a placed
        parameter holds its block)."""
        def rule(name, leaf):
            return rules_lib.fit_spec(self.param_rule(name, leaf), leaf,
                                      self.mesh)

        return partition_lib.tree_shardings(_whole_params(model), self.mesh,
                                            rule)

    def state_shardings(self, state) -> Dict[str, mesh_lib.NamedSharding]:
        """{checkpoint leaf name: NamedSharding}: ``params.<n>`` by the
        rule (replicated unless a rule places it), ``opt_state.<n>``
        (every slot of parameter n) by the rule where it places n, else
        ZeRO over the data axis;
        ``batch_stats``, ``step`` and ``rng`` replicated. The forward
        reads each parameter whole from the one device."""
        rep = mesh_lib.replicated(self.mesh)
        named = _whole_params(state.model)
        out = {"step": rep, "rng": rep}
        params = self.param_shardings(state.model)
        out.update({f"params.{n}": s for n, s in params.items()})
        out.update({f"batch_stats.{n}": rep for n in state.batch_stats})
        out.update({f"opt_state.{n}": self._slot_sharding(n, p)
                    for n, p in named.items()})
        self._check_placement(out, state.model)
        return out

    def _slot_shardings(self, model):
        shardings = self.state_shardings(
            TrainState(model=model, optimizer=None, generator=None,
                       batch_stats=statistic_buffers(model)))
        return {n: shardings[f"opt_state.{n}"]
                for n, _ in model.named_parameters()}

    def _zero(self, model, slots=None) -> ZeroOptimizer:
        return ZeroOptimizer(dict(model.named_parameters()),
                             self._make_optimizer, self._slot_shardings(model),
                             slots=slots, placed=_placed_names(model))

    def _place_params(self, model):
        """Record each parameter's placement on its module and hold a
        parameter split across processes as the process's block; a
        parameter no rule splits is whole (back from another mesh's
        placement on one process), after the placement is checked.
        Returns the shardings."""
        self._slot_shardings(model)
        shardings = self.param_shardings(model)
        modules = dict(model.named_modules())
        for name, sharding in shardings.items():
            owner, _, leaf = name.rpartition(".")
            module = modules[owner]
            placed = getattr(module, "_placed", None)
            if placed is None:
                placed = module._placed = {}
            if sharding.is_replicated:
                placed.pop(leaf, None)
                continue
            placed[leaf] = sharding
            param = getattr(module, leaf)
            if sharding.spans_processes and tuple(param.shape) == tuple(
                    module._whole_shapes[leaf]):
                setattr(module, leaf, torch.nn.Parameter(
                    sharding.local_block(param.detach()).clone(),
                    requires_grad=param.requires_grad))
        return shardings

    def _attach(self, state, shardings):
        """``multihost.attach``, and the group each gradient is summed
        over: the data axes its parameter's spec does not name."""
        multihost.attach(state, self.mesh, (self.data_axis, "sp"))
        if state.global_batch is not None:
            data = [a for a in self.mesh.axis_names
                    if a not in tensor_parallel.MODEL_AXES]
            state.global_batch.grad_groups = {
                name: self.mesh.group([a for a in data if a not in {
                    x for d in s.dims for x in s.axes_of(d)}])
                for name, s in shardings.items()}
        return state

    def batch_shardings(self, batch):
        """The batch tree's NamedShardings: ``batch_rule`` fitted per
        leaf where the runner has one, else the leading dim over the
        data axis (where it divides)."""
        mesh = self.mesh

        def sharding(path, leaf):
            spec = (self.batch_rule(path, leaf) if self.batch_rule
                    else rules_lib.PartitionSpec(self.data_axis))
            return mesh_lib.NamedSharding(
                mesh, rules_lib.fit_spec(spec, leaf, mesh))

        return _tree_with_path(sharding, batch)

    # ---- runner interface ---------------------------------------------

    def init_state(self, model, tx, example_batch=None,
                   seed: int = 0) -> TrainState:
        """The train state of ``model`` (moved to the mesh's device) with
        the optimizer ``tx`` ZeRO-placed on the mesh. ``example_batch``
        is accepted for the JAX signature: a torch module already has
        its shapes."""
        model = model.to(self.mesh.device)
        self._make_optimizer = tx
        self._meet(model)
        _note_whole_shapes(model)
        shardings = self._place_params(model)
        return self._attach(
            init_train_state(model, lambda _: self._zero(model), seed=seed),
            shardings)

    def place_batch(self, batch):
        """This process's rows of the global batch on the mesh's device
        (``multihost.make_global_batch``: the whole global batch for one
        process, whose dense step runs it there whole;
        ``batch_shardings`` says how JAX lays it out)."""
        return multihost.make_global_batch(batch, self.mesh)

    def place_task(self, batches):
        """A stacked task ({k: (T, B, ...)}) on the mesh's device."""
        return multihost.make_global_batch(batches, self.mesh)

    def place_state(self, state):
        """Re-place ``state`` onto this runner's mesh, in place: its model
        on the mesh's device, its optimizer's slots (whole, as a restore
        into a plain optimizer lands them, or split for another mesh)
        split for this one. A state already placed here is returned as
        it is."""
        if self._make_optimizer is None:
            raise RuntimeError(
                "MeshRunner.init_state must run before place_state")
        state.model.to(self.mesh.device)
        self._meet(state.model)
        _note_whole_shapes(state.model)
        self._attach(state, self._place_params(state.model))
        shardings = self._slot_shardings(state.model)
        optimizer = state.optimizer
        if (isinstance(optimizer, ZeroOptimizer)
                and optimizer.shardings == shardings):
            return state
        state.optimizer = self._zero(state.model,
                                     whole_slots(optimizer, state.model))
        seek_lr_schedule(state.optimizer, state.step)
        return state

    def _bind(self, mesh: mesh_lib.Mesh):
        """Point the runner at ``mesh``, its rules re-derived for it."""
        self.mesh = mesh
        if self._param_rule_factory is not None:
            self.param_rule = self._param_rule_factory(mesh)

    def _adopt(self, model):
        """``place_fn`` of a resize that rebuilds the model: ``model``
        (built for the new mesh) takes the state's parameters, buffers
        and slots; the state changes only once all of that is built."""
        def place(state):
            slots = whole_slots(state.optimizer, state.model)
            model.to(self.mesh.device).load_state_dict(
                state.model.state_dict())
            self._meet(model)
            _note_whole_shapes(model)
            shardings = self._place_params(model)
            optimizer = self._zero(model, slots)
            state.model, state.optimizer = model, optimizer
            state.batch_stats = statistic_buffers(model)
            self._attach(state, shardings)
            seek_lr_schedule(optimizer, state.step)
            return state

        return place

    def resize(self, new_mesh: mesh_lib.Mesh, state=None, model=None):
        """Move to ``new_mesh`` without a disk round trip
        (``parallel/reshard.live_reshard``): the rules re-derived for
        the new mesh and checked, then the slots gathered from the old
        entries and split for the new ones on the device. ``model``: the
        model rebuilt for the new mesh (a mesh-aware model,
        ``ModelSpec.make_model``); it takes the state's parameters and
        buffers. On a failure the runner and the state stay on the old
        mesh and the error is raised. Returns the state, or None when
        called before ``init_state`` (which then lands on the new mesh).
        Steps built for the old mesh must be rebuilt (the memo keeps
        each mesh's); a partial accumulation window does not survive.
        Call at a step boundary."""
        from elasticdl_tpu_torch.parallel import reshard as reshard_lib

        refuse_process_resize(self.mesh, new_mesh)
        old_mesh = self.mesh
        try:
            self._bind(new_mesh)
            if state is None:
                return None

            def check(s):
                self._slot_shardings(model if model is not None
                                     else s.model)

            def undo(s):
                self._bind(old_mesh)
                self.place_state(s)

            place = self.place_state if model is None else self._adopt(model)
            return reshard_lib.live_reshard(state, check, place, undo)
        except Exception:
            self._bind(old_mesh)
            raise

    def train_step(self, loss_fn: Callable) -> Callable:
        """``(state, batch) -> (state, metrics)``; with ``accum_steps``
        > 1 each call is one microbatch of the window."""
        if self.accum_steps > 1:
            return self._accum_train_step(loss_fn)
        return self._memoized("train", loss_fn,
                              lambda: step_lib.build_train_step(loss_fn))

    def _accum_train_step(self, loss_fn: Callable) -> Callable:
        accum_steps = self.accum_steps
        if self.staleness_modulation:
            def weight_of(count):
                return 1.0 / (accum_steps - count)
            norm = float(sum(1.0 / (accum_steps - j)
                             for j in range(accum_steps)))
        else:
            def weight_of(count):
                return 1.0
            norm = float(accum_steps)
        call_loss = step_lib._call_loss(loss_fn)
        apply = step_lib.build_apply_gradients()
        window = {"grads": None, "count": 0}

        def micro_step(state, batch):
            # The statistics move with the microbatch (guarded), the
            # weights at the window's apply.
            loss = step_lib._loss_and_grads(call_loss, state, batch)
            grads = step_lib._take_grads(state)
            w = weight_of(window["count"])
            acc = window["grads"]
            window["grads"] = (
                {k: w * g for k, g in grads.items()} if acc is None
                else {k: acc[k] + w * g for k, g in grads.items()})
            window["count"] += 1
            if window["count"] >= accum_steps:
                mean = {k: g / norm for k, g in window["grads"].items()}
                state = apply(state, mean, 1.0)
                window["grads"], window["count"] = None, 0
            return state, {"loss": loss}

        return micro_step

    def train_multi_step(self, loss_fn: Callable) -> Callable:
        """A whole task's minibatches (stacked with a leading T dim) in
        one call (``core.step.build_multi_step``); the plain path only."""
        return self._memoized("multi", loss_fn,
                              lambda: step_lib.build_multi_step(loss_fn))

    def eval_step(self) -> Callable:
        return self._memoized("eval", None, step_lib.build_eval_step)


def refuse_process_resize(old_mesh, new_mesh):
    """A live resize to or from a mesh that spans processes raises, as in
    the JAX package: its workers ack the barrier as a no-op, and a
    multi-process job changes its membership by the instance manager's
    gang restart from a checkpoint."""
    if (getattr(old_mesh, "spans_processes", False)
            or getattr(new_mesh, "spans_processes", False)):
        raise NotImplementedError(
            "a live resize of a mesh that spans processes: a multi-process "
            "job changes its membership by a gang restart (the instance "
            "manager relaunches every process under its original id, "
            "each resuming from the job's torch.distributed.checkpoint "
            "checkpoint), not by a live resize")


def make_runner_for_spec(spec, mesh: Optional[mesh_lib.Mesh] = None,
                         data_axis: str = "dp", accum_steps: int = 1,
                         **kwargs) -> MeshRunner:
    """A MeshRunner wired to a ModelSpec's layout extras: the zoo
    module's ``param_sharding_rules()`` regexes (fitted to each mesh,
    with the 2 MB embedding rule as the fallback) and its
    ``batch_sharding_rule``. Modules without the extras get the plain
    data-parallel layout."""
    mesh = mesh if mesh is not None else mesh_lib.make_mesh()
    runner = MeshRunner(
        mesh=mesh, data_axis=data_axis, accum_steps=accum_steps,
        batch_rule=getattr(spec, "batch_sharding_rule", None), **kwargs)
    if getattr(spec, "param_sharding_rules", None) is not None:
        rules = spec.param_sharding_rules()
        fallback_for = runner._table_rule

        def param_rule_factory(m, rules=rules):
            return rules_lib.regex_param_rule(rules, mesh=m,
                                              fallback=fallback_for(m))

        runner._param_rule_factory = param_rule_factory
        runner._bind(mesh)
    return runner


def _note_whole_shapes(model):
    """Each module's parameters' whole shapes, kept where a parameter
    is later held as its block (``_whole_shapes``)."""
    for module in model.modules():
        shapes = module.__dict__.setdefault("_whole_shapes", {})
        for leaf, param in module.named_parameters(recurse=False):
            placed = getattr(module, "_placed", {}).get(leaf)
            if placed is None or not placed.spans_processes:
                shapes[leaf] = tuple(param.shape)


def _whole_params(model) -> Dict[str, torch.Tensor]:
    """``{name: parameter}``, a parameter held as its block stood in for
    by a meta tensor of its whole shape (what the rules read)."""
    out = {}
    for prefix, module in model.named_modules():
        shapes = getattr(module, "_whole_shapes", {})
        for leaf, param in module.named_parameters(recurse=False):
            name = f"{prefix}.{leaf}" if prefix else leaf
            shape = shapes.get(leaf, tuple(param.shape))
            out[name] = (param if shape == tuple(param.shape) else
                         torch.empty(shape, dtype=param.dtype, device="meta"))
    return out


def _placed_names(model) -> set:
    """The names of the parameters a runner placed split."""
    return {f"{prefix}.{leaf}" if prefix else leaf
            for prefix, module in model.named_modules()
            for leaf in getattr(module, "_placed", {})}
