"""ZeRO placement of a torch optimizer's state over a mesh.

The JAX ``MeshRunner`` gives every optimizer-state leaf a sharding (the
parameter's rule, else ``shard_leaf_over_axis``: the first dim the data
axis divides) and XLA partitions the update: each device applies the
optimizer to its slice of the parameter with its slice of the slots and
of the reduce-scattered gradient, then the slices are all-gathered into
the replicated parameter. ``ZeroOptimizer`` does the same with one torch
optimizer, the zoo's (``make_optimizer``), built over every entry's
slice of every split parameter and over the parameters no dim splits:

- entry ``e``'s slice of a split parameter is a view of it
  (``NamedSharding.views``), so the apply writes the slice back in
  place, which is the all-gather on the one device; the optimizer keys
  its state by that view, so each entry's slice has slot tensors of its
  own;
- a step hands each view its slice of the global gradient (the
  reduce-scatter's result, again a view);
- parameters whose slots no dim splits are updated whole, once.

This is exact only for an optimizer whose update is elementwise (the
slice of the update is the update of the slice), so other optimizers are
refused: under GSPMD the JAX program stays right whatever the optimizer,
here a global-norm clip per entry would not. A
``callbacks.LearningRateScheduler`` folded into ``make_optimizer``
reaches every entry through the one optimizer it builds.

Across processes (a mesh that spans them, ``parallel/multihost.py``)
each process holds and steps only its own entries' slices, with the
all-reduced global gradient; then the updated slices are all-gathered
over the group of the slots' axis (the data axis) in one collective a
dtype, so every process holds the same replicated parameters.
Parameters no dim splits are updated whole in every process, from the
same gradient and slots.

A parameter that a rule places (``placed``: a ``tp`` rule, a table over
2 MB) has its slots placed alike, as JAX reuses the rule over the optax
tree (``mu`` of ``wi`` on the same spec); the parameter holds the
process's block of it, its views are the local entries' shards of that
block, and nothing is gathered after the step: the parameter stays
split.

The checkpoint names the slots as it names a plain optimizer's:
``opt_state.<parameter name>.<slot>``, the entries' slices gathered
(``named_slots``), so a dp4 state saves the leaves of the same state at
dp1 and restores at any mesh (``restore_plan``).
"""

from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from elasticdl_tpu_torch.parallel.mesh import NamedSharding, ShardedTensor

# Torch optimizers whose update of an element reads only that element
# of the parameter, its gradient and its slots (and scalars).
ELEMENTWISE = (
    torch.optim.SGD, torch.optim.Adam, torch.optim.AdamW,
    torch.optim.Adagrad, torch.optim.RMSprop, torch.optim.Adamax,
    torch.optim.NAdam, torch.optim.RAdam, torch.optim.Adadelta,
)


class ZeroOptimizer:
    """A torch optimizer's update and state split over the entries of a
    mesh; ``step``/``zero_grad`` as a torch optimizer's.

    ``named_params``: the model's ``{name: parameter}`` (the whole
    parameters the forward reads); ``shardings``: each name's slot
    placement (``MeshRunner.state_shardings``); ``slots``: whole slot
    values by name (``{name: {slot: tensor}}``) to start from, e.g. the
    gathered state of another mesh; ``placed``: the names of the
    parameters a rule splits (held as the process's block, their slots
    placed by the same sharding)."""

    def __init__(self, named_params: Dict[str, torch.nn.Parameter],
                 make_optimizer: Callable, shardings: Dict[str, NamedSharding],
                 slots: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                 placed=()):
        self.params = dict(named_params)
        self.shardings = {n: shardings[n] for n in self.params}
        self.placed = frozenset(placed)
        split = [n for n in self.params
                 if not self.shardings[n].is_replicated]
        self.num_entries = max(
            [self.shardings[n].num_shards for n in split] or [1])
        # Local entry e's slice of each split parameter, a view of it
        # (of its block where it is placed).
        self._views = {
            n: (self.shardings[n].block_views(self.params[n].detach())
                if n in self.placed
                else self.shardings[n].views(self.params[n].detach()))
            for n in split}
        self.num_local = max([len(v) for v in self._views.values()] or [1])
        # The ZeRO-split parameters whose slices other processes step.
        self._gathered = [n for n in split if n not in self.placed
                          and self.shardings[n].spans_processes]
        whole = [p for n, p in self.params.items() if n not in self._views]
        # The inner optimizer over each local entry's views in turn, then
        # the whole parameters.
        self.inner = make_optimizer(
            [views[e] for e in range(self.num_local)
             for views in self._views.values() if e < len(views)] + whole)
        if split and not isinstance(self.inner, ELEMENTWISE):
            raise NotImplementedError(
                f"ZeRO placement of {type(self.inner).__name__}'s state: "
                "its update is not known to be elementwise, so an entry "
                "cannot apply it to its slice alone"
            )
        if slots:
            self._load_whole(slots)

    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ZeroOptimizer.step takes no closure")
        for name, views in self._views.items():
            grad = self.params[name].grad
            sharding = self.shardings[name]
            grads = ([None] * len(views) if grad is None
                     else sharding.block_views(grad) if name in self.placed
                     else sharding.views(grad))
            for view, g in zip(views, grads):
                view.grad = g
        self.inner.step()
        if self._gathered:
            self._gather_slices()

    def _gather_slices(self):
        """Every process's updated slices into the replicated
        parameters: its block of each ZeRO-split parameter (its entries'
        slices, adjacent along the split dim) flattened, one all-gather
        a dtype over the slots' group, the other members' blocks copied
        in place."""
        from elasticdl_tpu_torch.parallel import multihost

        by_key = {}
        for name in self._gathered:
            group = self.shardings[name].group()
            by_key.setdefault((self._views[name][0].dtype, group.ranks),
                              (group, []))[1].append(name)
        with torch.no_grad():
            for group, names in by_key.values():
                blocks = {n: torch.cat(self._views[n], self.shardings[n].dim)
                          .movedim(self.shardings[n].dim, 0) for n in names}
                flat = torch.cat([b.reshape(-1) for b in blocks.values()])
                gathered = multihost.all_gather(flat, group).view(
                    -1, flat.numel())
                for q in range(gathered.shape[0]):
                    if q == group.position:
                        continue
                    offset = 0
                    for n, block in blocks.items():
                        dim, rows = self.shardings[n].dim, block.shape[0]
                        part = gathered[q, offset:offset + block.numel()]
                        offset += block.numel()
                        self.params[n].detach().narrow(
                            dim, q * rows, rows).copy_(
                            part.view(block.shape).movedim(0, dim))

    def zero_grad(self, set_to_none: bool = True):
        self.inner.zero_grad(set_to_none=set_to_none)
        for p in self.params.values():
            if p.grad is None:
                continue
            if set_to_none:
                p.grad = None
            else:
                p.grad.zero_()

    # ---- the state as whole leaves -------------------------------------

    def named_slots(self) -> Iterator[Tuple[str, str, object]]:
        """``(parameter name, slot, value)`` in the model's order: a
        split slot as a ``ShardedTensor`` of the entries' tensors, a
        scalar slot (``step``) as entry 0's (every entry's is equal)."""
        state = self.inner.state
        for name, p in self.params.items():
            if name not in self._views:
                for slot, value in state.get(p, {}).items():
                    yield name, slot, value
                continue
            views = self._views[name]
            per_entry = [state.get(v, {}) for v in views]
            for slot, value in per_entry[0].items():
                values = [s[slot] for s in per_entry]
                if (isinstance(value, torch.Tensor)
                        and value.shape == views[0].shape and value.dim()):
                    yield name, slot, ShardedTensor(self.shardings[name],
                                                    values)
                else:
                    yield name, slot, value

    def restore_plan(self, saved: Dict[str, Dict[str, np.ndarray]]
                     ) -> Iterator[Tuple[str, torch.Tensor, Dict]]:
        """Split whole saved slots (``{name: {slot: array}}``) over the
        inner optimizer's tensors: yields ``(name, tensor, {slot: its
        part})`` for each whole parameter and each entry's view; a
        scalar slot goes whole to every view."""
        for name, p in self.params.items():
            slots = saved.get(name, {})
            if name not in self._views:
                yield name, p, slots
                continue
            sharding = self.shardings[name]
            for e, view in enumerate(self._views[name]):
                yield name, view, {
                    slot: (np.asarray(value)[sharding.whole_slices(
                        np.shape(value))[e]] if np.ndim(value) else value)
                    for slot, value in slots.items()}

    def _load_whole(self, slots: Dict[str, Dict[str, torch.Tensor]]):
        """Install whole slot tensors (on any device) as the inner
        optimizer's own tensors on the parameters' device."""
        state = self.inner.state
        for name, p in self.params.items():
            for slot, value in slots.get(name, {}).items():
                if name not in self._views:
                    state[p][slot] = _placed(value, p)
                    continue
                views = self._views[name]
                parts = (self.shardings[name].views(value) if value.dim()
                         else [value] * len(views))
                for view, part in zip(views, parts):
                    state[view][slot] = _placed(part, view)


def _placed(value: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """A slot of ``param`` as a tensor of its own: beside the parameter,
    except a 0-d step, which stays where it was (torch keeps it on the
    CPU unless the optimizer is fused or capturable)."""
    if value.dim() == 0:
        return value.detach().clone()
    return torch.empty(value.shape, dtype=value.dtype,
                       device=param.device).copy_(value)


class WholeSlots:
    """An optimizer's slots held whole by parameter name, on any device:
    what a state carries between two placements
    (``parallel/reshard.gather_to_host``)."""

    def __init__(self, slots: Dict[str, Dict[str, torch.Tensor]]):
        self.slots = slots


def whole_slots(optimizer, model: torch.nn.Module
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{parameter name: {slot: whole tensor}}`` of a plain torch
    optimizer over ``model``'s parameters, of a ``ZeroOptimizer`` (its
    split slots gathered) or of ``WholeSlots``."""
    if isinstance(optimizer, WholeSlots):
        return optimizer.slots
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    if isinstance(optimizer, ZeroOptimizer):
        for name, slot, value in optimizer.named_slots():
            if isinstance(value, ShardedTensor):
                value = value.gather()
            out.setdefault(name, {})[slot] = value
        return out
    for name, p in model.named_parameters():
        state = optimizer.state.get(p)
        if state:
            out[name] = dict(state)
    return out
