"""Pipeline parallelism: GPipe over a ``pp`` mesh axis (port of
elasticdl_tpu/parallel/pipeline.py).

Every ``pp`` entry holds one pipeline stage's parameters: a stage-stacked
dict of tensors, one leading dim of size ``pp`` (``stack_stage_params``).
``M`` microbatches enter at stage 0 and leave the last stage; the
schedule is plain GPipe fill-drain, ``M + n - 1`` ticks for ``n``
stages, bubble fraction ``(n - 1) / (M + n - 1)``.

- **One process** (every entry of the mesh this process's): the stages
  are the ``pp`` entries on the one device, run in tick order: at tick
  ``t`` stage ``s`` takes microbatch ``t - s``. Each microbatch goes
  once through each stage over all its rows (the ``dp`` entries of a
  microbatch share the device, as the port's dense step runs the
  global batch once), and autograd differentiates the schedule.
- **``pp`` across processes**: each process holds its block of the
  stages (the stacked leaves are its block, ``k`` stages long) and runs
  them on each microbatch in turn. Activations go to the next stage's
  process by send/recv over the ``pp`` group (``multihost.send``/
  ``recv``, as ``multihost.ring_shift`` moves the ring's blocks); the
  last stage's outputs are broadcast over the group, so every process
  holds the result, as JAX's global array is every process's. The
  backward is the reverse pipeline (``_PipelineAcross``): the last
  stage takes its own output gradient, each stage sends its input
  gradient to the previous one, and the first stage's input gradient
  is broadcast over the group, so a replicated input (the embedding's
  output, computed in every process) gets the same gradient in every
  process.
- **A data axis across processes** (``x_spec``'s rows split over
  processes): ``x`` is this process's rows. Each group of processes
  that share a data coordinate runs the pipeline over its own ``pp``
  group (``mesh.group([axis])``: the sends, receives and both
  broadcasts use that group's ranks), or, where ``pp`` is inside one
  process, runs the stages in tick order as on one card. Summing the
  gradients over the data group is the caller's (``models/
  pipeline_lm.py``'s train step).

The JAX program computes every stage at every tick, bubble ticks
included, on values it then discards (drain ticks re-feed ``x[m-1]``);
none of them reaches the result or a gradient, so the port computes no
bubble tick.
"""

from typing import Callable, Dict, List, Optional

import torch

from elasticdl_tpu_torch.parallel.rules import PartitionSpec


def stack_stage_params(init_fn: Callable, rng, n_stages: int
                       ) -> Dict[str, torch.Tensor]:
    """``n_stages`` independent stages as one stacked dict: each leaf
    gets a leading stage dim. ``init_fn(rng) -> {name: tensor}``
    initialises one stage; ``rng`` (a ``torch.Generator``) is drawn on
    in stage order."""
    stages = [init_fn(rng) for _ in range(n_stages)]
    return {name: torch.stack([stage[name] for stage in stages])
            for name in stages[0]}


def stages_of(stacked: Dict[str, torch.Tensor]
              ) -> List[Dict[str, torch.Tensor]]:
    """Each stage (of the leaves as held) of a stacked dict, the leaves
    unbound once: every microbatch's use of a stage reads the same
    views, so autograd sums their gradients into one buffer a stage and
    stacks them once (indexing a leaf at each use would allocate a
    whole leaf's gradient at each)."""
    per = {name: leaf.unbind(0) for name, leaf in stacked.items()}
    count = len(next(iter(per.values()))) if per else 0
    return [{name: views[s] for name, views in per.items()}
            for s in range(count)]


def pipeline_apply(
    stage_fn: Callable,
    stacked_params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    mesh,
    axis: str = "pp",
    x_spec: Optional[PartitionSpec] = None,
) -> torch.Tensor:
    """Run ``x`` through ``n = mesh.shape[axis]`` pipeline stages.

    - ``stage_fn(stage_params, act) -> act``: one stage (it may run
      several layers); the activation keeps its shape and dtype.
    - ``stacked_params``: ``{name: tensor}``, each with the leading
      stage dim: ``n`` long, or this process's block of the stages
      where ``axis`` spans processes.
    - ``x``: ``(M, mb, ...)``, M microbatches.
    - ``x_spec``: ``x``'s placement; dim 0, the microbatch index, must
      be unsharded (``P(None, "dp", ...)`` composes dp with pp).

    Returns the ``(M, mb, ...)`` outputs (stage ``n - 1`` applied last).
    """
    spec = tuple(x_spec if x_spec is not None else PartitionSpec())
    if spec[:1] not in ((None,), ()):
        raise ValueError("x_spec dim 0 (microbatch index) must be None")
    n = mesh.shape[axis]
    group = mesh.group([axis])
    if group.size > 1:
        leaves = list(stacked_params.values())
        graph = torch.is_grad_enabled() and (
            x.requires_grad or any(leaf.requires_grad for leaf in leaves))
        return _PipelineAcross.apply(
            x, stage_fn, mesh, axis, graph, list(stacked_params), *leaves)
    m = x.shape[0]
    acts = list(x.unbind(0))
    stages = stages_of(stacked_params)
    for tick in range(m + n - 1):
        for stage in range(n):
            j = tick - stage
            if 0 <= j < m:
                acts[j] = stage_fn(stages[stage], acts[j])
    return torch.stack(acts)


class _PipelineAcross(torch.autograd.Function):
    """The schedule of this process's stages where ``pp`` spans
    processes, and its reverse. Each microbatch's local graph is built
    in the forward (over detached copies of the input and the stage
    leaves) and differentiated in the backward, microbatch by
    microbatch, in one fixed order in every process, so the sends and
    receives pair up on any backend."""

    @staticmethod
    def forward(ctx, x, stage_fn, mesh, axis, graph, names, *leaves):
        from elasticdl_tpu_torch.parallel import multihost

        group = mesh.group([axis])
        lo, hi = mesh.axis_block(axis)
        n = mesh.shape[axis]
        pos = group.position
        first, last = lo == 0, hi == n
        m = x.shape[0]
        # ``graph``: whether the caller differentiates (no graph is
        # kept for a forward under no_grad).
        with torch.set_grad_enabled(graph):
            held = [leaf.detach().requires_grad_(leaf.requires_grad)
                    for leaf in leaves]
            stages = stages_of(dict(zip(names, held)))
            graphs, outs, pending = [], [], []
            for j in range(m):
                if first:
                    a_in = x[j].detach().requires_grad_(x.requires_grad)
                else:
                    a_in = multihost.recv(
                        x.shape[1:], x.dtype, x.device,
                        group.ranks[pos - 1], group, tag=j)
                    a_in.requires_grad_(graph)
                a = a_in
                for stage in stages:
                    a = stage_fn(stage, a)
                if not last:
                    pending.append(multihost.send(
                        a.detach(), group.ranks[pos + 1], group, tag=j))
                else:
                    outs.append(a.detach())
                if graph:
                    graphs.append((a_in, a))
            for work in pending:
                work.wait()
        y = (torch.stack(outs) if last
             else torch.empty_like(x))
        y = multihost.broadcast(y, group.ranks[-1], group)
        ctx.graphs, ctx.held = graphs, held
        ctx.group, ctx.first, ctx.last = group, first, last
        ctx.x_meta = (x.shape, x.dtype, x.device)
        return y

    @staticmethod
    def backward(ctx, grad_y):
        from elasticdl_tpu_torch.parallel import multihost

        group, first, last = ctx.group, ctx.first, ctx.last
        shape, dtype, device = ctx.x_meta
        pos = group.position
        m = shape[0]
        params = [h for h in ctx.held if h.requires_grad]
        sums = [None] * len(params)
        grad_x = torch.zeros(shape, dtype=dtype, device=device)
        pending = []
        for j in reversed(range(m)):
            a_in, a = ctx.graphs[j]
            if last:
                g = grad_y[j]
            else:
                g = multihost.recv(a.shape, a.dtype, a.device,
                                   group.ranks[pos + 1], group, tag=m + j)
            wants = ([a_in] if a_in.requires_grad else []) + params
            got = (torch.autograd.grad(a, wants, g, allow_unused=True)
                   if a.requires_grad else [None] * len(wants))
            if a_in.requires_grad:
                g_in, got = got[0], got[1:]
                if g_in is None:
                    g_in = torch.zeros_like(a_in)
                if first:
                    grad_x[j] = g_in
                else:
                    pending.append(multihost.send(
                        g_in, group.ranks[pos - 1], group, tag=m + j))
            for i, g_p in enumerate(got):
                if g_p is not None:
                    sums[i] = g_p if sums[i] is None else sums[i] + g_p
            ctx.graphs[j] = None
        for work in pending:
            work.wait()
        grad_x = multihost.broadcast(grad_x, group.ranks[0], group)
        out = iter(sums)
        leaf_grads = [next(out) if h.requires_grad else None
                      for h in ctx.held]
        return (grad_x, None, None, None, None, None, *leaf_grads)


def microbatch(batch: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """(B, ...) -> (M, B/M, ...) for pipeline input."""
    return batch.reshape((num_microbatches,
                          batch.shape[0] // num_microbatches)
                         + tuple(batch.shape[1:]))


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    """(M, mb, ...) -> (M*mb, ...)."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))
