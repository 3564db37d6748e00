"""Tensor parallelism inside the port's layers: Megatron's ``f`` and
``g`` and the vocabulary gather, over a ``multihost.Group``.

The JAX package places parameters by rule and lets GSPMD partition the
program. The port runs the partitioned program by hand: a layer whose
weight a rule splits over ``tp`` (``MeshRunner`` records the placement
on the module, ``placement``; an unplaced one is ``WHOLE``, one entry)
computes each local entry's share of it, entry by entry, and meets the
other entries through these functions:

- ``copy_to``: identity forward, all-reduce backward (``f``): the input
  of a column-parallel layer. Within a process the entries read one
  tensor, so autograd sums their input gradients; the function then
  sums over the processes of the group.
- ``reduce_from``: all-reduce forward, identity backward (``g``): the
  output of a row-parallel layer (the entries' partial products summed
  in the process first) and of the vocabulary-parallel embedding.
- ``gather_last``: the processes' blocks joined along the last dim, the
  backward taking this process's slice: the ``lm_head``'s logits, split
  over the vocabulary, made whole for the zoo's loss.

On a group of one process each is the identity, so one code path runs
on one process and on several.
"""

from typing import List

import torch

from elasticdl_tpu_torch.parallel import multihost

# Mesh axes that split the model; every other axis splits the data.
MODEL_AXES = ("tp", "mp", "ep")


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return multihost.all_reduce_sum(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return multihost.all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.width, ctx.position = x.shape[-1], group.position
        parts = multihost.all_gather(x.movedim(-1, 0), group)
        return parts.movedim(0, -1)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.position * ctx.width
        return grad[..., start:start + ctx.width].contiguous(), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group.size < 2 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group.size < 2 else _ReduceFrom.apply(x, group)


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    return x if group.size < 2 else _GatherLast.apply(x, group)


class _Whole:
    """The placement of a parameter no runner split: one entry, the
    whole tensor, read by this process alone. A placed layer runs its
    one code path over it."""

    dims = ()
    num_shards = 1

    def axes_of(self, dim: int) -> tuple:
        return ()

    def block_views(self, tensor: torch.Tensor) -> List[torch.Tensor]:
        return [tensor]

    def block_starts(self, dim: int, size: int) -> List[int]:
        return [0]

    def group(self):
        return multihost.Group((multihost.process_index(),))

    def __repr__(self):
        return "WHOLE"


WHOLE = _Whole()


def placement(module: torch.nn.Module, name: str):
    """The ``NamedSharding`` a runner placed ``module``'s parameter
    ``name`` by, where it splits it; ``WHOLE`` where it does not."""
    return getattr(module, "_placed", {}).get(name, WHOLE)


def entry_views(module: torch.nn.Module, name: str) -> List[torch.Tensor]:
    """Each local entry's shard of ``module``'s parameter ``name``:
    views of the parameter, which holds the process's block (the whole
    tensor on one process; the tensor itself where it is whole)."""
    return placement(module, name).block_views(getattr(module, name))


def entry_starts(module: torch.nn.Module, name: str, dim: int
                 ) -> List[int]:
    """Each local entry's first index along ``dim`` of ``module``'s whole
    parameter ``name``, in ``entry_views`` order (an expert block's first
    expert)."""
    size = getattr(module, "_whole_shapes", {}).get(
        name, tuple(getattr(module, name).shape))[dim]
    return placement(module, name).block_starts(dim, size)


def split_over(module: torch.nn.Module, name: str, dim: int):
    """``placement(module, name)`` where it is whole or splits dim
    ``dim`` alone, else None."""
    sharding = placement(module, name)
    if sharding is not WHOLE and list(sharding.dims) != [dim]:
        return None
    return sharding


class PlacedEmbedding(torch.nn.Embedding):
    """``nn.Embedding`` whose table a runner may split by rows: over
    ``tp`` (vocabulary-parallel: an entry reads zeros for the ids
    outside its block, the entries' rows are summed and all-reduced over
    the ``tp`` group) or, as a table over 2 MB, over a data axis
    (``embedding.partition.lookup_rows``). A model whose table may be
    split across processes builds it as one (the transformer's token
    embedding, the DeepFM zoo's tables); a plain ``nn.Embedding`` reads
    its table whole, so a runner refuses to split it across
    processes."""

    reads_placed = True

    def forward(self, ids):
        split = placement(self, "weight")
        if split is WHOLE:
            return super().forward(ids)
        from elasticdl_tpu_torch.embedding.partition import lookup_rows

        return lookup_rows(self.weight, split, ids)
