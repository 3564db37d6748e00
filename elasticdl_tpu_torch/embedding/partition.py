"""Auto-partition pass: which tables a mesh would row-shard (port of
elasticdl_tpu/embedding/partition.py).

``embedding_partition_rule`` is the JAX rule over the port's parameter
names: a parameter is a shardable table iff its name ends in the
``Embedding`` layer's table name (``embedding``), it is 2-D, its row
count divides the mesh axis, and it exceeds the threshold. The rule
gives a ``PartitionSpec``: ``P(axis, None)`` for a table sharded by
rows, ``P()`` for a replicated parameter. ``parallel/mesh_runner``
places the parameters' optimizer slots by these specs.
"""

from typing import Callable, Dict, Optional

import torch

from elasticdl_tpu_torch.parallel import multihost
from elasticdl_tpu_torch.embedding.layer import EMBEDDING_PARAM_NAME
from elasticdl_tpu_torch.parallel.mesh import NamedSharding
from elasticdl_tpu_torch.parallel.rules import PartitionSpec

# The reference's 2 MB rule (model_handler.py:85-89).
DEFAULT_PARTITION_THRESHOLD_BYTES = 2 * 1024 * 1024


def embedding_partition_rule(
    threshold_bytes: int = DEFAULT_PARTITION_THRESHOLD_BYTES,
    axis: str = "dp",
    axis_size: Optional[int] = None,
    tables: frozenset = frozenset(),
) -> Callable[[str, torch.Tensor], tuple]:
    """A ``(parameter name, tensor) -> spec`` rule; ``tables``: more
    parameter names that are tables (a model's ``table_names``)."""

    def rule(name: str, tensor: torch.Tensor) -> tuple:
        shape = tuple(tensor.shape)
        if (
            (name.split(".")[-1] == EMBEDDING_PARAM_NAME or name in tables)
            and len(shape) == 2
            and tensor.numel() * tensor.element_size() > threshold_bytes
            and (axis_size is None or shape[0] % axis_size == 0)
        ):
            return PartitionSpec(axis, None)
        return PartitionSpec()

    return rule


def partition_specs(model: torch.nn.Module, rule) -> Dict[str, tuple]:
    """``{parameter name: rule(name, parameter)}`` over ``model``."""
    return tree_partition_specs(dict(model.named_parameters()), rule)


def tree_partition_specs(named: Dict[str, torch.Tensor], rule
                         ) -> Dict[str, PartitionSpec]:
    """The rule over ``{name: leaf}`` (the port's parameter names stand
    for the JAX pytree paths)."""
    return {name: rule(name, leaf) for name, leaf in named.items()}


def tree_shardings(named: Dict[str, torch.Tensor], mesh, rule
                   ) -> Dict[str, NamedSharding]:
    """Same, as ``NamedSharding``s on ``mesh``."""
    return {name: NamedSharding(mesh, rule(name, leaf))
            for name, leaf in named.items()}


def table_names(model: torch.nn.Module) -> frozenset:
    """The parameter names of ``model``'s ``nn.Embedding`` tables."""
    return frozenset(
        f"{prefix}.weight" if prefix else "weight"
        for prefix, module in model.named_modules()
        if isinstance(module, torch.nn.Embedding))


def _block_rows(block: torch.Tensor, sharding, ids: torch.Tensor):
    """This process's rows of ``ids`` (ids flat): each local entry's
    shard reads the ids in its rows, zeros elsewhere, summed."""
    rows = block.shape[0] // len(sharding.local_shards)
    out = None
    for shard, index in zip(sharding.block_views(block),
                            sharding.local_shards):
        local = ids.long() - index * rows
        inside = (local >= 0) & (local < rows)
        part = shard[torch.where(inside, local, 0)] * inside[
            ..., None].to(shard.dtype)
        out = part if out is None else out + part
    return out


class _DataSplitRows(torch.autograd.Function):
    """``lookup_rows`` over a data axis across processes."""

    @staticmethod
    def forward(ctx, block, ids, sharding, group):
        every = multihost.all_gather(ids.reshape(-1), group)
        partial = _block_rows(block, sharding, every)
        total = multihost.all_reduce_sum(partial, group)
        n = ids.numel()
        ctx.save_for_backward(every)
        ctx.sharding, ctx.group, ctx.shape = sharding, group, block.shape
        start = group.position * n
        return total[start:start + n].reshape(tuple(ids.shape)
                                              + (block.shape[1],))

    @staticmethod
    def backward(ctx, grad):
        (every,) = ctx.saved_tensors
        grads = multihost.all_gather(
            grad.reshape(-1, ctx.shape[1]).contiguous(), ctx.group)
        sharding = ctx.sharding
        rows = ctx.shape[0] // len(sharding.local_shards)
        local = every.long() - sharding.local_shards[0] * rows
        inside = (local >= 0) & (local < ctx.shape[0])
        out = torch.zeros(ctx.shape, dtype=grads.dtype, device=grads.device)
        out.index_add_(0, local[inside], grads[inside])
        return out, None, None, None


def lookup_rows(block: torch.Tensor, sharding, ids) -> torch.Tensor:
    """Rows of a table split by rows under ``sharding`` (the parameter
    holds the process's block of it, the whole table on one process):
    ``table[ids]`` with a trailing row dim, read over the shards as the
    module docstring says."""
    from elasticdl_tpu_torch.parallel.tensor_parallel import (
        MODEL_AXES,
        reduce_from,
    )

    if list(sharding.dims) != [0]:
        raise NotImplementedError(
            f"a table is read split by rows, not by {sharding.spec}")
    ids = torch.as_tensor(ids, device=block.device)
    group = sharding.group()
    model_split = all(a in MODEL_AXES for a in sharding.axes_of(0))
    if group.size < 2 or model_split:
        rows = _block_rows(block, sharding, ids.reshape(-1)).reshape(
            tuple(ids.shape) + (block.shape[1],))
        return reduce_from(rows, group) if model_split else rows
    return _DataSplitRows.apply(block, ids, sharding, group)
