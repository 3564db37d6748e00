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

from elasticdl_tpu_torch.embedding.layer import EMBEDDING_PARAM_NAME
from elasticdl_tpu_torch.parallel.mesh import NamedSharding
from elasticdl_tpu_torch.parallel.rules import PartitionSpec

# The reference's 2 MB rule (model_handler.py:85-89).
DEFAULT_PARTITION_THRESHOLD_BYTES = 2 * 1024 * 1024


def embedding_partition_rule(
    threshold_bytes: int = DEFAULT_PARTITION_THRESHOLD_BYTES,
    axis: str = "dp",
    axis_size: Optional[int] = None,
) -> Callable[[str, torch.Tensor], tuple]:
    """A ``(parameter name, tensor) -> spec`` rule."""

    def rule(name: str, tensor: torch.Tensor) -> tuple:
        shape = tuple(tensor.shape)
        if (
            name.split(".")[-1] == EMBEDDING_PARAM_NAME
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
