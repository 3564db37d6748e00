"""Regex name → partition spec rules for parameter layout (port of
elasticdl_tpu/parallel/rules.py).

A model (or model-zoo module) ships a list of ``(name_regex,
PartitionSpec)`` pairs mapping parameter names to mesh axes. First
matching rule wins; no match = replicated. The JAX rules search pytree
paths (``decoder/attn/query/kernel``); here they search ``path_str`` of
the port's parameter names, the torch dots written as slashes
(``blocks/0/attn/query/weight``), so a rule reads the same in both
packages up to the leaf's own name.

The same rule places the optimizer state: each slot of a parameter
takes the parameter's rule (the reference parameter server co-locates a
table's slots with it, ``ps/parameters.py:156``).
"""

import re
from typing import Callable, Optional, Sequence, Tuple


class PartitionSpec(tuple):
    """One entry per leading dim of a leaf: a mesh axis name, a tuple of
    axis names (the dim split over their product), or ``None``
    (replicated along that dim); dims past the end are replicated. As
    ``jax.sharding.PartitionSpec``: ``PartitionSpec("dp", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"

    def normalized(self) -> tuple:
        """The entries without trailing ``None``s: two specs that place
        a leaf alike compare equal in this form."""
        entries = list(self)
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)


P = PartitionSpec


def path_str(path) -> str:
    """A parameter name (``"a.b.weight"``) or a sequence of keys as the
    JAX rules' ``/``-joined path (``"a/b/weight"``)."""
    if isinstance(path, str):
        return path.replace(".", "/")
    return "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                    for p in path)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def spec_fits(spec: PartitionSpec, leaf, mesh) -> bool:
    """A spec is usable iff every named axis exists in the mesh, the spec
    rank does not exceed the leaf rank, and each sharded dim divides."""
    shape = _shape(leaf)
    if len(spec) > len(shape):
        return False
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        size = 1
        for a in _axes(entry):
            if a not in mesh.shape:
                return False
            size *= mesh.shape[a]
        if shape[dim] % size != 0:
            return False
    return True


def fit_spec(spec: PartitionSpec, leaf, mesh) -> PartitionSpec:
    """Clamp a spec to what the mesh and leaf support, dim by dim: axes
    missing from the mesh or not dividing the dim become None."""
    shape = _shape(leaf)
    out = []
    for dim, entry in enumerate(tuple(spec)[: len(shape)]):
        if entry is None:
            out.append(None)
            continue
        size, ok = 1, True
        for a in _axes(entry):
            if a not in mesh.shape:
                ok = False
                break
            size *= mesh.shape[a]
        out.append(entry if ok and shape[dim] % size == 0 else None)
    return PartitionSpec(*out)


def regex_param_rule(
    rules: Sequence[Tuple[str, PartitionSpec]],
    mesh=None,
    fallback: Optional[Callable] = None,
) -> Callable:
    """A ``(name, leaf) -> PartitionSpec`` rule from regex pairs.

    With ``mesh``, the first matching spec is fitted per dim
    (``fit_spec``), so a ``tp`` rule on a dp-only mesh replicates that
    dim. ``fallback`` handles names no rule matched (default:
    replicate)."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def rule(path, leaf):
        name = path_str(path)
        for rx, spec in compiled:
            if rx.search(name):
                return fit_spec(spec, leaf, mesh) if mesh else spec
        if fallback is not None:
            return fallback(path, leaf)
        return PartitionSpec()

    return rule
