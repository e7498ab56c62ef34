"""Nested containers of tensors ("trees") in ``jax.tree.flatten``'s leaf
order: dict values by sorted key, list and tuple items in order, a
dataclass's fields in declaration order.  The optimizer walks parameters
in this order and checkpoints store leaves in it, so a checkpoint written
by the JAX package restores here and the reverse."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

Treedef = Tuple  # ("leaf",) | ("dict", keys, defs) | ("seq", type, defs) | ("dc", cls, names, defs)


def tree_flatten(tree: Any) -> Tuple[List[Any], Treedef]:
    """``(leaves, treedef)``; ``tree_unflatten(treedef, leaves)`` rebuilds."""
    leaves: List[Any] = []

    def walk(x) -> Treedef:
        if isinstance(x, dict):
            keys = sorted(x)
            return ("dict", keys, [walk(x[k]) for k in keys])
        if isinstance(x, (list, tuple)):
            return ("seq", type(x), [walk(v) for v in x])
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            names = [f.name for f in dataclasses.fields(x)]
            return ("dc", type(x), names, [walk(getattr(x, n)) for n in names])
        leaves.append(x)
        return ("leaf",)

    return leaves, walk(tree)


def tree_unflatten(treedef: Treedef, leaves: List[Any]) -> Any:
    """The tree of ``treedef`` with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(d: Treedef):
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        if kind == "seq":
            return d[1](build(c) for c in d[2])
        return d[1](**{n: build(c) for n, c in zip(d[2], d[3])})

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in flatten order."""
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every leaf."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(x) for x in leaves])
