"""Nested containers of tensors ("trees") in ``jax.tree.flatten``'s leaf
order: dict values by sorted key, list and tuple items in order, a
dataclass's fields in declaration order; ``None`` is an empty node, no
leaf, as in JAX (an LM ``TrainState`` without residuals).  The optimizer walks parameters
in this order and checkpoints store leaves in it, so a checkpoint written
by the JAX package restores here and the reverse."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

Treedef = Tuple  # ("leaf",) | ("none",) | ("dict", keys, defs) | ("seq", type, defs) | ("dc", cls, names, defs)


def tree_flatten(tree: Any) -> Tuple[List[Any], Treedef]:
    """``(leaves, treedef)``; ``tree_unflatten(treedef, leaves)`` rebuilds."""
    leaves: List[Any] = []

    def walk(x) -> Treedef:
        if x is None:
            return ("none",)
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

    treedef = walk(tree)
    del walk  # the closure refers to itself: a cycle that would hold the leaves until gc
    return leaves, treedef


def tree_unflatten(treedef: Treedef, leaves: List[Any]) -> Any:
    """The tree of ``treedef`` with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(d: Treedef):
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        if kind == "seq":
            return d[1](build(c) for c in d[2])
        return d[1](**{n: build(c) for n, c in zip(d[2], d[3])})

    out = build(treedef)
    del build  # breaks the closure's cycle, which would hold ``leaves`` until gc
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


def flatten_up_to(treedef: Treedef, tree: Any) -> List[Any]:
    """The subtrees of ``tree`` at ``treedef``'s leaves, in flatten order
    (``jax`` treedefs' ``flatten_up_to``): a tree of partition specs, or of
    gradients with ``None`` for some leaves, against the parameters'
    structure."""
    out: List[Any] = []

    def walk(d: Treedef, x) -> None:
        kind = d[0]
        if kind == "leaf":
            out.append(x)
        elif kind == "dict":
            for k, c in zip(d[1], d[2]):
                walk(c, x[k])
        elif kind == "seq":
            for c, v in zip(d[2], x):
                walk(c, v)
        elif kind == "dc":
            for n, c in zip(d[2], d[3]):
                walk(c, getattr(x, n))

    walk(treedef, tree)
    del walk  # breaks the closure's cycle, which would hold ``out`` until gc
    return out
