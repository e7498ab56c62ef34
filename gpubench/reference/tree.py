"""Nested dicts and lists of tensors, walked in sorted-key order (the
port's and JAX's leaf order), for the references and the comparisons."""
from __future__ import annotations

from typing import List

import torch


def leaves(tree) -> List[torch.Tensor]:
    """Leaves in sorted-key order (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def leaf_paths(tree, prefix: str = "") -> List[str]:
    """Each leaf's path (``layers[0]/na/APA/a_dst``), in ``leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{prefix}[{i}]")]
    return [prefix.lstrip("/")]


def rebuild(tree, flat: List[torch.Tensor]):
    """``tree``'s structure with ``flat``'s leaves in ``leaves`` order."""
    it = iter(flat)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return next(it)

    return walk(tree)
