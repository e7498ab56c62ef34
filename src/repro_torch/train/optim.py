"""AdamW, global-norm clipping and the warmup-cosine schedule as plain
tensor functions, computed as the JAX package's ``repro.train.optim``
computes them (not ``torch.optim.AdamW``): b2 = 0.95, decay only on
leaves with ndim >= 2, float32 moments, an int32 step counter, and every
scalar in float32.  Functional: updates return new tensors and a new
state."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.train.tree import (flatten_up_to, tree_flatten, tree_leaves, tree_map,
                                   tree_unflatten)


@dataclasses.dataclass
class AdamWState:
    """Optimizer state; leaves in the order (step, mu, nu)."""

    step: torch.Tensor  # () int32
    mu: Any  # float32 tree shaped like the parameters
    nu: Any  # float32 tree shaped like the parameters


def adamw_init(params: Any) -> AdamWState:
    """Zero moments and step 0, on the parameters' device."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """Scale ``grads`` so that their global L2 norm is at most ``max_norm``;
    returns ``(clipped, norm before clipping)``."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), gn


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    """``lr(step)``: linear warmup over ``warmup`` steps, then a cosine
    decay to ``min_frac * base_lr`` at ``total``; float32."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(1, warmup)
        prog = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


@torch.no_grad()
def adamw_update(
    grads: Any,
    state: AdamWState,
    params: Any,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Tuple[Any, AdamWState]:
    """One AdamW step; returns ``(new params, new state)``.  A ``None``
    gradient counts as zeros (what ``jax.grad`` gives a leaf with no path
    to the loss), so such a leaf's moments decay and it is still
    weight-decayed."""
    step = state.step + 1
    sf = step.to(torch.float32)
    b1c = 1 - torch.pow(b1, sf)
    b2c = 1 - torch.pow(b2, sf)

    def upd(p, g: Optional[torch.Tensor], m, v):
        g = torch.zeros_like(m) if g is None else g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mhat = m / b1c
        vhat = v / b2c
        p32 = p.to(torch.float32)
        wd = weight_decay if p.dim() >= 2 else 0.0  # decay matrices only
        newp = p32 - lr * (mhat / (torch.sqrt(vhat) + eps) + wd * p32)
        return newp.to(p.dtype), m, v

    flat_p, treedef = tree_flatten(params)
    flat_g = flatten_up_to(treedef, grads)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, flat_g, tree_leaves(state.mu), tree_leaves(state.nu))]
    return (tree_unflatten(treedef, [o[0] for o in out]),
            AdamWState(step=step,
                       mu=tree_unflatten(treedef, [o[1] for o in out]),
                       nu=tree_unflatten(treedef, [o[2] for o in out])))
