"""The comparisons that decide `correct`.

Training is compared by numbers over the first three steps: the largest
relative gap of a step's loss; by the worst leaf or the median leaf, the
gap of the first gradient's norm as the optimizer gets it; and, by the
worst leaf or the median leaf, the gap of the norm of the parameters'
change after the three steps.  A leaf's gap is ``|program norm -
reference norm|`` over the reference's norm of that leaf or of the median
leaf, whichever is larger (the median over leaves whose reference
gradient is not exactly zero).  Leaves whose reference gradient is under
a thousandth of the median leaf's move by round-off alone and are left
out of the change and of the median leaves; what the rule leaves out is
decided by the reference, never by a leaf's name.
"""
from __future__ import annotations

import statistics
from typing import List, Sequence

import torch

MOVED_FRACTION = 1e-3  # a leaf moves if its reference gradient reaches this share of the median


def norms(tensors: Sequence[torch.Tensor]) -> List[float]:
    """Each tensor's float32 L2 norm."""
    return [float(torch.linalg.vector_norm(t.detach().to(torch.float32))) for t in tensors]


def _median_nonzero(values: Sequence[float]) -> float:
    live = [v for v in values if v > 0]
    return statistics.median(live) if live else 0.0


def moved(ref_grad_norms: Sequence[float]) -> List[bool]:
    """Which leaves the reference moves: gradient norm at least
    ``MOVED_FRACTION`` of the median leaf's."""
    med = _median_nonzero(ref_grad_norms)
    return [g > 0 and g >= MOVED_FRACTION * med for g in ref_grad_norms]


def worst_leaf_gap(prog: Sequence[float], ref: Sequence[float],
                   include: Sequence[bool] = None) -> float:
    """Largest ``|prog - ref| / max(ref, median ref)`` over the included
    leaves (0 with none)."""
    if len(prog) != len(ref):
        raise ValueError(f"{len(prog)} program leaves against {len(ref)} reference leaves")
    include = include if include is not None else [True] * len(ref)
    med = _median_nonzero([r for r, keep in zip(ref, include) if keep])
    gaps = [abs(p - r) / max(r, med, 1e-30) for p, r, keep in zip(prog, ref, include) if keep]
    return max(gaps, default=0.0)


def leaf_gaps(prog: Sequence[float], ref: Sequence[float],
              include: Sequence[bool] = None) -> List[float]:
    """Each included leaf's gap (see ``worst_leaf_gap``), in leaf order;
    ``nan`` for a leaf left out."""
    include = include if include is not None else [True] * len(ref)
    med = _median_nonzero([r for r, keep in zip(ref, include) if keep])
    return [abs(p - r) / max(r, med, 1e-30) if keep else float("nan")
            for p, r, keep in zip(prog, ref, include)]


def loss_gaps(prog: Sequence[float], ref: Sequence[float]) -> List[float]:
    """Each step's relative loss gap."""
    return [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref)]


def train_checks(prog: dict, ref: dict, loss_steps: int = None) -> dict:
    """The training numbers from ``{"losses", "grad_norms",
    "change_norms"}`` of each side: the loss gap (the largest over the
    first ``loss_steps`` steps, all by default), the gradient's gap and
    the change's gap, each at the worst leaf and at the median leaf (of
    the leaves the reference moves).  A cell compares those its limits
    name."""
    keep = moved(ref["grad_norms"])
    grad = leaf_gaps(prog["grad_norms"], ref["grad_norms"], keep)
    change = leaf_gaps(prog["change_norms"], ref["change_norms"], keep)
    return {
        "loss_gap": max(loss_gaps(prog["losses"], ref["losses"])[:loss_steps]),
        "grad_norm_gap": worst_leaf_gap(prog["grad_norms"], ref["grad_norms"]),
        "median_grad_gap": statistics.median([g for g, k in zip(grad, keep) if k] or [0.0]),
        "update_norm_gap": max((g for g, k in zip(change, keep) if k), default=0.0),
        "median_update_gap": statistics.median([g for g, k in zip(change, keep) if k] or [0.0]),
    }
