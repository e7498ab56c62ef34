"""Plain float32 reference of Simple-HGN full-graph training on a
metapath-composed heterogeneous graph.

It composes each metapath's semantic graph itself, from the one-hop
relations, by boolean products of dense 0/1 matrices; it runs the model
over global ``(src, dst)`` edge lists with plain segment operations (no
restructuring, no packing, no kernels of the port); it differentiates
the masked cross-entropy with autograd and applies its own AdamW.  Every
matrix product goes through ``precision.matmul``, so the same code in a
lower precision is the control that a correct run must beat.

Only the target type's chain is computed: with every metapath ending at
the target type, the other types' hidden states never reach the logits,
and their parameters get a zero gradient.  Parameters are a nested dict
with the port's keys (``layers[l]["fp" | "na" | "sf" | "edge_emb" |
"a_edge"]``, ``head``), so one tree feeds both sides.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from reference.precision import matmul
from reference.tree import leaves, rebuild

LEAKY_SLOPE = 0.2


def compose(relations: Dict[str, Tuple], num_vertices: Dict[str, int],
            metapath: str, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The semantic graph of ``metapath`` (e.g. ``"APTPA"``): ``(src,
    dst)`` int64 on ``device``, sorted by ``(src, dst)``, one edge for
    every pair joined by at least one path.  Boolean products of dense
    0/1 matrices: exact, since every term is non-negative (bfloat16 on
    the card, float32 on the CPU, float32 accumulation either way)."""
    dt = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32

    def dense(name):
        s, d = relations[name]
        m = torch.zeros((num_vertices[name[0]], num_vertices[name[1]]), dtype=dt,
                        device=device)
        m[torch.as_tensor(s, device=device).long(), torch.as_tensor(d, device=device).long()] = 1
        return m

    acc = dense(metapath[:2])
    for i in range(1, len(metapath) - 1):
        acc = (torch.matmul(acc, dense(metapath[i:i + 2])) > 0).to(dt)
    src, dst = torch.nonzero(acc, as_tuple=True)
    return src, dst


def degree_bucket_labels(graphs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                         num_target: int, num_classes: int) -> torch.Tensor:
    """Quantile buckets of each target vertex's summed in-degree over the
    semantic graphs (the port's ``degree_bucket_labels``, in numpy on the
    host for its quantiles), int64 on the graphs' device."""
    import numpy as np

    deg = np.zeros(num_target, np.float64)
    for _, dst in graphs:
        deg += np.bincount(dst.cpu().numpy(), minlength=num_target)
    qs = np.quantile(deg, np.linspace(0, 1, num_classes + 1)[1:-1])
    return torch.from_numpy(np.digitize(deg, qs)).to(graphs[0][1].device)


def _attention_na(h_src, h_dst, src, dst, a_src, a_dst, edge_bias, mode):
    """Edge-softmax aggregation over one semantic graph."""
    n = h_dst.shape[0]
    logits = matmul(h_src, a_src, mode)[src] + matmul(h_dst, a_dst, mode)[dst] + edge_bias
    logits = torch.nn.functional.leaky_relu(logits, LEAKY_SLOPE)
    m = logits.new_full((n,), -torch.inf).scatter_reduce(0, dst, logits, "amax",
                                                         include_self=False)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ex = torch.exp(logits - m[dst])
    s = torch.zeros(n, dtype=ex.dtype, device=ex.device).index_add(0, dst, ex)
    alpha = ex / torch.clamp(s[dst], min=1e-9)
    return torch.zeros((n, h_src.shape[1]), dtype=h_src.dtype,
                       device=h_src.device).index_add(0, dst, h_src[src] * alpha[:, None])


def logits(params: Dict, x: torch.Tensor, graphs: List[Tuple[str, torch.Tensor, torch.Tensor]],
           target: str, mode: str = "float32") -> torch.Tensor:
    """Simple-HGN logits of every target vertex.  ``x`` is the target
    type's features; ``graphs`` the ``(metapath, src, dst)`` semantic
    graphs into the target type, in sorted metapath order (their index is
    the edge-type id)."""
    h = x
    for lp in params["layers"]:
        fp = lp["fp"][target]
        hp = torch.relu(matmul(h, fp["w"], mode) + fp["b"])
        zs = []
        for i, (mp, src, dst) in enumerate(graphs):
            na = lp["na"][mp]
            h_src = matmul(hp, na["w_rel"], mode)
            bias = matmul(lp["edge_emb"][i][None], lp["a_edge"], mode)[0]
            zs.append(_attention_na(h_src, hp, src, dst, na["a_src"], na["a_dst"], bias, mode))
        sf = lp["sf"][target]
        stack = torch.stack(zs + [matmul(hp, sf["w_self"], mode)])
        score = matmul(torch.tanh(matmul(stack, sf["w"], mode) + sf["b"]), sf["q"], mode)
        beta = torch.softmax(score.mean(dim=1), dim=0)
        h = torch.relu((beta[:, None, None] * stack).sum(0))
    head = params["head"]
    return matmul(h, head["w"], mode) + head["b"]


def masked_nll(out: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the masked rows."""
    nll = -torch.gather(torch.log_softmax(out, dim=-1), 1, labels.long()[:, None])[:, 0]
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)


def adamw(p, g, m, v, step: int, lr: float, b1=0.9, b2=0.95, eps=1e-8, wd=0.0):
    """One AdamW update of one leaf (decay on matrices only); new (p, m, v)."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    delta = (m / (1 - b1 ** step)) / (torch.sqrt(v / (1 - b2 ** step)) + eps)
    if p.dim() >= 2:
        delta = delta + wd * p
    return p - lr * delta, m, v


def train(params: Dict, x: torch.Tensor, graphs, target: str, labels, mask,
          steps: int, lr: float, mode: str = "float32", wd: float = 0.0) -> dict:
    """``steps`` full-graph AdamW steps from ``params``: ``{"losses": [...],
    "grads": first step's gradient per leaf, "params": the leaves after
    the last step}`` (leaves in ``leaves`` order).

    It runs with PyTorch's deterministic algorithms, so that two runs on
    one device agree bit for bit: with atomic adds, the round-off of the
    attention vectors' cancelling gradients can flip an element's sign,
    which Adam's first step turns into a full learning-rate step."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _train(params, x, graphs, target, labels, mask, steps, lr, mode, wd)
    finally:
        torch.use_deterministic_algorithms(was)


def _train(params, x, graphs, target, labels, mask, steps, lr, mode, wd) -> dict:
    flat = [t.detach().to(torch.float32) for t in leaves(params)]
    m = [torch.zeros_like(t) for t in flat]
    v = [torch.zeros_like(t) for t in flat]
    losses, first = [], None
    for k in range(1, steps + 1):
        live = [t.clone().requires_grad_(True) for t in flat]
        loss = masked_nll(logits(rebuild(params, live), x, graphs, target, mode), labels, mask)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(flat, grads)]
        losses.append(float(loss.detach()))
        if first is None:
            first = [g.detach() for g in grads]
        with torch.no_grad():
            for i, g in enumerate(grads):
                flat[i], m[i], v[i] = adamw(flat[i], g, m[i], v[i], k, lr, wd=wd)
        del live, loss, grads
    return {"losses": losses, "grads": first, "params": flat}
