"""GFP sub-stage primitives: Feature Projection, Neighbor Aggregation,
Semantic Fusion.

Two NA families live here, as in the JAX package:

* the segment-sum primitives (``na_mean`` / ``edge_softmax_weights`` /
  ``na_attention``) take global ``(src, dst)`` edge index tensors and run
  plain PyTorch scatters (``index_add_``, ``scatter_reduce``) — the
  layout-agnostic oracle path, the reference's ``na_executor="jnp"``;
* the banded primitives (``na_mean_banded`` / ``na_attention_banded``)
  consume the restructurer's cached ``PackedEdges`` blocks and run the NA
  kernels (``kernels/seg_sum.py``, ``kernels/edge_softmax.py``) over
  features permuted into the renumbered banded layout — the executed form
  of the paper's GFP stage.

Both are differentiable: the first by autograd, the second through the
reference's VJPs, which the kernels' ``torch.autograd.Function``s carry.
FP and SF are dense products left to ``torch.matmul``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ops import na_attention_packed
from repro_torch.kernels.seg_sum import PackedEdges, seg_sum_na


def feature_projection(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """FP sub-stage: per-type dense projection (the MLP of §2.2)."""
    return x @ w + b


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    return x.new_zeros((n,) + tuple(x.shape[1:])).index_add_(0, seg, x)


def na_mean(
    h_src: torch.Tensor,  # (N_src, D) projected source features
    src: torch.Tensor,  # (E,) int64
    dst: torch.Tensor,  # (E,) int64
    num_dst: int,
) -> torch.Tensor:
    """RGCN-style NA: degree-normalized sum of neighbour features."""
    summed = _segment_sum(h_src[src], dst, num_dst)
    deg = _segment_sum(torch.ones_like(dst, dtype=torch.float32), dst, num_dst)
    return summed / torch.clamp(deg, min=1.0)[:, None]


def edge_softmax_weights(
    logits: torch.Tensor,  # (E,) unnormalized attention logits
    dst: torch.Tensor,  # (E,)
    num_dst: int,
) -> torch.Tensor:
    """Numerically stable softmax over each destination's in-edges."""
    m = logits.new_full((num_dst,), -torch.inf).scatter_reduce(
        0, dst, logits, "amax", include_self=False)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ex = torch.exp(logits - m[dst])
    s = _segment_sum(ex, dst, num_dst)
    return ex / torch.clamp(s[dst], min=1e-9)


def na_attention(
    h_src: torch.Tensor,  # (N_src, D)
    h_dst: torch.Tensor,  # (N_dst, D) destination-side features for logits
    src: torch.Tensor,
    dst: torch.Tensor,
    num_dst: int,
    a_src: torch.Tensor,  # (D,) attention vector, source side
    a_dst: torch.Tensor,  # (D,) attention vector, destination side
    edge_bias: Optional[torch.Tensor] = None,  # scalar edge-type term (Simple-HGN)
    leaky_slope: float = 0.2,
) -> torch.Tensor:
    """GAT-style NA (RGAT / Simple-HGN): weighted sum with edge softmax."""
    logits = (h_src @ a_src)[src] + (h_dst @ a_dst)[dst]
    if edge_bias is not None:
        logits = logits + edge_bias
    logits = torch.nn.functional.leaky_relu(logits, leaky_slope)
    alpha = edge_softmax_weights(logits, dst, num_dst)
    return _segment_sum(h_src[src] * alpha[:, None], dst, num_dst)


def na_mean_banded(
    packed: PackedEdges,
    h_src: torch.Tensor,  # (N_src, D) features in the packing's banded numbering
    deg: torch.Tensor,  # (N_dst,) in-degrees in the packing's dst numbering
) -> torch.Tensor:
    """RGCN-style NA: degree-normalized neighbour sum on kernel K1."""
    summed = seg_sum_na(packed, h_src)
    return summed / torch.clamp(deg, min=1.0)[:, None]


def na_attention_banded(
    h_src: torch.Tensor,  # (N_src, D) banded-numbered source features
    h_dst: torch.Tensor,  # (N_dst, D) banded-numbered destination features
    src: torch.Tensor,  # (E,) banded src ids, scheduled order
    dst: torch.Tensor,  # (E,) banded dst ids, scheduled order
    packed: PackedEdges,
    a_src: torch.Tensor,
    a_dst: torch.Tensor,
    edge_bias: Optional[torch.Tensor] = None,
    leaky_slope: float = 0.2,
) -> torch.Tensor:
    """GAT-style NA (RGAT / Simple-HGN) on kernels K2 and K1.

    Logits are computed per edge of the scheduled stream; the blocked
    scatter, the online ``(m, s)`` statistics and the alpha-weighted
    aggregation follow in ``kernels.ops.na_attention_packed``.
    """
    e_s = h_src @ a_src
    e_d = h_dst @ a_dst
    logits = e_s[src] + e_d[dst]
    if edge_bias is not None:
        logits = logits + edge_bias
    logits = torch.nn.functional.leaky_relu(logits, leaky_slope)
    out, _ = na_attention_packed(packed, logits, h_src)
    return out


def semantic_fusion_beta(
    z_stack: torch.Tensor,  # (P, N, D) NA outputs per semantic graph
    w: torch.Tensor,  # (D, D_att)
    b: torch.Tensor,  # (D_att,)
    q: torch.Tensor,  # (D_att,)
) -> torch.Tensor:
    """The (P,) semantic-attention weights
    ``beta_p = softmax_p(mean_v q . tanh(W z_p,v + b))``."""
    s = torch.tanh(z_stack @ w + b) @ q  # (P, N)
    return torch.softmax(torch.mean(s, dim=1), dim=0)


def semantic_fusion(
    z_stack: torch.Tensor,  # (P, N, D)
    w: torch.Tensor,
    b: torch.Tensor,
    q: torch.Tensor,
) -> torch.Tensor:
    """SF sub-stage (HAN-style semantic attention, §2.2):
    ``out = sum_p beta_p z_p``."""
    beta = semantic_fusion_beta(z_stack, w, b, q)
    return torch.einsum("p,pnd->nd", beta, z_stack)
