"""GFP sub-stage primitives: Feature Projection, Neighbor Aggregation,
Semantic Fusion.

Two NA families live here, as in the JAX package:

* the segment-sum primitives (``na_mean`` / ``edge_softmax_weights`` /
  ``na_attention``) take global ``(src, dst)`` edge index tensors and run
  plain PyTorch segment ops (``segment_sum``, ``gather``, ``scatter_reduce``
  "amax") — the layout-agnostic oracle path, the reference's
  ``na_executor="jnp"``;
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


def segment_order(seg: torch.Tensor, n: int):
    """``(order, lengths)`` of the segment ids ``seg`` over ``n`` segments:
    a stable sort of ``seg`` (each segment's positions in index order) and
    each segment's length.  Memoised on the ``seg`` tensor, as a packing
    memoises its views: a graph's edge lists are built once and read by
    every NA call."""
    memo = getattr(seg, "_segment_order", None)
    if memo is None or memo[0] != n:
        lengths = torch.bincount(seg, minlength=n)
        if lengths.numel() != n:
            raise ValueError(f"segment ids reach {lengths.numel() - 1}, beyond {n} segments")
        memo = (n, torch.sort(seg, stable=True).indices, lengths)
        seg._segment_order = memo
    return memo[1], memo[2]


class _SegmentSum(torch.autograd.Function):
    """``out[i] = sum of x[e] over the e with seg[e] == i``, each segment
    summed in index order (``segment_order``), with no float atomics: on
    the CPU bitwise ``index_add_``, which adds in index order too; on a CUDA
    device the same bits from run to run, where ``index_add_`` adds by
    atomics in whatever order the threads arrive.  Backward: the gather
    ``g[seg]``."""

    @staticmethod
    def forward(ctx, x, seg, n):
        order, lengths = segment_order(seg, n)
        ctx.save_for_backward(seg)
        return torch.segment_reduce(x[order], "sum", lengths=lengths, axis=0, unsafe=True)

    @staticmethod
    def backward(ctx, g):
        (seg,) = ctx.saved_tensors
        return gather(g, seg), None, None


class _Gather(torch.autograd.Function):
    """``x[idx]`` whose backward is ``segment_sum`` over ``idx``, not
    autograd's accumulating ``index_put_``."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[0]
        return x[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return segment_sum(g, idx, ctx.n), None


def segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Rows of ``x`` summed into ``n`` segments by ``seg`` (the reference's
    ``jax.ops.segment_sum``), deterministic on every device
    (``_SegmentSum``); differentiable in ``x``."""
    return _SegmentSum.apply(x, seg, n)


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]``, differentiable with a deterministic backward (``_Gather``)."""
    return _Gather.apply(x, idx)


def na_mean(
    h_src: torch.Tensor,  # (N_src, D) projected source features
    src: torch.Tensor,  # (E,) int64
    dst: torch.Tensor,  # (E,) int64
    num_dst: int,
) -> torch.Tensor:
    """RGCN-style NA: degree-normalized sum of neighbour features."""
    summed = segment_sum(gather(h_src, src), dst, num_dst)
    deg = segment_sum(torch.ones_like(dst, dtype=torch.float32), dst, num_dst)
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
    ex = torch.exp(logits - gather(m, dst))
    s = segment_sum(ex, dst, num_dst)
    return ex / torch.clamp(gather(s, dst), min=1e-9)


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
    logits = gather(h_src @ a_src, src) + gather(h_dst @ a_dst, dst)
    if edge_bias is not None:
        logits = logits + edge_bias
    logits = torch.nn.functional.leaky_relu(logits, leaky_slope)
    alpha = edge_softmax_weights(logits, dst, num_dst)
    return segment_sum(gather(h_src, src) * alpha[:, None], dst, num_dst)


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
