"""Frozen arithmetic: peaks of one NVIDIA H100 SXM, the bytes and
operations of one launch of the port's kernels, and the model FLOPs of
the benchmark's cells.

The kernel formulas are copies of ``chip_smoke.py``'s bound formulas (K1,
K2: ``na_kernels_on``; K4: ``k4_bound``); the LM FLOPs follow the dry
run's accounting (``repro_torch/launch/dryrun.py``) with the benchmark's
own rules written out below.  They are copies, not imports, so that a
later change to the port cannot move the yardstick.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12  # float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12


def bound_s(nbytes: float, flops: float, flop_per_s: float = FP32_FLOP_PER_S) -> float:
    """Least seconds the card could take: bytes over HBM bandwidth or
    operations over the peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_per_s)


# ----------------------------------------------------------- K1, K2 ----
def k1_launch(num_edges: int, num_blocks: int, num_tiles: int, num_src: int,
              num_dst: int, d: int) -> Tuple[float, float]:
    """``(bytes, flops)`` of one K1 launch (``na_seg_sum_f32``) over a
    packing at width ``d``: per edge a 16-bit source, a 16-bit
    destination and a float32 weight; each feature row read once and each
    output row written once; the blocks' bands, counts and the tile list.
    The same for the source-major launch of the backward (rows and
    columns swap) and for the width-1 launch."""
    meta = num_blocks * 4 * 2 + num_blocks * 4 + (num_tiles + 1) * 4
    nbytes = num_edges * (2 + 2 + 4) + num_src * d * 4 + num_dst * d * 4 + meta
    return float(nbytes), 2.0 * num_edges * d


def k2_launch(num_edges: int, num_blocks: int, num_tiles: int,
              num_dst: int) -> Tuple[float, float]:
    """``(bytes, flops)`` of one K2 launch (``na_softmax_stats_f32``):
    per edge a 16-bit destination and a float32 logit, the blocks'
    metadata, and the float32 ``(m, s)`` written per destination."""
    nbytes = (num_edges * (2 + 4) + num_blocks * 4 + num_blocks * 4
              + (num_tiles + 1) * 4 + num_dst * 8)
    return float(nbytes), 6.0 * num_edges


def na_train_launches(graphs: List[Dict], d: int, layers: int) -> List[Tuple[str, float]]:
    """``(kernel, bound seconds)`` of every K1 and K2 launch of one
    attention-model train step, in launch order: per layer and graph the
    forward's K2 then K1 at width ``d``; then, graphs and layers in
    reverse, each attention call's backward: K1 at width 1 (the softmax's
    row sums) then K1 over the source-major view at width ``d``.
    ``graphs`` hold ``edges, blocks, tiles, num_src, num_dst``."""
    fwd, bwd = [], []
    for _ in range(layers):
        for g in graphs:
            e, nb, nt, ns, nd = (g[k] for k in ("edges", "blocks", "tiles", "num_src", "num_dst"))
            fwd.append(("K2", bound_s(*k2_launch(e, nb, nt, nd))))
            fwd.append(("K1", bound_s(*k1_launch(e, nb, nt, ns, nd, d))))
            bwd.append([("K1", bound_s(*k1_launch(e, nb, nt, ns, nd, 1))),
                        ("K1", bound_s(*k1_launch(e, nb, nt, ns, nd, d)))])
    return fwd + [x for pair in reversed(bwd) for x in pair]


# ---------------------------------------------------------------- K4 ----
def k4_pairs(s: int, t: int, causal: bool, window: Optional[int] = None) -> int:
    """Live (query, key) pairs of one head."""
    if not causal:
        return s * t
    w = window or s  # row i sees min(i + 1, w) keys
    return w * (w + 1) // 2 + (s - w) * w


def k4_launch(b: int, hq: int, hkv: int, s: int, t: int, dqk: int, dv: int,
              causal: bool, window: Optional[int] = None) -> Tuple[float, float]:
    """``(bytes, flops)`` of one bf16 K4 call: the live pairs' two products,
    and q, k, v and the output read or written once."""
    flops = 2.0 * k4_pairs(s, t, causal, window) * (dqk + dv) * hq * b
    nbytes = 2.0 * (b * hq * s * dqk + b * hkv * t * dqk + b * hkv * t * dv + b * hq * s * dv)
    return nbytes, flops


def k4_bound_s(*args, **kw) -> float:
    """Least seconds of one bf16 K4 call at bf16's tensor-core peak."""
    nbytes, flops = k4_launch(*args, **kw)
    return bound_s(nbytes, flops, BF16_FLOP_PER_S)


# ------------------------------------------------------- HGNN FLOPs ----
def hgnn_flops(num_vertices: Dict[str, int], feature_dims: Dict[str, int], target: str,
               graphs: List[Dict], hidden: int, layers: int, att_dim: int,
               classes: int, train: bool) -> float:
    """Counted FLOPs of one Simple-HGN forward, or of one train step, in
    the port's structure: every type's feature projection (FP) every layer
    (a featureless type projects a ones column), per semantic graph the
    source projection, the two attention dots, the edge softmax (6 an
    edge, K2's count) and the aggregation (2 d an edge), semantic fusion
    (SF) per type, and the head.  A multiply-add counts 2.

    A train step adds the backward of the work that reaches the loss:
    twice the forward for every product whose input needs a gradient and
    once (the weight's gradient alone) for the first layer's projection
    of the raw features; the edge work twice.  Work of types whose hidden
    states never reach the target's logits has no backward."""
    h = hidden
    fwd = bwd = 0.0
    types = sorted(num_vertices)
    for layer in range(layers):
        for t in types:
            n = num_vertices[t]
            d_in = (feature_dims.get(t) or 1) if layer == 0 else h
            fp = 2.0 * n * d_in * h + n * h
            fwd += fp
            # every metapath ends at the target: only its chain has a backward
            if t == target:
                bwd += fp if layer == 0 else 2 * fp
        for g in graphs:
            e, ns, nd = g["edges"], g["num_src"], g["num_dst"]
            proj = 2.0 * ns * h * h
            dots = 2.0 * ns * h + 2.0 * nd * h
            edge = 6.0 * e + 2.0 * e * h
            fwd += proj + dots + edge
            bwd += 2 * (proj + dots + edge)
        for t in types:
            n = num_vertices[t]
            into = sum(1 for g in graphs if g["dst_type"] == t)
            sf = 2.0 * n * h * h  # the self path
            if into:
                p = into + 1
                sf += 2.0 * p * n * h * att_dim + 2.0 * p * n * att_dim + 2.0 * p * n * h
            fwd += sf
            if t == target:
                bwd += 2 * sf
    head = 2.0 * num_vertices[target] * h * classes
    fwd += head
    bwd += 2 * head
    return fwd + bwd if train else fwd


# --------------------------------------------------------- LM FLOPs ----
def lm_forward_flops(cfg: Dict, batch: int, seq: int, head_rows: Optional[int] = None) -> float:
    """Model FLOPs of one forward of an attention + MoE (or MLP) stack:
    per token the q, k, v and output projections, the router and the
    top-k experts' SwiGLU (or the dense MLP); per sequence the causal
    attention's live pairs (two products of the head dim each); and the
    LM head over ``head_rows`` rows a sequence (all by default) at the
    true vocabulary.  A multiply-add counts 2."""
    d, hq, hkv, dh = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    tokens = batch * seq
    per_layer = 2.0 * d * dh * (2 * hq + 2 * hkv) * tokens
    per_layer += 2.0 * k4_pairs(seq, seq, True) * 2 * dh * hq * batch
    if cfg.get("num_experts"):
        per_layer += 2.0 * d * cfg["num_experts"] * tokens
        per_layer += 3 * 2.0 * d * cfg["moe_d_ff"] * cfg["experts_per_token"] * tokens
    else:
        per_layer += 3 * 2.0 * d * cfg["d_ff"] * tokens
    rows = seq if head_rows is None else head_rows
    return per_layer * cfg["num_layers"] + 2.0 * d * cfg["vocab_size"] * rows * batch


def lm_train_flops(cfg: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: three times the forward (the
    backward's two products a forward product), with no credit for the
    recompute that remat adds."""
    return 3.0 * lm_forward_flops(cfg, batch, seq)
