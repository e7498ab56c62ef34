"""NA operations over packed edge blocks, the SGB composition, and the LM
zoo's attention and SSD scan: the JAX package's ``repro.kernels.ops``.

The device of the input tensors picks the implementation: CUDA tensors go
through the hand-written kernels K1 (``seg_sum_na``), K2
(``edge_softmax_stats``), K3 (``spgemm_bsr``), K4 (``flash_attention``) and
K5 (``ssd_scan``), CPU tensors through their plain versions, and ``meta``
tensors (the dry run's, ``launch/dryrun.py``) through K4's and K5's plain
versions, which count operations without memory.  ``ATTN_IMPL`` picks the
reference's long-sequence attention route: under ``"cp_zigzag"`` or
``"cp_zigzag_native"`` a long causal self-attention runs zigzag context
parallel over the ambient mesh (``kernels/cp_attention.py``), K4 per rank.  The alpha
computation between K2 and K1 stays in PyTorch, as in the reference
(``ops.py:200-204``).  The NA operations carry the reference's VJPs as
``torch.autograd.Function``s (``seg_sum.BandedMatvec``,
``AttentionPacked``) whose backward runs K1 again over the packing's
source-major view.  Attention and the SSD scan carry the gradient of
the reference's jnp path (``FlashAttention``, ``SSDScan``): K4 and K5
forward, float32 autograd of their plain versions backward; a call that
needs no gradient launches the kernel alone.  The SGB compositions are
forward only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.edge_softmax import NEG, edge_softmax_stats
from repro_torch.kernels.flash_attention import (FlashAttention, flash_attention,
                                                 padded_head_dim)
from repro_torch.kernels.seg_sum import (PackedEdges, edge_dots, needs_grad,
                                         pack_edge_blocks, seg_sum_forward,
                                         seg_sum_na, seg_sum_transposed)
from repro_torch.kernels.spgemm_bsr import (compose_dense_blocked,
                                            compose_padded_blocked)
from repro_torch.kernels.ssd_scan import SSDScan, ssd_scan


# Long-sequence attention route, the reference's module-level switch
# (``repro/kernels/ops.py:52``, same values and default).  The port has
# none of its jnp paths ("chunked", "chunked2d"): every route but the two
# context-parallel ones is one K4 call.
#   "cp_zigzag"        — zigzag context parallelism over the ambient
#                        mesh's 'model' axis (``launch.mesh.set_mesh``),
#                        p_shards=16, output in sequence order;
#   "cp_zigzag_native" — the same on a sequence stored in zigzag chunk
#                        order end to end (``models/lm.py`` gives RoPE the
#                        logical positions).
ATTN_IMPL: str = "chunked"
CP_P_SHARDS = 16


def _takes_cp_route(q, k, causal, window) -> bool:
    """The reference's conditions for the context-parallel route
    (``ops.py:116-127``): a cp ``ATTN_IMPL``, causal, no window, S == T,
    S % 32 == 0 and S·T above 2048²."""
    s, t = q.shape[2], k.shape[2]
    return (ATTN_IMPL in ("cp_zigzag", "cp_zigzag_native") and causal and window is None
            and s == t and s % 32 == 0 and s * t > 2048 * 2048)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention ``(B, Hq, S, Dh) x (B, Hkv, T, Dh) x (B, Hkv, T,
    Dv) -> (B, Hq, S, Dv)``, scaled by ``scale`` (default ``Dh ** -0.5``),
    through K4.  The kernel reads strided views as they are (the last
    dimension contiguous), so nothing is copied here at head dims 64, 128
    and 256 with ``Dv == Dh``; other head dims (hubert's 80, MLA's 96 / 64)
    are padded to the next one K4 takes (``flash_attention.pad_head_dims``).
    The output has ``q``'s layout.  Differentiable (``FlashAttention``)
    when autograd records on q, k or v.  Under a context-parallel
    ``ATTN_IMPL`` and the reference's conditions (``_takes_cp_route``) the
    call runs ``cp_zigzag_attention`` over the ambient mesh instead."""
    if _takes_cp_route(q, k, causal, window):
        from repro_torch.kernels.cp_attention import cp_zigzag_attention

        return cp_zigzag_attention(q, k, v, softcap=softcap, scale=scale,
                                   p_shards=CP_P_SHARDS,
                                   pre_permuted=ATTN_IMPL == "cp_zigzag_native")
    return attention_k4(q, k, v, causal, window, softcap, scale)


def attention_k4(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool = True, window: Optional[int] = None,
                 softcap: Optional[float] = None,
                 scale: Optional[float] = None) -> torch.Tensor:
    """``attention`` as one K4 call, whatever ``ATTN_IMPL`` says (each
    rank's call in ``cp_zigzag_attention``)."""
    if needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, softcap, scale)
    return flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                           scale=scale)


def attention_width(dqk: int, dv: int, device) -> int:
    """The head dim a caller building q and k itself should give them
    (zero-filled past ``dqk``) so that ``attention`` copies neither: the
    head dim K4 runs a ``(dqk, dv)`` call at on a CUDA device, ``dqk`` on
    the CPU (whose plain version takes any).  The call then passes
    ``scale=dqk ** -0.5``."""
    return padded_head_dim(dqk, dv) if torch.device(device).type == "cuda" else dqk


def ssd(x: torch.Tensor, a_log: torch.Tensor, b_coef: torch.Tensor,
        c_coef: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """Mamba2 SSD scan ``(B, S, H, P)`` through K5 (any layout; made
    contiguous here, which passes gradients); differentiable (``SSDScan``)
    when autograd records on an operand."""
    args = (x.contiguous(), a_log.contiguous(), b_coef.contiguous(), c_coef.contiguous())
    if needs_grad(x, a_log, b_coef, c_coef):
        return SSDScan.apply(*args, chunk)
    return ssd_scan(*args, chunk=chunk)


def na_aggregate(
    src: np.ndarray,
    dst: np.ndarray,
    h: torch.Tensor,
    num_dst: int,
    weight: Optional[np.ndarray] = None,
    packed: Optional[PackedEdges] = None,
) -> torch.Tensor:
    """Neighbour aggregation ``out[d] = sum_{(s,d) in E} w * h[s]``.

    ``packed`` supplies a cached packing of the scheduled ``(src, dst)``
    stream; without it the stream is packed here.
    """
    if packed is None:
        packed = pack_edge_blocks(src, dst, int(h.shape[0]), num_dst, weight=weight)
    elif weight is not None:
        packed = packed.with_weights(np.asarray(weight, np.float32))
    return seg_sum_na(packed, h)


def _alpha(packed: PackedEdges, logits: torch.Tensor, m: torch.Tensor,
           s: torch.Tensor) -> torch.Tensor:
    dst_g = packed.device_blocked(logits.device)["edge_dst"]
    return torch.exp(logits - m[dst_g]) / torch.clamp(s[dst_g], min=1e-9)


def _attention_forward(packed: PackedEdges, logits: torch.Tensor, h: torch.Tensor):
    """``(out, alpha, m, s)``: K2, alpha, then K1 with alpha as weights."""
    m, s = edge_softmax_stats(packed, packed.scatter_blocks(logits, fill=NEG))
    alpha = _alpha(packed, logits, m, s)
    return seg_sum_forward(packed, h, packed.scatter_blocks(alpha, fill=0.0)), alpha, m, s


class AttentionPacked(torch.autograd.Function):
    """Edge-softmax attention NA ``(logits, h) -> (out, alpha)`` with the
    reference's VJP (``repro/kernels/ops.py::_build_attention_packed_vjp``).

    Forward: K2's ``(m, s)`` over the blocked logits, alpha per edge, then
    K1 with alpha as the block weights; ``(logits, m, s, h)`` are saved.
    Backward recomputes alpha from ``(m, s)``, then

        grad_alpha_e = h[src_e] . g_out[dst_e] + g_alpha_e
        t[d]         = sum_{e: dst_e = d} alpha_e grad_alpha_e
        grad_logit_e = alpha_e (grad_alpha_e - t[dst_e])
        grad_h[s]    = sum_{e: src_e = s} alpha_e g_out[dst_e]

    ``t`` is K1 over the destination row view at width 1 (``h`` all ones,
    ``alpha * grad_alpha`` as the block weights) and ``grad_h`` K1 over the
    source-major view: both fixed-order per-row sums, so the backward
    uses no float atomics and repeats bit for bit.
    """

    @staticmethod
    def forward(ctx, packed: PackedEdges, logits: torch.Tensor, h: torch.Tensor):
        logits = logits.to(torch.float32)
        out, alpha, m, s = _attention_forward(packed, logits, h)
        ctx.packed = packed
        ctx.save_for_backward(logits, m, s, h)
        return out, alpha

    @staticmethod
    def backward(ctx, g_out: torch.Tensor, g_alpha: torch.Tensor):
        logits, m, s, h = ctx.saved_tensors
        packed = ctx.packed
        g_out = g_out.contiguous()
        alpha = _alpha(packed, logits, m, s)
        grad_alpha = edge_dots(packed, h, g_out) + g_alpha
        ones = torch.ones((packed.num_src, 1), dtype=torch.float32, device=h.device)
        t = seg_sum_forward(packed, ones,
                            packed.scatter_blocks(alpha * grad_alpha))[:, 0]
        dst_g = packed.device_blocked(h.device)["edge_dst"]
        grad_logits = alpha * (grad_alpha - t[dst_g])
        grad_h = None
        if ctx.needs_input_grad[2]:
            grad_h = seg_sum_transposed(packed, g_out, packed.scatter_blocks(alpha),
                                        num_rows=h.shape[0])
        return None, grad_logits, grad_h


def na_attention_packed(
    packed: PackedEdges,
    edge_logits: torch.Tensor,  # (E,) logits in the packing's scheduled order
    h: torch.Tensor,  # (N_src, D) features in the packing's src numbering
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge-softmax attention NA over a cached packing; ``(out, alpha)``,
    differentiable in ``edge_logits`` and ``h`` (``AttentionPacked``).

    The logits scatter into the blocked layout, K2 folds them into online
    per-destination ``(m, s)``, alpha is computed per edge, and K1
    aggregates with alpha as the block weights.  A call that needs no
    gradient skips the autograd Function.
    """
    if needs_grad(edge_logits, h):
        return AttentionPacked.apply(packed, edge_logits, h)
    out, alpha, _, _ = _attention_forward(packed, edge_logits.to(torch.float32), h)
    return out, alpha


def na_attention_aggregate(
    src: np.ndarray,
    dst: np.ndarray,
    edge_logits: torch.Tensor,
    h: torch.Tensor,
    num_dst: int,
    packed: Optional[PackedEdges] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge-softmax attention NA over a scheduled edge stream;
    ``(aggregated, alpha)``.  ``packed`` supplies a cached packing of the
    stream; without it the stream is packed here."""
    if packed is None:
        packed = pack_edge_blocks(src, dst, int(h.shape[0]), num_dst)
    return na_attention_packed(packed, edge_logits, h)


def compose_boolean(a_dense, b_dense) -> Tuple[torch.Tensor, dict]:
    """Boolean adjacency product (SGB composition) of unpadded 0/1
    matrices via the block-sparse SpGEMM; ``(result, pruning stats)``."""
    return compose_dense_blocked(a_dense, b_dense)


def compose_boolean_padded(
    a: torch.Tensor,  # (Mp, Kp) 0/1, tile-padded
    b: torch.Tensor,  # (Kp, Np) 0/1, tile-padded
    a_occ: torch.Tensor,
    b_occ: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """SGB composition over pre-padded operands with cached occupancy —
    the device composer's chain primitive (``core.sgb.DeviceComposer``).
    Returns ``(padded result, its occupancy, pruning stats)``."""
    return compose_padded_blocked(a, b, a_occ, b_occ)
