"""NA operations over packed edge blocks, the SGB composition, and the LM
zoo's attention and SSD scan: the forward half of the JAX package's
``repro.kernels.ops``.

The device of the input tensors picks the implementation: CUDA tensors go
through the hand-written kernels K1 (``seg_sum_na``), K2
(``edge_softmax_stats``), K3 (``spgemm_bsr``), K4 (``flash_attention``) and
K5 (``ssd_scan``), CPU tensors through their plain versions.  The alpha computation between K2 and K1 stays in PyTorch,
as in the reference (``ops.py:200-204``).  Forward only: gradients come
with a later slice of the port.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.edge_softmax import NEG, edge_softmax_stats
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.seg_sum import PackedEdges, pack_edge_blocks, seg_sum_na
from repro_torch.kernels.spgemm_bsr import (compose_dense_blocked,
                                            compose_padded_blocked)
from repro_torch.kernels.ssd_scan import ssd_scan


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention ``(B, Hq, S, Dh) x (B, Hkv, T, Dh) -> (B, Hq, S,
    Dh)``, scaled by ``Dh ** -0.5``, through K4.  The kernel reads strided
    views as they are (the last dimension contiguous), so nothing is copied
    here; the output has ``q``'s layout."""
    return flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)


def ssd(x: torch.Tensor, a_log: torch.Tensor, b_coef: torch.Tensor,
        c_coef: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """Mamba2 SSD scan ``(B, S, H, P)`` through K5 (any layout; made
    contiguous here)."""
    return ssd_scan(x.contiguous(), a_log.contiguous(), b_coef.contiguous(),
                    c_coef.contiguous(), chunk=chunk)


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


def na_attention_packed(
    packed: PackedEdges,
    edge_logits: torch.Tensor,  # (E,) logits in the packing's scheduled order
    h: torch.Tensor,  # (N_src, D) features in the packing's src numbering
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge-softmax attention NA over a cached packing; ``(out, alpha)``.

    The logits scatter into the blocked layout, K2 folds them into online
    per-destination ``(m, s)``, alpha is computed per edge, and K1
    aggregates with alpha as the block weights.
    """
    db = packed.device_blocked(h.device)
    logits = edge_logits.to(torch.float32)
    m, s = edge_softmax_stats(packed, packed.scatter_blocks(logits, fill=NEG))
    dst_g = db["edge_dst"]
    alpha = torch.exp(logits - m[dst_g]) / torch.clamp(s[dst_g], min=1e-9)
    out = seg_sum_na(packed, h, weights=packed.scatter_blocks(alpha, fill=0.0))
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
