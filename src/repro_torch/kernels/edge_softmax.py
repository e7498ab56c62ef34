"""Per-destination edge-softmax statistics: kernel K2.

The attention NA sub-stage needs ``alpha_e = exp(l_e - m[dst_e]) / s[dst_e]``
with ``m``/``s`` the per-destination max and sum-of-exp.  A destination's
edges can span several edge blocks (and, after restructuring, two
subgraphs), so the kernel folds ``(m, s)`` online across the blocks of a
destination tile, exactly as the TPU kernel does:

    m_new = max(m_old, max_block)
    s_new = s_old * exp(m_old - m_new) + sum_e exp(l_e - m_new)

On a CUDA tensor ``edge_softmax_stats`` launches the hand-written Hopper
kernel in ``csrc/na_kernels.cu`` (``na_softmax_stats_f32``), which replaces
the TPU kernel ``repro/kernels/edge_softmax.py::_stats_kernel``.  It reads
K1's row view and work list (``PackedEdges.row_edges``): a warp owns a run
of whole rows and takes each row's max, then its sum of exponentials, by
warp reductions; a heavy row's slices fold online and combine in a fixed
order as ``m = max(m_i)``, ``s = sum(s_i * exp(m_i - m))``.  ``m`` is
exact.  On a CPU tensor it runs ``softmax_stats_plain``, which computes the
same statistics directly per tile (max first, then the sum).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.cuda_build import check, load_library, ptr
from repro_torch.kernels.seg_sum import PackedEdges

NEG = -1e30  # the (m, s) init and the padding logit


def edge_softmax_ref(logits: torch.Tensor, dst: torch.Tensor,
                     num_dst: int) -> torch.Tensor:
    """Per-destination softmax over a flat edge list (the oracle).

    Written as dense one-hot reductions: meant for test-sized inputs.
    """
    dst = torch.as_tensor(dst, device=logits.device).long()
    mask = torch.arange(num_dst, device=logits.device)[:, None] == dst[None, :]
    m = torch.where(mask, logits[None, :], -torch.inf).amax(dim=1)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ex = torch.exp(logits - m[dst])
    s = (mask.to(ex.dtype) * ex[None, :]).sum(dim=1)
    return ex / torch.clamp(s[dst], min=1e-9)


def softmax_stats_plain(packed: PackedEdges,
                        logits_blocked: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2; returns ``(m, s)`` over ``num_dst``.

    Walks the tiles like the kernel, but takes each row's max over all of
    its valid in-edges at once and then the sum of exponentials — the
    same statistics as the online fold, up to rounding.  Rows without
    in-edges read ``(-1e30, 0)``.
    """
    dev = logits_blocked.device
    db = packed.device_blocked(dev)
    td = packed.dst_tile_rows
    edge_ptr, _, _ = packed.tile_edges()
    l_e = logits_blocked[db["tile_blk"], db["tile_slot"]].to(torch.float32)
    dst_local = db["tile_dst_local"]
    rows = torch.arange(td, device=dev)
    m = torch.full((packed.num_dst_tiles * td,), NEG, dtype=torch.float32, device=dev)
    s = torch.zeros((packed.num_dst_tiles * td,), dtype=torch.float32, device=dev)
    for t in range(packed.num_dst_tiles):
        a, b = int(edge_ptr[t]), int(edge_ptr[t + 1])
        if a == b:
            continue
        mask = rows[:, None] == dst_local[None, a:b]
        lt = l_e[None, a:b]
        mt = torch.where(mask, lt, NEG).amax(dim=1)
        ex = torch.exp(torch.where(mask, lt - mt[:, None], -torch.inf))
        m[t * td:(t + 1) * td] = mt
        s[t * td:(t + 1) * td] = ex.sum(dim=1)
    return m[: packed.num_dst], s[: packed.num_dst]


def softmax_stats_cuda(packed: PackedEdges, logits_blocked: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 (``na_softmax_stats_f32``) on the logits' CUDA device."""
    if logits_blocked.dtype != torch.float32:
        raise TypeError(f"edge_softmax_stats kernel takes float32, got {logits_blocked.dtype}")
    if tuple(logits_blocked.shape) != packed.src_local.shape:
        raise ValueError(f"logits must be {packed.src_local.shape}, "
                         f"got {tuple(logits_blocked.shape)}")
    if not logits_blocked.is_contiguous():
        raise ValueError("edge_softmax_stats kernel takes contiguous logits")
    dev = logits_blocked.device
    db = packed.device_blocked(dev)
    m = torch.empty((packed.num_dst,), dtype=torch.float32, device=dev)
    s = torch.empty((packed.num_dst,), dtype=torch.float32, device=dev)
    items = db["items"]
    if items.shape[0] == 0:
        return m, s
    lib = load_library("na_kernels")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.na_softmax_stats_f32(
            ptr(items), ptr(db["row_ptr"]), ptr(db["row_slot"]),
            ptr(logits_blocked), ptr(m), ptr(s), int(items.shape[0]),
            ctypes.c_void_p(stream))
    check(rc, "na_softmax_stats_f32")
    edge_softmax_stats.launches += 1
    return m, s


def edge_softmax_stats(packed: PackedEdges, logits_blocked: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-destination ``(m, s)`` over ``num_dst``; untouched rows read
    ``(-1e30, 0)``.

    ``logits_blocked`` is ``(nb, EB)`` float32 in the blocked layout
    (``PackedEdges.scatter_blocks``).  Validity comes from ``count``, not
    from any weights, so zero-weight edges stay in the softmax.  A CUDA
    tensor launches kernel K2 (counted in ``edge_softmax_stats.launches``);
    a CPU tensor runs ``softmax_stats_plain``.
    """
    if logits_blocked.device.type == "cuda":
        return softmax_stats_cuda(packed, logits_blocked)
    if logits_blocked.device.type != "cpu":
        raise ValueError(
            f"edge_softmax_stats runs on cuda or cpu, got {logits_blocked.device}")
    return softmax_stats_plain(packed, logits_blocked)


edge_softmax_stats.launches = 0


def block_logits(packed: PackedEdges, edge_logits_in_order: np.ndarray) -> np.ndarray:
    """Scatter a flat (E,) logit array (in scheduled edge order) into the
    (nb, EB) blocked layout of ``packed`` on the host; padding gets -1e30.
    ``PackedEdges.scatter_blocks(logits, fill=-1e30)`` is the on-device
    form the NA path uses."""
    nb, eb = packed.src_local.shape
    blk, slot = packed.edge_map()
    if edge_logits_in_order.shape[0] != blk.shape[0]:
        raise ValueError("one logit per edge of the packing is required")
    out = np.full((nb, eb), NEG, np.float32)
    out[blk, slot] = np.asarray(edge_logits_in_order, np.float32)
    return out
