"""Mamba2 SSD (state-space duality) chunked scan, kernel K5.

Recurrence: ``h[t] = exp(a[t]) h[t-1] + B[t] ⊗ x[t]``, ``y[t] = C[t] · h[t]``,
computed chunk by chunk: within a chunk of ``L`` steps a masked ``(L, L)``
product, across chunks one float32 ``(P, N)`` state carried in order.  H
heads share G groups of B and C.

On a CUDA tensor ``ssd_scan`` launches the hand-written Hopper kernels in
``csrc/ssd_scan.cu`` (``ssd_scan_f32``), which replace the TPU kernel
``repro/kernels/ssd_scan.py::_ssd_kernel``.  The chunks run in parallel:
four passes, over scratch allocated here, compute each chunk's cumulative
decay and own state contribution (a CTA per batch, head and chunk), C Bᵀ
once per group, the states entering each chunk (the only sequential step,
elementwise), and the outputs (a CTA per batch, head and chunk).  Their
products run on the tensor cores as 3xTF32, which keeps float32 accuracy.
B and C are read by group and x, a and y in their ``(B, S, H, .)`` layouts.
It takes float32 with ``L <= 128``, ``P <= 64`` and ``N <= 128`` (each a
multiple of 4).  On a CPU tensor it runs ``ssd_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.cuda_build import check, load_library, ptr

MAX_CHUNK, MAX_P, MAX_N = 128, 64, 128


def ssd_plain(x: torch.Tensor, a_log: torch.Tensor, b_coef: torch.Tensor,
              c_coef: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """Plain PyTorch version of K5: the TPU kernel's chunk math in torch
    ops, looped over the chunks; ``(B, S, H, P)`` in ``x``'s dtype."""
    bsz, s, h, p = x.shape
    g = b_coef.shape[2]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    rep = h // g
    xf = x.float().permute(0, 2, 1, 3)  # (B, H, S, P)
    af = a_log.float().permute(0, 2, 1)  # (B, H, S)
    bf = b_coef.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    cf = c_coef.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    state = x.new_zeros((bsz, h, p, b_coef.shape[3]), dtype=torch.float32)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ys = []
    for c0 in range(0, s, chunk):
        xc, bc, cc = xf[:, :, c0:c0 + chunk], bf[:, :, c0:c0 + chunk], cf[:, :, c0:c0 + chunk]
        cum = torch.cumsum(af[:, :, c0:c0 + chunk], dim=-1)  # (B, H, L)
        gate = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)
        y = ((cc @ bc.transpose(-1, -2)) * gate) @ xc
        y = y + torch.exp(cum)[..., None] * (cc @ state.transpose(-1, -2))
        w = torch.exp(cum[..., -1:] - cum)
        state = (torch.exp(cum[..., -1])[..., None, None] * state
                 + (xc * w[..., None]).transpose(-1, -2) @ bc)
        ys.append(y)
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3).contiguous().to(x.dtype)


def _check_cuda_operands(x, a_log, b_coef, c_coef, chunk) -> None:
    for name, t in (("x", x), ("a_log", a_log), ("b_coef", b_coef), ("c_coef", c_coef)):
        if t.device != x.device:
            raise ValueError(f"ssd_scan operands must lie on one device; {name} "
                             f"is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan kernel takes contiguous tensors ({name})")
    if x.dim() != 4 or a_log.dim() != 3 or b_coef.dim() != 4:
        raise ValueError("ssd_scan takes x (B, S, H, P), a_log (B, S, H), "
                         "b_coef and c_coef (B, S, G, N)")
    bsz, s, h, p = x.shape
    g, n = b_coef.shape[2], b_coef.shape[3]
    if (a_log.shape != (bsz, s, h) or b_coef.shape != (bsz, s, g, n)
            or c_coef.shape != b_coef.shape):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, a_log "
                         f"{tuple(a_log.shape)}, b {tuple(b_coef.shape)}, "
                         f"c {tuple(c_coef.shape)}")
    if g == 0 or h % g:
        raise ValueError(f"heads ({h}) must be a multiple of groups ({g})")
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    for name, val, top in (("chunk", chunk, MAX_CHUNK), ("P", p, MAX_P), ("N", n, MAX_N)):
        if not 0 < val <= top or val % 4:
            raise ValueError(f"ssd_scan kernel takes {name} in 4..{top}, a multiple "
                             f"of 4, got {val}")


def ssd_scan_cuda(x, a_log, b_coef, c_coef, chunk: int = 64) -> torch.Tensor:
    """Launch K5 (``ssd_scan_f32``) on ``x``'s CUDA device."""
    _check_cuda_operands(x, a_log, b_coef, c_coef, chunk)
    bsz, s, h, p = x.shape
    g, n = b_coef.shape[2], b_coef.shape[3]
    y = torch.empty_like(x)
    if bsz == 0 or s == 0:
        return y
    lib = load_library("ssd_scan")
    sizes = (ctypes.c_longlong * 3)()
    check(lib.ssd_scan_scratch(bsz, s, h, g, p, n, chunk, sizes), "ssd_scan_scratch")
    cum, states, gmat = (torch.empty(k, dtype=torch.float32, device=x.device) for k in sizes)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_scan_f32(ptr(x), ptr(a_log), ptr(b_coef), ptr(c_coef), ptr(y),
                              ptr(cum), ptr(states), ptr(gmat), bsz, s, h, g, p, n, chunk,
                              ctypes.c_void_p(stream))
    check(rc, "ssd_scan_f32")
    ssd_scan.launches += 1
    return y


def ssd_scan(x: torch.Tensor, a_log: torch.Tensor, b_coef: torch.Tensor,
             c_coef: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """SSD scan of ``x (B, S, H, P)`` with log-decay ``a_log (B, S, H)``
    (``<= 0``) and coefficients ``b_coef``, ``c_coef (B, S, G, N)``;
    ``S`` a multiple of ``chunk``.

    A CUDA ``x`` launches kernel K5 (counted in ``ssd_scan.launches``); a
    CPU ``x`` runs ``ssd_plain``.
    """
    if x.device.type == "cuda":
        return ssd_scan_cuda(x, a_log, b_coef, c_coef, chunk)
    if x.device.type != "cpu":
        raise ValueError(f"ssd_scan runs on cuda or cpu, got {x.device}")
    return ssd_plain(x, a_log, b_coef, c_coef, chunk)


ssd_scan.launches = 0
