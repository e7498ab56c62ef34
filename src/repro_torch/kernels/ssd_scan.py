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
    """Plain PyTorch version of K5, the reference's chunked SSD
    (``ref.ssd_chunked``) in torch ops (float32, or float64 for float64
    inputs); ``(B, S, H, P)`` in ``x``'s dtype.

    Every chunk at once: the intra-chunk ``((C Bᵀ) ∘ gate) x``, each
    chunk's own end state, then the states entering the chunks in order
    (the one sequential step, over (P, N) states) and their contribution
    ``exp(cum) C h``.  Heads share their group's B and C by broadcasting,
    so the backward sums over a group's heads without atomics."""
    bsz, s, h, p = x.shape
    g, n = b_coef.shape[2], b_coef.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    nc, rep = s // chunk, h // g
    ct = torch.promote_types(x.dtype, torch.float32)
    # (B, G, rep, nc, L, .) for the heads, (B, G, 1, nc, L, N) for B and C
    xf = x.to(ct).reshape(bsz, nc, chunk, g, rep, p).permute(0, 3, 4, 1, 2, 5)
    af = a_log.to(ct).reshape(bsz, nc, chunk, g, rep).permute(0, 3, 4, 1, 2)
    bf = b_coef.to(ct).reshape(bsz, nc, chunk, g, 1, n).permute(0, 3, 4, 1, 2, 5)
    cf = c_coef.to(ct).reshape(bsz, nc, chunk, g, 1, n).permute(0, 3, 4, 1, 2, 5)
    cum = torch.cumsum(af, dim=-1)  # (B, G, rep, nc, L)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    # masked before the exp, not after: above the diagonal the difference
    # grows with the chunk's decay, and exp's overflow there would turn the
    # masked gradient into 0 * inf = nan (same values)
    gate = torch.exp(torch.where(tri, cum[..., :, None] - cum[..., None, :], -torch.inf))
    y = ((cf @ bf.transpose(-1, -2)) * gate) @ xf
    w = torch.exp(cum[..., -1:] - cum)  # decay from each step to its chunk's end
    states = (xf * w[..., None]).transpose(-1, -2) @ bf  # (B, G, rep, nc, P, N)
    decay = torch.exp(cum[..., -1])  # (B, G, rep, nc)
    state = torch.zeros_like(states[:, :, :, 0])
    entering = []
    for st, dc in zip(states.unbind(3), decay.unbind(3)):
        entering.append(state)
        state = dc[..., None, None] * state + st
    h0 = torch.stack(entering, dim=3)  # the state entering each chunk
    y = y + torch.exp(cum)[..., None] * (cf @ h0.transpose(-1, -2))
    return y.permute(0, 3, 4, 1, 2, 5).reshape(bsz, s, h, p).to(x.dtype)


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
    CPU ``x`` runs ``ssd_plain``, and so does a ``meta`` one (shapes and
    operation counts without memory: ``launch/dryrun.py``).
    """
    if x.device.type == "cuda":
        return ssd_scan_cuda(x, a_log, b_coef, c_coef, chunk)
    if x.device.type not in ("cpu", "meta"):
        raise ValueError(f"ssd_scan runs on cuda, cpu or meta, got {x.device}")
    return ssd_plain(x, a_log, b_coef, c_coef, chunk)


ssd_scan.launches = 0


class SSDScan(torch.autograd.Function):
    """``ssd_scan`` with the reference's VJP.

    The JAX package trains the SSD on its jnp path (``ref.ssd_chunked``,
    the chunk math ``ssd_plain`` computes), and its Pallas K5 has no VJP.
    Forward: K5 on a CUDA tensor, ``ssd_plain`` on the CPU; the operands
    are saved.  Backward: float32 autograd of ``ssd_plain`` recomputed from
    them, cast to the operands' dtypes."""

    @staticmethod
    def forward(ctx, x, a_log, b_coef, c_coef, chunk=64):
        ctx.save_for_backward(x, a_log, b_coef, c_coef)
        ctx.chunk = chunk
        return ssd_scan(x, a_log, b_coef, c_coef, chunk)

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ct = torch.promote_types(saved[0].dtype, torch.float32)
            live = [t.detach().to(ct).requires_grad_(True) for t in saved]
            y = ssd_plain(*live, chunk=ctx.chunk)
            grads = torch.autograd.grad(y, live, gy.to(ct))
        return (*(g.to(t.dtype) for g, t in zip(grads, saved)), None)
