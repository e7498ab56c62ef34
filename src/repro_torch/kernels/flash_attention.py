"""Block-wise (flash) attention forward for the LM prefill path, kernel K4.

Computes ``softmax(q kᵀ · scale) v`` for ``(B, Hq, S, Dh)`` queries against
``(B, Hkv, T, Dh)`` keys and values with GQA (kv head = q head //
(Hq / Hkv)), queries end-aligned at key position ``T - S``, an optional
causal mask, sliding window and tanh softcap.  A query row with no live key
gives 0, as the TPU kernel's ``/ max(l, 1e-20)`` does; no valid call has one.

On a CUDA tensor ``flash_attention`` launches the hand-written Hopper kernel
in ``csrc/flash_attention.cu`` (``fa_forward``), which replaces the TPU
kernel ``repro/kernels/flash_attention.py::_fa_kernel``: one CTA per (batch,
q head, query tile) loops over the live key tiles itself with the online
softmax in float32 registers, masking the ragged edges instead of padding.
bfloat16 inputs run on the tensor cores: 128-row query tiles, ``wgmma`` fed
with K and V tiles by TMA through an ``mbarrier`` ring, float32
accumulators, P rounded to bf16 for the P V product (key tiles of 128, of 64
at head dim 256).  float32 inputs run on the CUDA cores in float32
throughout.  It takes one type for q, k, v and the output, a head dim of 64,
128 or 256, and any strides whose last one is 1 (for bfloat16 the others and
the addresses must be multiples of 16 bytes, which the tensor maps require),
so transposed views need no copy; the output has q's layout.  On a CPU
tensor it runs ``attention_plain``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.cuda_build import check, load_library, ptr

NEG = -1e30
HEAD_DIMS = (64, 128, 256)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of K4 (``attention_ref`` in float32, rows with
    no live key set to 0); the output has ``q``'s dtype."""
    b, hq, s, dh = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else dh ** -0.5
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    logits = (q.float() @ kf.transpose(-1, -2)) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(s, device=q.device)[:, None] + (t - s)
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    p = torch.softmax(logits.masked_fill(~mask, NEG), dim=-1)
    p = p * mask.any(dim=-1, keepdim=True)
    return (p @ vf).to(q.dtype)


def _check_cuda_operands(q, k, v, window, softcap) -> None:
    dev, dtype = q.device, q.dtype
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention operands must lie on one device; "
                             f"{name} is on {t.device}, q on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"flash_attention takes one dtype for q, k, v; "
                            f"{name} is {t.dtype}, q {dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"flash_attention takes 4-D tensors ({name})")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention kernel takes tensors whose last dimension "
                             f"is contiguous ({name} has stride {t.stride(3)})")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, got {dtype}")
    b, hq, _, dh = q.shape
    kb, hkv, t, kd = k.shape
    vb, vh, vt, vd = v.shape  # ints: a torch.Size comparison costs more
    if (kb, hkv, t, kd) != (vb, vh, vt, vd) or kb != b or kd != dh:
        raise ValueError(f"k and v must be (B, Hkv, T, Dh) with q's B and Dh, got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"q heads ({hq}) must be a multiple of kv heads ({hkv})")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims {HEAD_DIMS}, got {dh}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")


def _kernel_strides(*tensors: torch.Tensor) -> list:
    """The (batch, head, row) element strides of each ``(B, H, rows, Dh)``
    tensor, in turn, as ``fa_forward`` takes them.  A dimension of size 1
    is never stepped, so its stride is set to ``Dh`` (any valid value);
    for bfloat16 every stride must be a multiple of 16 bytes, the rule of
    the kernel's TMA tensor maps."""
    out = []
    for t in tensors:
        shape, stride = t.shape, t.stride()
        row = [stride[d] if shape[d] > 1 else shape[3] for d in range(3)]
        if t.dtype == torch.bfloat16 and (
                row[0] % 8 or row[1] % 8 or row[2] % 8 or t.data_ptr() % 16):
            raise ValueError(f"flash_attention's bfloat16 kernel takes strides and "
                             f"addresses that are multiples of 16 bytes, got strides "
                             f"{stride} at address {t.data_ptr():#x}")
        out += row
    return out


def flash_attention_cuda(q, k, v, causal=True, window=None, softcap=None,
                         scale=None) -> torch.Tensor:
    """Launch K4 (``fa_forward``) on ``q``'s CUDA device."""
    _check_cuda_operands(q, k, v, window, softcap)
    b, hq, s, dh = q.shape
    hkv, t = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    if t == 0:
        raise ValueError("flash_attention needs at least one key")
    scale = scale if scale is not None else dh ** -0.5
    if q.dtype == torch.bfloat16 and not scale > 0:
        raise ValueError(f"flash_attention's bfloat16 kernel takes a positive scale "
                         f"(it takes the row max before scaling), got {scale}")
    strides = (ctypes.c_longlong * 12)(*_kernel_strides(q, k, v, out))
    lib = load_library("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fa_forward(
            ptr(q), ptr(k), ptr(v), ptr(out), b, hq, hkv, s, t, dh,
            int(q.dtype == torch.bfloat16), float(scale), int(bool(causal)),
            int(window or 0), float(softcap or 0.0), strides, ctypes.c_void_p(stream))
    check(rc, "fa_forward")
    flash_attention.launches += 1
    return out


def kernel_info(dh: int) -> dict:
    """What the loaded bf16 kernel at head dim ``dh`` takes per CTA, as the
    CUDA runtime reports it: registers a thread at launch, dynamic shared
    memory bytes, local-memory (stack and spill) bytes a thread, threads,
    and the keys of one K/V tile."""
    info = (ctypes.c_int * 5)()
    check(load_library("flash_attention").fa_wgmma_info(dh, info), "fa_wgmma_info")
    return {"registers": info[0], "shared_bytes": info[1], "local_bytes": info[2],
            "threads": info[3], "block_k": info[4]}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention ``(B, Hq, S, Dh) x (B, Hkv, T, Dh) -> (B, Hq, S, Dh)``.

    A CUDA ``q`` launches kernel K4 (counted in ``flash_attention.launches``);
    a CPU ``q`` runs ``attention_plain``.  ``scale`` defaults to
    ``Dh ** -0.5``.
    """
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal, window, softcap, scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    return attention_plain(q, k, v, causal, window, softcap, scale)


flash_attention.launches = 0
