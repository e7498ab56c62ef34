"""Block-wise (flash) attention forward for the LM prefill path, kernel K4.

Computes ``softmax(q kᵀ · scale) v`` for ``(B, Hq, S, Dh)`` queries against
``(B, Hkv, T, Dh)`` keys and values with GQA (kv head = q head //
(Hq / Hkv)), queries end-aligned at key position ``T - S``, an optional
causal mask, sliding window and tanh softcap.  A query row with no live key
gives 0, as the TPU kernel's ``/ max(l, 1e-20)`` does; no valid call has one.
The value head dim may differ from the query / key one (MLA's prefill: q
and k at 96, v at 64); the output takes v's.

On a CUDA tensor ``flash_attention`` launches the hand-written Hopper kernel
in ``csrc/flash_attention.cu`` (``fa_forward``), which replaces the TPU
kernel ``repro/kernels/flash_attention.py::_fa_kernel``: one CTA per (batch,
q head, query tile) loops over the live key tiles itself with the online
softmax in float32 registers, masking the ragged edges instead of padding.
bfloat16 inputs run on the tensor cores: 128-row query tiles, ``wgmma`` fed
with K and V tiles by TMA through an ``mbarrier`` ring, float32
accumulators, P rounded to bf16 for the P V product (key tiles of 128, of 64
at head dim 256).  float32 inputs run on the CUDA cores in float32
throughout.  The kernel takes one type for q, k, v and the output, and any
strides whose last one is 1 (for bfloat16 the others and the addresses must
be multiples of 16 bytes, which the tensor maps require), so transposed
views, and the first columns of a wider buffer, need no copy; an output of
q's head dim has q's layout.  Its head dims ``(Dqk, Dv)`` are, natively,
``NATIVE_PAIRS`` in bfloat16 (64, 128 and 256 for both, hubert's 80 for
both, MLA's q/k 96 with v 64: the bf16 kernel reads the true columns and
issues no product over padding) and ``(d, d)`` for ``d`` in ``HEAD_DIMS``
in float32.  Any other pair up to 256 (a reduced config's 16, or MLA in
float32) takes the padded route: ``pad_head_dims`` copies q, k and v into
zero-filled buffers at the next of ``HEAD_DIMS``, the same kernel runs there
with the true scale ``Dqk ** -0.5``, and the output is sliced to v's head
dim.  That is exact: a zero column adds 0.0 to every q·k dot product of the
float32 accumulator, and a zero v column only fills output columns that are
dropped.  On a CPU tensor it runs ``attention_plain``, unpadded.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.kernels.cuda_build import check, load_library, ptr

NEG = -1e30
# head dims of the float32 kernel, and the widths the padded route pads to
HEAD_DIMS = (64, 128, 256)
# (Dqk, Dv) pairs the bf16 kernel is instantiated at (``fa_forward``'s dispatch)
NATIVE_PAIRS = ((64, 64), (128, 128), (256, 256), (80, 80), (96, 64))


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    """float32, or float64 for a float64 tensor (``gradcheck``)."""
    return torch.promote_types(t.dtype, torch.float32)


def _attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, qpos0: int,
                   kpos0: int, causal: bool, window: Optional[int],
                   softcap: Optional[float], scale: float) -> torch.Tensor:
    """``attention_ref`` over float32 (or float64) operands for query rows at
    positions ``qpos0 + i`` and keys at ``kpos0 + j``; rows with no live key
    give 0 (and pass no gradient)."""
    b, hq, s, _ = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    # each KV head broadcast to its q heads (head h reads KV head h // g);
    # the backward sums a group's heads as a reduction, not a scatter
    kf = k[:, :, None].expand(b, hkv, g, t, k.shape[3]).reshape(b, hq, t, k.shape[3])
    vf = v[:, :, None].expand(b, hkv, g, t, v.shape[3]).reshape(b, hq, t, v.shape[3])
    logits = (q @ kf.transpose(-1, -2)) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(s, device=q.device)[:, None] + qpos0
    kpos = torch.arange(t, device=q.device)[None, :] + kpos0
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    p = torch.softmax(logits.masked_fill(~mask, NEG), dim=-1)
    if not _all_rows_live(s, t, qpos0, kpos0, causal, window):
        p = p * mask.any(dim=-1, keepdim=True)
    return p @ vf


def _all_rows_live(s: int, t: int, qpos0: int, kpos0: int, causal: bool,
                   window: Optional[int]) -> bool:
    """Whether every query row sees a key: causal rows need the first key
    at or before them, windowed rows the last key inside their window."""
    live = qpos0 >= kpos0 if causal else True
    if window is not None:
        live = live and kpos0 + t - 1 > qpos0 + s - 1 - window
    return live


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of K4 (``attention_ref`` in float32, or
    float64 for float64 inputs; rows with no live key set to 0); the output
    has ``q``'s dtype and ``v``'s head dim."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    ct = _compute_dtype(q)
    out = _attention_f32(q.to(ct), k.to(ct), v.to(ct), k.shape[2] - q.shape[2], 0,
                         causal, window, softcap, scale)
    return out.to(q.dtype)


# The reference differentiates attention_ref up to S·T = 2048² and the
# key-chunked attention_chunked beyond (ops.py); the backward here
# recomputes in query tiles of at most VJP_TILE_ELEMS // T rows there, so no
# (B, H, S, T) float32 tensor outlives one tile.
VJP_TILE_ELEMS = 2048 * 2048


def attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None, scale: Optional[float] = None):
    """``(dq, dk, dv)`` of ``attention_plain`` at ``(q, k, v)`` for the
    output cotangent ``g``: float32 autograd of the plain version,
    recomputed from ``q``, ``k`` and ``v`` (query tile by query tile beyond
    ``S·T = VJP_TILE_ELEMS``; float64 inputs in float64), cast to the
    inputs' dtypes.  Each tile reads
    only the keys some row of it can see (causal and window bounds), which
    changes no value: a masked key's weight is exactly 0.  GQA's group sum
    lands in ``dk`` and ``dv`` through the broadcast's gradient, and the
    tiles' ``dk`` and ``dv`` add up in tile order."""
    s, t = q.shape[2], k.shape[2]
    off = t - s
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    rows = s if s * t <= VJP_TILE_ELEMS else max(1, VJP_TILE_ELEMS // t)
    ct = _compute_dtype(q)
    kf = k.detach().to(ct)
    vf = v.detach().to(ct)
    gf = g.to(ct)
    dq = torch.zeros(q.shape, dtype=ct, device=q.device)
    dk = torch.zeros(kf.shape, dtype=ct, device=k.device)
    dv = torch.zeros(vf.shape, dtype=ct, device=v.device)
    for q0 in range(0, s, rows):
        q1 = min(s, q0 + rows)
        hi = min(t, off + q1) if causal else t
        lo = max(0, off + q0 + 1 - window) if window is not None else 0
        if hi <= lo:  # no row of the tile sees a key: output and gradients 0
            continue
        with torch.enable_grad():
            qt = q[:, :, q0:q1].detach().to(ct).requires_grad_(True)
            kt = kf[:, :, lo:hi].requires_grad_(True)
            vt = vf[:, :, lo:hi].requires_grad_(True)
            out = _attention_f32(qt, kt, vt, off + q0, lo, causal, window, softcap, scale)
            gq, gk, gv = torch.autograd.grad(out, (qt, kt, vt), gf[:, :, q0:q1])
        dq[:, :, q0:q1] = gq
        dk[:, :, lo:hi] += gk
        dv[:, :, lo:hi] += gv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def padded_head_dim(dqk: int, dv: int) -> int:
    """The head dim K4 runs a ``(dqk, dv)`` call at: the smallest of
    ``HEAD_DIMS`` that holds both."""
    for dp in HEAD_DIMS:
        if dp >= max(dqk, dv):
            return dp
    raise ValueError(f"flash_attention kernel takes head dims up to {HEAD_DIMS[-1]}, "
                     f"got q/k {dqk} and v {dv}")


def kernel_pair(dqk: int, dv: int, dtype: torch.dtype) -> tuple:
    """The ``(Dqk, Dv)`` K4 runs a call of these head dims and ``dtype``
    at on the card: the pair itself where the kernel takes it (a bf16 pair
    in ``NATIVE_PAIRS``, a float32 ``(d, d)`` with ``d`` in ``HEAD_DIMS``),
    else both at ``padded_head_dim``."""
    native = ((dqk, dv) in NATIVE_PAIRS if dtype == torch.bfloat16
              else dqk == dv and dqk in HEAD_DIMS)
    if native:
        return dqk, dv
    dp = padded_head_dim(dqk, dv)
    return dp, dp


def pad_head_dims(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """``(qp, kp, vp, scale, dv)``: q, k and v zero-padded to
    ``padded_head_dim`` columns (copies; one already that wide is taken as
    it is), the scale of the unpadded call (``Dqk ** -0.5``, not ``Dp **
    -0.5``) and v's own head dim, to slice the padded output to.  Attention
    over the padded operands at that scale equals attention over the
    unpadded ones: the zero columns add exact zeros to every q·k product
    and give output columns that are dropped."""
    dqk, dv = q.shape[-1], v.shape[-1]
    dp = padded_head_dim(dqk, dv)
    qp, kp, vp = (t if t.shape[-1] == dp else F.pad(t, (0, dp - t.shape[-1]))
                  for t in (q, k, v))
    return qp, kp, vp, dqk ** -0.5, dv


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
    if (kb, hkv, t) != (vb, vh, vt) or kb != b or kd != dh:
        raise ValueError(f"k must be (B, Hkv, T, Dh) with q's B and Dh, and v (B, Hkv, T, "
                         f"Dv) with k's B, Hkv and T, got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"q heads ({hq}) must be a multiple of kv heads ({hkv})")
    padded_head_dim(dh, vd)  # raises above the largest head dim the kernel takes
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
    """Launch K4 (``fa_forward``) on ``q``'s CUDA device; head dims the
    kernel does not take (``kernel_pair``) run through ``pad_head_dims``."""
    _check_cuda_operands(q, k, v, window, softcap)
    dqk, dv = q.shape[3], v.shape[3]
    if kernel_pair(dqk, dv, q.dtype) != (dqk, dv):
        qp, kp, vp, true_scale, dv = pad_head_dims(q, k, v)
        out = flash_attention_cuda(qp, kp, vp, causal, window, softcap,
                                   true_scale if scale is None else scale)
        return out[..., :dv]
    b, hq, s, _ = q.shape
    t = k.shape[2]
    out = torch.empty_like(q) if dv == dqk else q.new_empty((b, hq, s, dv))
    if b == 0 or s == 0:
        return out
    if t == 0:
        raise ValueError("flash_attention needs at least one key")
    scale = scale if scale is not None else dqk ** -0.5
    if q.dtype == torch.bfloat16 and not scale > 0:
        raise ValueError(f"flash_attention's bfloat16 kernel takes a positive scale "
                         f"(it takes the row max before scaling), got {scale}")
    _fa_forward(q, k, v, out, scale, causal, window, softcap)
    return out


def _fa_forward(q, k, v, out, scale, causal, window, softcap) -> None:
    """One ``fa_forward`` launch into ``out`` on the current stream of
    ``q``'s device, at q's and v's head dims, counted in
    ``flash_attention.launches``, in the span ``kernels.k4``."""
    b, hq, s, dqk = q.shape
    hkv, t, dv = k.shape[1], k.shape[2], v.shape[3]
    strides = (ctypes.c_longlong * 12)(*_kernel_strides(q, k, v, out))
    lib = load_library("flash_attention")
    with torch.cuda.device(q.device), tracing.span("kernels.k4"):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fa_forward(
            ptr(q), ptr(k), ptr(v), ptr(out), b, hq, hkv, s, t, dqk, dv,
            int(q.dtype == torch.bfloat16), float(scale), int(bool(causal)),
            int(window or 0), float(softcap or 0.0), strides, ctypes.c_void_p(stream))
    check(rc, "fa_forward")
    flash_attention.launches += 1


def kernel_info(dqk: int, dv: Optional[int] = None) -> dict:
    """What the loaded bf16 kernel at ``(dqk, dv)`` (``dv`` defaults to
    ``dqk``) takes per CTA, as the CUDA runtime reports it: registers a
    thread at launch, dynamic shared memory bytes, local-memory (stack and
    spill) bytes a thread, threads, and the keys of one K/V tile."""
    info = (ctypes.c_int * 5)()
    check(load_library("flash_attention").fa_wgmma_info(dqk, dqk if dv is None else dv, info),
          "fa_wgmma_info")
    return {"registers": info[0], "shared_bytes": info[1], "local_bytes": info[2],
            "threads": info[3], "block_k": info[4]}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention ``(B, Hq, S, Dh) x (B, Hkv, T, Dh) x (B, Hkv, T, Dv) ->
    (B, Hq, S, Dv)``.

    A CUDA ``q`` launches kernel K4 once (counted in
    ``flash_attention.launches``), at the head dims themselves where the
    kernel takes them (``kernel_pair``), else padded to ``padded_head_dim``;
    a CPU ``q`` runs ``attention_plain``,
    and so does a ``meta`` one (shapes and operation counts without memory:
    ``launch/dryrun.py``).  ``scale`` defaults to ``Dh ** -0.5`` (q's true
    head dim, also on the padded route).  Records no gradient:
    ``FlashAttention`` does.
    """
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal, window, softcap, scale)
    if q.device.type not in ("cpu", "meta"):
        raise ValueError(f"flash_attention runs on cuda, cpu or meta, got {q.device}")
    return attention_plain(q, k, v, causal, window, softcap, scale)


flash_attention.launches = 0


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with the reference's VJP.

    The JAX package trains attention on its jnp path, so its gradient is
    autodiff of ``attention_ref`` (``attention_chunked`` beyond S·T =
    2048²; the same function), and its Pallas K4 has no VJP.  Forward: K4
    on a CUDA tensor (its padded route included), ``attention_plain`` on
    the CPU; q, k and v are saved.  Backward: ``attention_vjp``, float32
    autograd of the plain version recomputed from them at their own head
    dims (no padding to slice off)."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=None, softcap=None, scale=None):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, softcap, scale)
        return flash_attention(q, k, v, causal, window, softcap, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with tracing.span("lm.attn.backward"):
            dq, dk, dv = attention_vjp(q, k, v, g, *ctx.args)
        return dq, dk, dv, None, None, None, None
