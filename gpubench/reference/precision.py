"""Matrix products at a stated precision, for the references and their
lower-precision controls.

``matmul(a, b, mode)`` computes ``a @ b`` in float32 with TF32 off
(``"float32"``), or with both operands first rounded to a lower precision
and the products accumulated in float32: TF32's 10 explicit mantissa
bits (``"tf32"``), bfloat16 (``"bf16"``) or float8 e4m3 with one scale a
tensor (``"fp8"``).  The rounding is done by hand, so a control reads the
same on the CPU as on the card.
"""
from __future__ import annotations

import torch

MODES = ("float32", "tf32", "bf16", "fp8")
FP8_MAX = 448.0  # largest finite float8 e4m3fn


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to nearest, ties to even, at 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` scaled so its largest magnitude is float8 e4m3's, rounded to
    e4m3 and scaled back (one scale a tensor, as an fp8 GEMM takes)."""
    amax = x.abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def lower(x: torch.Tensor, mode: str) -> torch.Tensor:
    """``x`` as float32, rounded to ``mode``'s precision."""
    x = x.to(torch.float32)
    if mode == "float32":
        return x
    if mode == "tf32":
        return round_tf32(x)
    if mode == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if mode == "fp8":
        return round_fp8(x)
    raise ValueError(f"unknown precision {mode!r}; have {MODES}")


class _LowMatmul(torch.autograd.Function):
    """``a @ b`` with every operand of the forward and backward products
    rounded to the mode's precision, as a lower-precision GEMM computes
    both passes."""

    @staticmethod
    def forward(ctx, a, b, mode):
        ctx.save_for_backward(a, b)
        ctx.mode = mode
        return torch.matmul(lower(a, mode), lower(b, mode))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        m = ctx.mode
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(lower(g, m), lower(b, m).transpose(-1, -2))
            ga = _unbroadcast(ga, a.shape)
        if ctx.needs_input_grad[1]:
            gb = torch.matmul(lower(a, m).transpose(-1, -2), lower(g, m))
            gb = _unbroadcast(gb, b.shape)
        return ga, gb, None


def _unbroadcast(g: torch.Tensor, shape) -> torch.Tensor:
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


def matmul(a: torch.Tensor, b: torch.Tensor, mode: str = "float32") -> torch.Tensor:
    """``a @ b`` accumulated in float32 from operands at ``mode``'s
    precision; differentiable, the backward's products at that precision
    too.  ``b`` may be a vector."""
    if b.dim() == 1:
        return matmul(a, b[:, None], mode)[..., 0]
    if mode == "float32":
        return torch.matmul(a.to(torch.float32), b.to(torch.float32))
    return _LowMatmul.apply(a, b, mode)


def strict_float32() -> None:
    """Turn TF32 off for float32 products on the card (a no-op on the CPU)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
