"""LM building blocks: RMSNorm, RoPE, GQA attention (causal, sliding
window, softcap), SwiGLU MLP and the Mamba2 mixer.

Plain functions on tensors; parameters are dicts of tensors as in the JAX
package's ``repro.models.layers``, whose dtypes they keep: bf16 weights and
residual stream, float32 norms, RoPE tables, SSM coefficients and state.
Where that module's jnp code mixes bf16 with float32 (jnp promotes to
float32), the casts are written out.  Attention without a cache goes
through ``ops.attention`` (K4 on a CUDA tensor) and the Mamba2 scan without
a state through ``ops.ssd`` (K5).  With a cache, both update it in place
(the KV rows at ``cache_pos``, the conv and SSM state) and return it.
``mla_attention``, ``moe_ffn`` and ``mrope_cos_sin`` wait for ROADMAP M12.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


# ---------------------------------------------------------------- norms ----
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in float32, cast back to ``x``'s dtype; ``plus_one`` scales
    by ``1 + w`` (gemma)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    scale = (1.0 + w) if plus_one else w
    return (y * scale).to(x.dtype)


# ----------------------------------------------------------------- rope ----
def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float = 1e4
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> float32 cos/sin (..., S, dim/2)."""
    ar = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (ar / dim))
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, H, S, Dh); cos/sin (B, S, Dh/2) — rotate-half convention.  The
    result keeps ``x``'s memory layout, so a (B, S, H, Dh) view stays one and
    K4 reads it, and writes its output in it, without a copy."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c, s = cos[:, None], sin[:, None]
    out = torch.empty_like(x)
    out[..., :d2] = x1 * c - x2 * s
    out[..., d2:] = x2 * c + x1 * s
    return out


def write_at(buf: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """Write ``new`` into the cache ``buf`` (B, H, T, Dh) at sequence
    position ``pos``, in place; the start clamps so the update fits, as
    ``jax.lax.dynamic_update_slice``'s does."""
    start = max(0, min(int(pos), buf.shape[2] - new.shape[2]))
    buf[:, :, start:start + new.shape[2]] = new
    return buf


# ------------------------------------------------------------ attention ----
def gqa_attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, S, D)
    cos: torch.Tensor,
    sin: torch.Tensor,
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_scale: Optional[float] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """GQA attention; with ``cache`` (decode) the new k/v go in at
    ``cache_pos`` and the queries attend over the whole cache."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, num_heads, head_dim).transpose(1, 2)
    k = (x @ p["wk"]).reshape(b, s, num_kv_heads, head_dim).transpose(1, 2)
    v = (x @ p["wv"]).reshape(b, s, num_kv_heads, head_dim).transpose(1, 2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache is not None:
        k_cache = write_at(cache["k"], k.to(cache["k"].dtype), cache_pos)
        v_cache = write_at(cache["v"], v.to(cache["v"].dtype), cache_pos)
        t = k_cache.shape[2]
        kpos = torch.arange(t, device=x.device)[None, :]
        qpos = (int(cache_pos) + torch.arange(s, device=x.device))[:, None]
        mask = kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        scale = q_scale if q_scale is not None else head_dim ** -0.5
        g = num_heads // num_kv_heads
        # grouped einsum: no (B, Hq, T, dh) repeat of the cache
        qg = q.reshape(b, num_kv_heads, g, s, head_dim)
        logits = torch.einsum("bkgsd,bktd->bkgst", qg, k_cache) * scale
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        logits = logits.masked_fill(~mask, -1e30)
        prob = torch.softmax(logits, dim=-1)
        o = torch.einsum("bkgst,bktd->bkgsd", prob, v_cache)
        o = o.reshape(b, num_heads, s, head_dim)
        new_cache = {"k": k_cache, "v": v_cache}
    else:
        if q_scale is not None:
            # ops.attention scales by 1/sqrt(dh); fold the custom scale into q
            q = q * (q_scale * head_dim ** 0.5)
        o = ops.attention(q, k, v, causal=causal, window=window, softcap=softcap)
        new_cache = None
    o = o.transpose(1, 2).reshape(b, s, num_heads * head_dim)
    return o @ p["wo"], new_cache


# ----------------------------------------------------------------- ffn -----
def swiglu_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x Wg) * (x Wu)) Wd``."""
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# --------------------------------------------------------------- mamba2 ----
def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0); torch's softplus switches to x above 20
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(hist: torch.Tensor, w: torch.Tensor, b: torch.Tensor, s: int
                 ) -> torch.Tensor:
    # summed in the reference's order: ((0 + t0) + t1) + ... then + bias
    out = 0
    for i in range(w.shape[0]):
        out = out + hist[:, i:i + s] * w[i][None, None, :]
    return out + b


def mamba2_mixer(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, S, D)
    *,
    num_heads: int,
    head_dim: int,
    state_dim: int,
    num_groups: int,
    conv_width: int = 4,
    chunk: int = 64,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Mamba2 block (SSD).  ``state`` enables single-step decode:
    ``{"conv": (B, conv_width-1, conv_dim), "ssm": (B, H, P, N)}``, updated
    in place."""
    b, s, _ = x.shape
    d_inner = num_heads * head_dim
    conv_dim = d_inner + 2 * num_groups * state_dim

    zxbcdt = x @ p["w_in"]  # (B, S, 2*d_inner + 2*g*n + h), bf16
    z, xbc, dt = torch.split(zxbcdt, [d_inner, conv_dim, num_heads], dim=-1)
    dt = _softplus(dt.float() + p["dt_bias"])  # (B, S, H) float32

    if state is None:
        pad = F.pad(xbc, (0, 0, conv_width - 1, 0))
        conv = _causal_conv(pad, p["w_conv"], p["b_conv"], s)
    else:
        hist = torch.cat([state["conv"], xbc], dim=1)  # (B, cw-1+s, .)
        conv = _causal_conv(hist, p["w_conv"], p["b_conv"], s)
        state["conv"].copy_(hist[:, -(conv_width - 1):])
    conv = F.silu(conv)  # float32

    xs, bmat, cmat = torch.split(conv, [d_inner, num_groups * state_dim,
                                        num_groups * state_dim], dim=-1)
    xs = xs.reshape(b, s, num_heads, head_dim)
    bmat = bmat.reshape(b, s, num_groups, state_dim)
    cmat = cmat.reshape(b, s, num_groups, state_dim)
    a_log = -torch.exp(p["a_log"])[None, None, :] * dt  # (B, S, H), <= 0

    if state is None:
        y = ops.ssd(xs * dt[..., None], a_log, bmat, cmat, chunk=chunk)
    else:
        # single-step recurrence (s == 1 expected)
        rep = num_heads // num_groups
        bexp = bmat.repeat_interleave(rep, dim=2)[:, 0]  # (B, H, N)
        cexp = cmat.repeat_interleave(rep, dim=2)[:, 0]
        a = torch.exp(a_log[:, 0])[:, :, None, None]  # (B, H, 1, 1)
        upd = torch.einsum("bhp,bhn->bhpn", (xs * dt[..., None])[:, 0], bexp)
        new_ssm = a * state["ssm"] + upd
        y = torch.einsum("bhpn,bhn->bhp", new_ssm, cexp)[:, None]
        state["ssm"].copy_(new_ssm)
    y = y.reshape(b, s, d_inner)
    y = rms_norm(y * F.silu(z).float(), p["norm"])  # gated norm, float32
    return y @ p["w_out"].float(), state
