"""LM building blocks: RMSNorm, RoPE and M-RoPE, attention (GQA with a
causal mask, sliding window and softcap; MLA), the SwiGLU MLP, GShard-style
MoE and the Mamba2 mixer.

Plain functions on tensors; parameters are dicts of tensors as in the JAX
package's ``repro.models.layers``, whose dtypes they keep: bf16 weights and
residual stream, float32 norms, RoPE tables, router, SSM coefficients and
state.  Where that module's jnp code mixes bf16 with float32 (jnp promotes
to float32), the casts are written out.  Attention without a cache goes
through ``ops.attention`` (K4 on a CUDA tensor) and the Mamba2 scan without
a state through ``ops.ssd`` (K5).  With a cache, both update it in place
(the KV rows or MLA's latent rows at ``cache_pos``, the conv and SSM state)
and return it.  The MoE products are plain ``torch.einsum`` calls, as the
reference leaves them to XLA.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
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


def mrope_cos_sin(pos3: torch.Tensor, sections: Sequence[int], dim: int,
                  theta: float = 1e4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL M-RoPE: ``pos3`` (3, B, S) -> float32 cos/sin (B, S, dim/2).
    ``sections`` split the dim/2 frequency channels into temporal, height
    and width groups, each rotated by its own position component.  Each
    channel picks its component by index; the reference's one-hot einsum
    adds exact zeros to the same value."""
    if sum(sections) != dim // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to dim/2 = {dim // 2}")
    cos, sin = rope_cos_sin(pos3, dim, theta)  # (3, B, S, dim/2)
    comp = torch.repeat_interleave(torch.arange(3, device=pos3.device),
                                   torch.tensor(list(sections), device=pos3.device),
                                   output_size=dim // 2)
    chan = torch.arange(dim // 2, device=pos3.device)
    return cos[comp, ..., chan].permute(1, 2, 0), sin[comp, ..., chan].permute(1, 2, 0)


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


def write_at(buf: torch.Tensor, new: torch.Tensor, pos, dim: int = 2) -> torch.Tensor:
    """Write ``new`` into the cache ``buf`` at sequence position ``pos`` of
    dimension ``dim`` (2 for a (B, H, T, Dh) KV cache, 1 for MLA's (B, T,
    r) latent), in place; the start clamps so the update fits, as
    ``jax.lax.dynamic_update_slice``'s does."""
    n = new.shape[dim]
    start = max(0, min(int(pos), buf.shape[dim] - n))
    buf.narrow(dim, start, n).copy_(new)
    return buf


# ------------------------------------------------------------ attention ----
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, cache_pos,
                     *, window: Optional[int] = None, softcap: Optional[float] = None,
                     scale: float) -> torch.Tensor:
    """The cached branch of ``gqa_attention``: the queries ``q`` (B, Hq, S,
    Dh) at positions ``cache_pos`` on attend over the whole cache (B, Hkv, T,
    Dh), keys past a query's position (or outside its window) masked, in
    the reference's dtypes (the cache's: bf16 logits and probabilities), one
    einsum over the heads' groups that never repeats the cache.  Returns (B,
    Hq, S, Dv)."""
    b, hq, s, dh = q.shape
    hkv, t = k_cache.shape[1], k_cache.shape[2]
    kpos = torch.arange(t, device=q.device)[None, :]
    qpos = (int(cache_pos) + torch.arange(s, device=q.device))[:, None]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    qg = q.reshape(b, hkv, hq // hkv, s, dh)
    logits = torch.einsum("bkgsd,bktd->bkgst", qg, k_cache) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = logits.masked_fill(~mask, -1e30)
    prob = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", prob, v_cache)
    return o.reshape(b, hq, s, v_cache.shape[-1])


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
        scale = q_scale if q_scale is not None else head_dim ** -0.5
        o = decode_attention(q, k_cache, v_cache, cache_pos, window=window, softcap=softcap,
                             scale=scale)
        new_cache = {"k": k_cache, "v": v_cache}
    else:
        if q_scale is not None:
            # ops.attention scales by 1/sqrt(dh); fold the custom scale into q
            q = q * (q_scale * head_dim ** 0.5)
        o = ops.attention(q, k, v, causal=causal, window=window, softcap=softcap)
        new_cache = None
    o = o.transpose(1, 2).reshape(b, s, num_heads * head_dim)
    return o @ p["wo"], new_cache


def mla_attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, S, D)
    cos: torch.Tensor,
    sin: torch.Tensor,
    *,
    num_heads: int,
    head_dim: int,
    rope_dim: int,
    causal: bool = True,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style).

    K and V are compressed into a latent ``c_kv`` (rank r) shared by the
    heads, plus a small RoPE'd key part ``k_r`` shared across heads.  The
    prefill expands K and V from the latent and runs ``ops.attention`` on
    ``[nope; rope]`` features: q and k at ``head_dim``, v at ``head_dim -
    rope_dim`` (K4 on a CUDA tensor, which takes that pair as it is in
    bfloat16 and pads it in float32).  With
    ``cache = {"c_kv": (B, T, r), "k_r": (B, 1, T, rope)}`` (decode) the new
    rows go in at ``cache_pos``, in place, and the queries attend in the
    latent space with ``W_uk`` folded into them (absorbed MLA): the cache
    never expands K or V.
    """
    b, s, _ = x.shape
    nope = head_dim - rope_dim
    q = (x @ p["wq"]).reshape(b, s, num_heads, head_dim).transpose(1, 2)
    q_n = q[..., :nope]
    rc, rs = cos[..., :rope_dim // 2], sin[..., :rope_dim // 2]
    q_r = apply_rope(q[..., nope:], rc, rs)
    c_kv = rms_norm(x @ p["w_dkv"], p["kv_norm"])  # (B, S, r) bf16
    k_r = apply_rope((x @ p["w_kr"]).reshape(b, s, 1, rope_dim).transpose(1, 2), rc, rs)
    scale = head_dim ** -0.5
    if cache is not None:
        c_kv = write_at(cache["c_kv"], c_kv.to(cache["c_kv"].dtype), cache_pos, dim=1)
        k_r = write_at(cache["k_r"], k_r.to(cache["k_r"].dtype), cache_pos)
        new_cache = {"c_kv": c_kv, "k_r": k_r}
        t, rank = c_kv.shape[1], c_kv.shape[-1]
        w = p["w_ukv"].reshape(rank, num_heads, 2 * nope)
        wk, wv = w[..., :nope], w[..., nope:]
        q_abs = torch.einsum("bhsd,rhd->bhsr", q_n, wk.to(q_n.dtype))
        logits = (torch.einsum("bhsr,btr->bhst", q_abs, c_kv.to(q_abs.dtype))
                  + torch.einsum("bhsd,bltd->bhst", q_r, k_r.to(q_r.dtype))) * scale
        qpos = (int(cache_pos) + torch.arange(s, device=x.device))[:, None]
        mask = torch.arange(t, device=x.device)[None, :] <= qpos
        prob = torch.softmax(logits.masked_fill(~mask, -1e30), dim=-1)  # logits' dtype
        o_lat = torch.einsum("bhst,btr->bhsr", prob, c_kv.to(prob.dtype))
        o = torch.einsum("bhsr,rhd->bhsd", o_lat, wv.to(o_lat.dtype))
    else:
        new_cache = None
        t = c_kv.shape[1]
        kv = (c_kv @ p["w_ukv"]).reshape(b, t, num_heads, 2 * nope).transpose(1, 2)
        # [q_n; q_r] and [k_n; k_r] as the reference concatenates them; the
        # scale stays head_dim ** -0.5
        q_cat = torch.cat([q_n, q_r], dim=-1)
        k_cat = torch.cat([kv[..., :nope], k_r.expand(b, num_heads, t, k_r.shape[-1])], dim=-1)
        o = ops.attention(q_cat, k_cat, kv[..., nope:], causal=causal, scale=scale)
    o = o.transpose(1, 2).reshape(b, s, num_heads * nope)
    return o @ p["wo"], new_cache


# ----------------------------------------------------------------- ffn -----
def swiglu_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor,
               act=F.silu) -> torch.Tensor:
    """Gated MLP ``(act(x Wg) * (x Wu)) Wd``; SwiGLU with the default
    ``act``."""
    return (act(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def gelu_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The encoder FFN, ``gelu(x Wu) Wd`` with the tanh approximation
    (``jax.nn.gelu``'s default)."""
    return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]


def moe_route(p: Dict[str, torch.Tensor], xt: torch.Tensor, *, num_experts: int,
              top_k: int, capacity_factor: float = 1.25) -> Dict[str, torch.Tensor]:
    """GShard top-k routing of token groups ``xt`` (G, Tg, D): ``gates``
    (G, Tg, E) float32 softmax of ``xt @ w_router`` (bf16 tokens times the
    float32 router, in float32); ``idx`` (G, Tg, k) the top-k experts, ties
    to the lower index as ``jax.lax.top_k``; ``gate_vals`` their gates
    renormalised by ``max(sum, 1e-9)``; ``keep`` (G, Tg, k, E) and ``pos``
    (G, Tg, k, E) int32, each (token, slot)'s place in its expert's queue
    in the group, counted over the flattened (token, slot) order, kept
    below the capacity ``cap = max(ceil(Tg k cf / E), k)``; and ``cap``."""
    g, tg, _ = xt.shape
    gates = torch.softmax(xt.float() @ p["w_router"].float(), dim=-1)
    order = torch.sort(gates, dim=-1, descending=True, stable=True)
    gate_vals, idx = order.values[..., :top_k], order.indices[..., :top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    cap = max(int(math.ceil(tg * top_k * capacity_factor / num_experts)), top_k)
    onehot = F.one_hot(idx, num_experts)  # (G, Tg, k, E) int64
    pos = torch.cumsum(onehot.reshape(g, tg * top_k, num_experts), dim=1) - 1
    pos = pos.reshape(g, tg, top_k, num_experts)
    keep = (pos < cap) & (onehot > 0)
    pos = torch.where(keep, pos, 0).to(torch.int32)
    return {"gates": gates, "idx": idx, "gate_vals": gate_vals, "keep": keep,
            "pos": pos, "cap": cap}


def moe_dispatch(xt: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Tokens (G, Tg, D) into their expert slots (G, E, C, D)."""
    return torch.einsum("gtd,gtec->gecd", xt, disp)


def moe_experts(p: Dict[str, torch.Tensor], xe: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU over its slots (G, E, C, D)."""
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["w_gate"]))
    h = h * torch.einsum("gecd,edf->gecf", xe, p["w_up"])
    return torch.einsum("gecf,efd->gecd", h, p["w_down"])


def moe_combine(comb: torch.Tensor, ye: torch.Tensor) -> torch.Tensor:
    """The expert slots' outputs (G, E, C, D) back to tokens (G, Tg, D),
    weighted by their gates."""
    return torch.einsum("gtec,gecd->gtd", comb, ye)


def moe_ffn(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, S, D)
    *,
    num_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    group_size: int = 512,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """GShard-style grouped, capacity-based top-k MoE; ``(out, (mean gates,
    top-1 shares))``.

    Tokens are split into groups of ``group_size`` that route independently
    (``moe_route``); a (token, slot) past its expert's capacity is dropped.
    The bf16 dispatch and combine tensors (G, Tg, E, C) are built slot by
    slot, then four bf16 einsums run dispatch, the experts and combine.
    Routing, dispatch (the slot loop and its einsum), the experts and
    combine are the spans ``lm.moe.route``, ``.dispatch``, ``.experts`` and
    ``.combine``; the counters ``lm.moe.slots_filled`` (kept token slots)
    and ``lm.moe.slots`` (G E C) give the share of capacity used.
    The two per-expert means, each ``(E,)`` float32 over these tokens, make
    the Switch load-balancing loss over the top-1 experts (``moe_aux``, the
    reference's ``aux``); a caller forms it, so that several ranks' means
    can be combined first.  The
    reference's ``constrain_batch`` sharding hints have no counterpart on
    one device and are left out.
    """
    b, s, d = x.shape
    t = b * s
    if t % group_size:
        raise ValueError(f"{t} tokens do not split into groups of {group_size}")
    g = t // group_size
    xt = x.reshape(g, group_size, d)
    with tracing.span("lm.moe.route"):
        r = moe_route(p, xt, num_experts=num_experts, top_k=top_k,
                      capacity_factor=capacity_factor)
    cap = r["cap"]
    tracing.count("lm.moe.slots_filled", r["keep"])
    tracing.count("lm.moe.slots", g * num_experts * cap)
    with tracing.span("lm.moe.dispatch"):
        disp = torch.zeros((g, group_size, num_experts, cap), dtype=x.dtype, device=x.device)
        comb = torch.zeros_like(disp)
        for i in range(top_k):  # k is small; avoids a rank-5 one-hot
            sel = r["keep"][:, :, i].to(x.dtype)  # (G, Tg, E): the slot's kept expert
            # sel times the one-hot of the slot's queue position, as a scatter
            term = torch.zeros_like(disp).scatter_(
                -1, r["pos"][:, :, i, :, None].long(), sel[..., None])
            disp = disp + term
            comb = comb + term * r["gate_vals"][:, :, i][:, :, None, None].to(x.dtype)
        xe = moe_dispatch(xt, disp)
    with tracing.span("lm.moe.experts"):
        ye = moe_experts(p, xe)
    with tracing.span("lm.moe.combine"):
        out = moe_combine(comb, ye).reshape(b, s, d)
    me = r["gates"].mean(dim=(0, 1))
    fe = F.one_hot(r["idx"][..., 0], num_experts).float().mean(dim=(0, 1))
    return out, (me, fe)


def moe_aux(mean_gates: torch.Tensor, top1_share: torch.Tensor) -> torch.Tensor:
    """The Switch load-balancing loss ``E * sum_e mean(gates)_e *
    mean(onehot(top1))_e`` from its two per-expert means over the tokens
    (``layers.py:258-262`` of the JAX package).  It is not additive over
    token subsets: ranks holding parts of a batch average their means
    first."""
    return mean_gates.shape[-1] * (mean_gates * top1_share).sum()


def moe_plain(p: Dict[str, torch.Tensor], x: torch.Tensor, route: Dict[str, torch.Tensor]
              ) -> torch.Tensor:
    """Plain version of ``moe_ffn``'s output, independent of its dispatch
    and combine tensors: for every token and kept slot of ``route`` (the
    router's own ``idx``, ``keep`` and ``gate_vals`` for ``x`` grouped as
    ``moe_ffn`` groups it), ``gate * swiglu_e(x)`` of the slot's expert in
    float32, summed over the slots.  Used by the tests and ``chip_smoke.py``
    only."""
    b, s, d = x.shape
    xf = x.reshape(-1, d).float()
    idx = route["idx"].reshape(xf.shape[0], -1)
    kept = route["keep"].any(-1).reshape(idx.shape)  # (T, k): the slot fit its queue
    gate = route["gate_vals"].reshape(idx.shape)
    y = torch.zeros((*idx.shape, d), dtype=torch.float32, device=x.device)
    for e in range(p["w_gate"].shape[0]):
        tok, slot = torch.nonzero((idx == e) & kept, as_tuple=True)
        if tok.numel():
            h = xf[tok]
            h = F.silu(h @ p["w_gate"][e].float()) * (h @ p["w_up"][e].float())
            y[tok, slot] = (h @ p["w_down"][e].float()) * gate[tok, slot, None]
    return y.sum(1).reshape(b, s, d)


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
