"""Plain float32 reference of a decoder of grouped-query attention and
GShard top-k mixture-of-experts layers (the port's ``("attn", "moe")``
block), its training loss, gradient and AdamW steps.

The layer equations, written out: ``x = embed[tokens]``; per layer
``h = rms(x) * ln1``; ``q, k, v = h Wq, h Wk, h Wv`` split into heads,
rotary position embedding (rotate-half, base ``rope_theta``) on q and k;
causal softmax attention at ``head_dim ** -0.5``, query head ``i``
reading key head ``i // (Hq / Hkv)``; ``x += o Wo``; ``h = rms(x) * ln2``;
the router's softmax over the experts of ``h Wr``, the top ``k`` gates
(ties to the lower index) renormalised; tokens in routing groups of
``moe_group_size``, each (token, slot) placed in its expert's queue in
flattened (token, slot) order and dropped past the capacity ``max(ceil(Tg
k 1.25 / E), k)``; ``x += sum over kept slots of gate * (silu(h Wg) * (h
Wu)) Wd``; the Switch load-balancing term ``E sum_e mean_gate_e *
top1_share_e`` per layer.  Final ``rms(x) * norm``, logits against the
tied embedding over the true vocabulary.

Every product goes through ``precision.matmul``: at ``"float32"`` this is
the reference; at a lower precision it is the control.  Parameters are
the port's tree (``embed``, ``final_norm``, ``blocks[0]`` with leaves
stacked over the layers); their values are taken as float32.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.precision import matmul
from reference.tree import leaves, rebuild

CAPACITY_FACTOR = 1.25
AUX_WEIGHT = 0.01


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of ``x`` (B, H, S, Dh) at positions 0 .. S-1."""
    s, dh = x.shape[2], x.shape[3]
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    c, sn = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * c - x2 * sn, x2 * c + x1 * sn], dim=-1)


def attention(h: torch.Tensor, p: Dict, cfg: Dict, mode: str) -> torch.Tensor:
    """Causal GQA self-attention of one layer, one batch row at a time."""
    b, s, _ = h.shape
    hq, hkv, dh = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q = rope(matmul(h, p["wq"], mode).reshape(b, s, hq, dh).transpose(1, 2), cfg["rope_theta"])
    k = rope(matmul(h, p["wk"], mode).reshape(b, s, hkv, dh).transpose(1, 2), cfg["rope_theta"])
    v = matmul(h, p["wv"], mode).reshape(b, s, hkv, dh).transpose(1, 2)
    rep = hq // hkv
    k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    causal = torch.ones((s, s), dtype=torch.bool, device=h.device).tril()
    rows = []
    for i in range(b):
        sc = matmul(q[i], k[i].transpose(-1, -2), mode) * dh ** -0.5
        pr = torch.softmax(sc.masked_fill(~causal, float("-inf")), dim=-1)
        rows.append(matmul(pr, v[i], mode))
    o = torch.stack(rows).transpose(1, 2).reshape(b, s, hq * dh)
    return matmul(o, p["wo"], mode)


def route(h: torch.Tensor, w_router: torch.Tensor, cfg: Dict, mode: str):
    """Routing of ``h`` (T, D): ``(gates (T, E), idx (T, k), gate values
    (T, k), kept (T, k))`` with the groups' capacity applied."""
    t = h.shape[0]
    e, k, gsz = cfg["num_experts"], cfg["experts_per_token"], min(cfg["moe_group_size"], h.shape[0])
    gates = torch.softmax(matmul(h, w_router, mode), dim=-1)
    order = torch.sort(gates, dim=-1, descending=True, stable=True)
    val, idx = order.values[:, :k], order.indices[:, :k]
    val = val / torch.clamp(val.sum(-1, keepdim=True), min=1e-9)
    cap = max(int(math.ceil(gsz * k * CAPACITY_FACTOR / e)), k)
    onehot = F.one_hot(idx, e).reshape(t // gsz, gsz * k, e)
    pos = (torch.cumsum(onehot, dim=1) - 1).reshape(t, k, e)
    kept = ((pos < cap) & (F.one_hot(idx, e) > 0)).any(-1)
    return gates, idx, val, kept


def moe(h: torch.Tensor, p: Dict, cfg: Dict, mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MoE layer over ``h`` (B, S, D): its output and its aux term."""
    b, s, d = h.shape
    x = h.reshape(-1, d)
    gates, idx, val, kept = route(x, p["w_router"], cfg, mode)
    out = torch.zeros_like(x)
    for ex in range(cfg["num_experts"]):
        tok, slot = torch.nonzero((idx == ex) & kept, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        y = F.silu(matmul(xe, p["w_gate"][ex], mode)) * matmul(xe, p["w_up"][ex], mode)
        y = matmul(y, p["w_down"][ex], mode) * val[tok, slot][:, None]
        out = out.index_add(0, tok, y)
    e = cfg["num_experts"]
    aux = e * (gates.mean(0) * F.one_hot(idx[:, 0], e).float().mean(0)).sum()
    return out.reshape(b, s, d), aux


def layer(x: torch.Tensor, p: Dict, cfg: Dict, mode: str):
    x = x + attention(rms(x, p["ln1"], cfg["norm_eps"]), p["mixer"], cfg, mode)
    f, aux = moe(rms(x, p["ln2"], cfg["norm_eps"]), p["ffn"], cfg, mode)
    return x + f, aux


def layer_params(params: Dict, i: int) -> Dict:
    """Layer ``i``'s slice of the stacked block leaves, as float32."""
    def cut(t):
        if isinstance(t, dict):
            return {k: cut(v) for k, v in t.items()}
        return t[i].to(torch.float32)
    return cut(params["blocks"][0])


def forward(params: Dict, tokens: torch.Tensor, cfg: Dict, mode: str = "float32",
            last_only: bool = False, remat: bool = False):
    """``(logits over the true vocabulary, summed aux)``; with
    ``last_only`` the logits of the last position alone; with ``remat``
    each layer is recomputed in the backward (to fit)."""
    embed = params["embed"].to(torch.float32)
    x = embed[tokens.long()]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg["num_layers"]):
        lp = layer_params(params, i)
        if remat:
            x, a = checkpoint(layer, x, lp, cfg, mode, use_reentrant=False)
        else:
            x, a = layer(x, lp, cfg, mode)
        aux = aux + a
    x = rms(x, params["final_norm"].to(torch.float32), cfg["norm_eps"])
    if last_only:
        x = x[:, -1:]
    logits = matmul(x, embed[: cfg["vocab_size"]].T, mode)
    return logits, aux


def loss(params: Dict, tokens, targets, cfg: Dict, mode: str = "float32") -> torch.Tensor:
    """Mean next-token NLL plus ``AUX_WEIGHT`` times the summed aux."""
    logits, aux = forward(params, tokens, cfg, mode, remat=True)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return nll.mean() + AUX_WEIGHT * aux


def train(params: Dict, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]], cfg: Dict,
          lr: float, max_grad_norm: float = 1.0, mode: str = "float32",
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8, wd: float = 0.1) -> dict:
    """AdamW steps from ``params``, one a batch: ``{"losses", "grad_norms"
    (the first step's clipped gradient per leaf), "change_norms" (per leaf,
    after the last step)}``.  Gradients are clipped to ``max_grad_norm``
    globally; decay applies to leaves of two or more dimensions; each
    leaf's new value is rounded to its stored dtype, as the configuration
    stores it."""
    p0 = leaves(params)
    dtypes = [t.dtype for t in p0]
    flat = [t.to(torch.float32) for t in p0]
    m = [torch.zeros_like(t) for t in flat]
    v = [torch.zeros_like(t) for t in flat]
    losses, grad_norms = [], None
    for step, (tok, tgt) in enumerate(batches, start=1):
        live = [t.clone().requires_grad_(True) for t in flat]
        value = loss(rebuild(params, live), tok, tgt, cfg, mode)
        grads = torch.autograd.grad(value, live, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(flat, grads)]
        losses.append(float(value.detach()))
        del live, value
        gn = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(max_grad_norm / torch.clamp(gn, min=1e-9), max=1.0)
        grads = [g * scale for g in grads]
        if grad_norms is None:
            grad_norms = [float(torch.linalg.vector_norm(g)) for g in grads]
        with torch.no_grad():
            b1c, b2c = 1 - b1 ** step, 1 - b2 ** step
            for i, g in enumerate(grads):
                m[i] = b1 * m[i] + (1 - b1) * g
                v[i] = b2 * v[i] + (1 - b2) * g * g
                delta = (m[i] / b1c) / (torch.sqrt(v[i] / b2c) + eps)
                if flat[i].dim() >= 2:
                    delta = delta + wd * flat[i]
                flat[i] = (flat[i] - lr * delta).to(dtypes[i]).to(torch.float32)
        del grads
    change = [float(torch.linalg.vector_norm(f - q.to(torch.float32))) for f, q in zip(flat, p0)]
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
