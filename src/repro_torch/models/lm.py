"""Config-driven LM: init, forward (prefill with the kernels, decode with a
cache) and the cache layout.

Parameters are the JAX package's pytree as dicts of tensors: ``embed``,
``final_norm`` and ``blocks``, a list over the block pattern's positions of
dicts whose leaves lead with ``num_groups`` (one slice per layer group).
The forward walks the groups in a Python loop (the reference's
``lax.scan``).  The cache is stacked the same way and updated in place.

Every mixer (``attn``, ``local``, ``mla``, ``ssm``) and FFN (``mlp``,
``gelu_mlp``, ``moe``, ``none``) of the shipped configs runs, from token ids
or from ``embeds`` (the audio and vision frontends' stubs), with M-RoPE
positions ``pos3`` where the config has sections.

The forward records autograd when grad is enabled and a parameter (or
``embeds``) requires it, and runs in inference mode otherwise (serving,
decode).  Training follows the reference's gradient: K4 and K5 forward in
their autograd Functions (float32 autograd of the plain versions
backward), the embedding's gradient as a one-hot contraction
(``EmbedLookup``), and ``remat`` as the reference's ``jax.checkpoint`` of
each layer group.  ``LM.loss`` is the reference's next-token loss;
``LM.loss_terms`` leaves the MoE aux as per-layer means, for a
data-parallel step to combine over its ranks.  Under the
``"cp_zigzag_native"`` attention route (``ops.ATTN_IMPL``) a cache-less
forward takes its sequence in zigzag chunk order and gives RoPE the
logical positions, as the reference does.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import tracing
from repro_torch.kernels import ops
from repro_torch.kernels.cp_attention import zigzag_positions
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

MIXERS = ("attn", "local", "mla", "ssm")
SSD_CHUNK = 128  # the SSD scan's chunk, the reference's LM default
FFNS = ("mlp", "gelu_mlp", "moe", "none")
REMATS = ("none", "full", "dots")


def padded_vocab(cfg: ArchConfig, multiple: int = 128) -> int:
    """Vocab rounded up to ``multiple`` (logits beyond ``vocab_size`` are
    masked to -1e30; padded embedding rows are never gathered)."""
    return -(-cfg.vocab_size // multiple) * multiple


def _check_supported(cfg: ArchConfig) -> None:
    for mixer, ffn in cfg.block_pattern:
        if mixer not in MIXERS:
            raise ValueError(f"unknown mixer {mixer!r} ({cfg.name})")
        if ffn not in FFNS:
            raise ValueError(f"unknown ffn {ffn!r} ({cfg.name})")


def _init_block(gen: torch.Generator, cfg: ArchConfig, mixer: str, ffn: str,
                device) -> Dict:
    g, d = cfg.num_groups, cfg.d_model

    def dense(shape, scale=0.02):
        w = torch.randn((g, *shape), generator=gen, device=device) * scale
        return w.to(torch.bfloat16)

    def const(n, value):
        return torch.full((g, n), value, dtype=torch.float32, device=device)

    norm0 = 0.0 if cfg.gemma_norms else 1.0
    p: Dict[str, Any] = {"ln1": const(d, norm0), "ln2": const(d, norm0)}
    if cfg.gemma_norms:
        p["ln1_post"] = const(d, 0.0)
        p["ln2_post"] = const(d, 0.0)
    depth_scale = 0.02 / max(1.0, (2 * cfg.num_layers) ** 0.5)
    if mixer in ("attn", "local"):
        p["mixer"] = {
            "wq": dense((d, cfg.num_heads * cfg.head_dim)),
            "wk": dense((d, cfg.num_kv_heads * cfg.head_dim)),
            "wv": dense((d, cfg.num_kv_heads * cfg.head_dim)),
            "wo": dense((cfg.num_heads * cfg.head_dim, d), depth_scale),
        }
    elif mixer == "mla":
        nope = cfg.head_dim - cfg.mla_rope_dim
        p["mixer"] = {
            "wq": dense((d, cfg.num_heads * cfg.head_dim)),
            "w_dkv": dense((d, cfg.mla_kv_rank)),
            "kv_norm": const(cfg.mla_kv_rank, 1.0),
            "w_kr": dense((d, cfg.mla_rope_dim)),
            "w_ukv": dense((cfg.mla_kv_rank, cfg.num_heads * 2 * nope)),
            "wo": dense((cfg.num_heads * nope, d), depth_scale),
        }
    else:  # ssm
        h, di, cd = cfg.ssm_heads, cfg.d_inner, cfg.conv_dim
        p["mixer"] = {
            "w_in": dense((d, 2 * di + 2 * cfg.ssm_groups * cfg.ssm_state + h)),
            "dt_bias": const(h, 0.0),
            "a_log": const(h, 0.0),  # A = -exp(0) = -1
            "w_conv": torch.randn((g, cfg.conv_width, cd), generator=gen,
                                  device=device) * 0.2,
            "b_conv": const(cd, 0.0),
            "norm": const(di, 1.0),
            "w_out": dense((di, d), depth_scale),
        }
    if ffn in ("mlp", "gelu_mlp"):
        p["ffn"] = {
            "w_gate": dense((d, cfg.d_ff)),
            "w_up": dense((d, cfg.d_ff)),
            "w_down": dense((cfg.d_ff, d), depth_scale),
        }
        if ffn == "gelu_mlp":  # the encoder FFN has no gate
            p["ffn"].pop("w_gate")
    elif ffn == "moe":
        e, f = cfg.num_experts, cfg.moe_d_ff
        p["ffn"] = {
            "w_router": dense((d, e)).float(),  # bf16 values held in float32
            "w_gate": dense((e, d, f)),
            "w_up": dense((e, d, f)),
            "w_down": dense((e, f, d), depth_scale),
        }
    return p


def init_params(seed: int, cfg: ArchConfig, device="cuda") -> Dict:
    """The port's own init from ``seed`` (a ``torch.Generator`` on
    ``device``): the reference's keys, shapes, dtypes and scales, its
    values not (``jax.random`` cannot be reproduced).  On the ``"meta"``
    device (no generator there) it gives the tree's shapes and dtypes
    without allocating, for partition specs."""
    _check_supported(cfg)
    gen = (None if torch.device(device).type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    vp = padded_vocab(cfg)
    params: Dict[str, Any] = {
        "embed": (torch.randn((vp, cfg.d_model), generator=gen, device=device)
                  * 0.02).to(torch.bfloat16),
        "final_norm": torch.full((cfg.d_model,), 0.0 if cfg.gemma_norms else 1.0,
                                 dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = (torch.randn((cfg.d_model, vp), generator=gen, device=device)
                             * 0.02).to(torch.bfloat16)
    params["blocks"] = [_init_block(gen, cfg, mixer, ffn, device)
                        for mixer, ffn in cfg.block_pattern]
    return params


def lm_params_from_numpy(tree, device) -> Any:
    """The JAX package's LM parameters (``jax.tree.map(np.asarray, ...)``)
    as tensors on ``device``, keys, nesting and dtypes unchanged.  bfloat16
    arrays (numpy dtype ``bfloat16`` from ``ml_dtypes``) cross as their
    ``uint16`` bits, bit for bit."""
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [lm_params_from_numpy(v, device) for v in tree]
    arr = np.array(tree, order="C")  # a copy; 0-d stays 0-d
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _positions_cos_sin(cfg: ArchConfig, positions: torch.Tensor,
                       pos3: Optional[torch.Tensor] = None):
    """RoPE tables for ``positions`` (B, S); M-RoPE where the config has
    sections, from ``pos3`` (3, B, S) or, without it, the positions
    broadcast over the three components."""
    if cfg.mrope_sections is not None:
        if pos3 is None:
            pos3 = positions[None].expand(3, *positions.shape)
        return L.mrope_cos_sin(pos3, cfg.mrope_sections, cfg.head_dim, cfg.rope_theta)
    return L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)


def _block_apply(cfg: ArchConfig, mixer: str, ffn: str, p: Dict, x: torch.Tensor,
                 cos, sin, cache: Optional[Dict], cache_pos, ssd_chunk: int
                 ) -> Tuple[torch.Tensor, Any]:
    """One layer; ``(x, terms)`` with a MoE layer's two per-expert means
    (``L.moe_ffn``), ``None`` without MoE."""
    gn = cfg.gemma_norms
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps, plus_one=gn)
    if mixer in ("attn", "local"):
        o, _ = L.gqa_attention(
            p["mixer"], h, cos, sin,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, causal=cfg.causal,
            window=cfg.sliding_window if mixer == "local" else None,
            softcap=cfg.attn_softcap, q_scale=cfg.q_scale,
            cache=cache, cache_pos=cache_pos)
    elif mixer == "mla":
        o, _ = L.mla_attention(
            p["mixer"], h, cos, sin,
            num_heads=cfg.num_heads, head_dim=cfg.head_dim,
            rope_dim=cfg.mla_rope_dim, causal=cfg.causal,
            cache=cache, cache_pos=cache_pos)
    else:  # ssm
        o, _ = L.mamba2_mixer(
            p["mixer"], h,
            num_heads=cfg.ssm_heads, head_dim=cfg.ssm_head_dim,
            state_dim=cfg.ssm_state, num_groups=cfg.ssm_groups,
            conv_width=cfg.conv_width, chunk=ssd_chunk, state=cache)
    if gn:
        o = L.rms_norm(o, p["ln1_post"], cfg.norm_eps, plus_one=True)
    x = x + o.to(x.dtype)

    terms = None
    if ffn != "none":
        h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps, plus_one=gn)
        if ffn == "mlp":
            f = L.swiglu_mlp(p["ffn"], h2)
        elif ffn == "gelu_mlp":
            f = L.gelu_mlp(p["ffn"], h2)
        else:
            f, terms = L.moe_ffn(
                p["ffn"], h2, num_experts=cfg.num_experts, top_k=cfg.experts_per_token,
                group_size=min(cfg.moe_group_size, h2.shape[0] * h2.shape[1]))
        if gn:
            f = L.rms_norm(f, p["ln2_post"], cfg.norm_eps, plus_one=True)
        x = x + f.to(x.dtype)
    return x, terms


def _unbind_groups(tree, n: int) -> List:
    """The ``n`` layer groups' slices of a stacked dict, as views.  One
    ``unbind`` per leaf, so the backward stacks each leaf's gradient once
    instead of adding a full-size zero tensor per group."""
    if isinstance(tree, dict):
        per_key = {k: _unbind_groups(v, n) for k, v in tree.items()}
        return [{k: per_key[k][g] for k in tree} for g in range(n)]
    return list(tree.unbind(0))


class EmbedLookup(torch.autograd.Function):
    """``embed[tokens]`` with the reference's VJP (``repro/models/lm.py::
    _embed_lookup``): the gradient is the one-hot contraction ``onehot(
    tokens)ᵀ dy`` in ``dy``'s dtype, cast to the embedding's, a matmul
    rather than a scatter-add (no float atomics; repeats bit for bit)."""

    @staticmethod
    def forward(ctx, embed, tokens):
        ctx.save_for_backward(tokens)
        ctx.vocab, ctx.dtype = embed.shape[0], embed.dtype
        return embed[tokens]

    @staticmethod
    def backward(ctx, dy):
        (tokens,) = ctx.saved_tensors
        flat = tokens.reshape(-1)
        dy = dy.reshape(flat.shape[0], -1)
        onehot = dy.new_zeros((flat.shape[0], ctx.vocab))
        onehot[torch.arange(flat.shape[0], device=dy.device), flat] = 1
        return (onehot.T @ dy).to(ctx.dtype), None


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of matmuls without batch
    dimensions (``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``),
    recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _leaves(tree) -> List:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _records_grad(params, embeds) -> bool:
    """Whether a forward records autograd: grad enabled and a parameter (or
    ``embeds``) requiring it."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in _leaves(params) + [embeds] if t is not None)


def _mean_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The mean next-token NLL of ``targets`` under the float32 log-softmax."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return nll.mean()


class LM:
    """Bound (config, device) bundle; parameters stay an explicit dict.

    ``device`` (default ``"cuda"``) is where ``init`` and ``init_cache``
    put their tensors; a CUDA device without a card raises.  ``remat``
    applies to a forward that records autograd, per layer group as the
    reference's ``jax.checkpoint(group_body)``: ``"none"`` keeps every
    activation, ``"full"`` keeps the group's input and recomputes the group
    in the backward (``torch.utils.checkpoint``; K4 and K5 launch again),
    ``"dots"`` keeps the outputs of matmuls without batch dimensions and
    recomputes the rest.

    Example::

        model = LM(get_config("smollm-135m"))
        params = model.init(0)
        logits, _, _ = model.forward(params, tokens, last_only=True)
    """

    def __init__(self, cfg: ArchConfig, device="cuda", remat: str = "full",
                 ssd_chunk: int = SSD_CHUNK):
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"LM device={device!r} but no CUDA device is "
                               "available (pass device='cpu' to run on the CPU)")
        _check_supported(cfg)
        if remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.remat = remat
        self.ssd_chunk = ssd_chunk

    def init(self, seed: int) -> Dict:
        """Parameters from ``seed`` on the model's device (see
        :func:`init_params`)."""
        return init_params(seed, self.cfg, device=self.device)

    # ---------------------------------------------------------- forward ----
    def forward(
        self,
        params: Dict,
        tokens: Optional[torch.Tensor] = None,  # (B, S) integer ids
        embeds: Optional[torch.Tensor] = None,
        pos3: Optional[torch.Tensor] = None,
        cache: Optional[List[Dict]] = None,
        cache_pos=None,
        last_only: bool = False,  # serving prefill: logits for the last position only
    ) -> Tuple[torch.Tensor, Optional[List[Dict]], torch.Tensor]:
        """Returns ``(logits, cache, aux)``: float32 logits ``(B, S or 1,
        padded vocab)``, the cache (updated in place; ``None`` without
        one) and the float32 MoE aux loss summed over the layers (0 without
        MoE).  The input is ``tokens`` (B, S) or ``embeds`` (B, S, D), cast
        to bf16 with no gemma scaling; ``pos3`` (3, B, S) gives M-RoPE's
        position components (default: the positions on all three).  The
        call is the span ``lm.forward``: a request's root."""
        train = _records_grad(params, embeds)
        with (contextlib.nullcontext() if train else torch.inference_mode()), \
                tracing.span("lm.forward"):
            logits, cache, terms = self._forward(params, tokens, embeds, pos3, cache,
                                                 cache_pos, last_only, train)
            aux = torch.zeros((), dtype=torch.float32, device=logits.device)
            for mean_gates, top1_share in terms:
                aux = aux + L.moe_aux(mean_gates, top1_share)
            return logits, cache, aux

    def _group_fn(self, cos, sin, cache_pos):
        """One layer group ``(x, params of its pattern positions, their
        caches) -> (x, terms)``, ``terms`` its MoE layers' per-expert means."""
        cfg = self.cfg

        def body(x, gp, gc):
            terms = []
            for pos, (mixer, ffn) in enumerate(cfg.block_pattern):
                x, t = _block_apply(cfg, mixer, ffn, gp[pos], x, cos, sin,
                                    gc[pos] if gc is not None else None, cache_pos,
                                    self.ssd_chunk)
                if t is not None:
                    terms.append(t)
            return x, terms

        return body

    def _forward(self, params, tokens, embeds, pos3, cache, cache_pos, last_only, train):
        """``(logits, cache, terms)``, ``terms`` every MoE layer's ``(mean
        gates, top-1 shares)`` in layer order (empty without MoE)."""
        cfg = self.cfg
        if embeds is None:
            x = EmbedLookup.apply(params["embed"], tokens.long()).to(torch.bfloat16)
            if cfg.gemma_norms:
                x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
        else:
            x = embeds.to(torch.bfloat16)
        b, s = x.shape[0], x.shape[1]
        start = int(cache_pos) if cache_pos is not None else 0
        if ops.ATTN_IMPL == "cp_zigzag_native" and cache is None and s % 32 == 0:
            # a sequence stored in zigzag chunk order: RoPE takes the logical
            # positions (the reference's lm.py:246-252)
            positions = torch.from_numpy(zigzag_positions(s, ops.CP_P_SHARDS)).to(x.device)
        else:
            positions = start + torch.arange(s, device=x.device)
        positions = positions[None, :].expand(b, s)
        cos, sin = _positions_cos_sin(cfg, positions, pos3)
        n = cfg.num_groups
        per_pos = [_unbind_groups(blk, n) for blk in params["blocks"]]
        groups = [[gp[g] for gp in per_pos] for g in range(n)]
        # the caches' group slices by select (views updated in place)
        caches = ([[{k: v[g] for k, v in c.items()} for c in cache] for g in range(n)]
                  if cache is not None else [None] * n)
        body = self._group_fn(cos, sin, cache_pos)
        remat = self.remat if train and cache is None else "none"
        if remat != "none":  # the backward's recompute takes this forward's route
            body = ops.replaying_route(body)
        terms = []
        for g in range(n):
            if remat == "none":
                x, a = body(x, groups[g], caches[g])
            elif remat == "full":
                x, a = checkpoint(body, x, groups[g], None, use_reentrant=False)
            else:
                x, a = checkpoint(body, x, groups[g], None, use_reentrant=False,
                                  context_fn=functools.partial(
                                      create_selective_checkpoint_contexts, _dots_policy))
            terms += a
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps, plus_one=cfg.gemma_norms)
        if last_only:
            x = x[:, -1:]
        unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        logits = (x @ unembed.to(x.dtype)).float()
        if cfg.final_softcap is not None:
            logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
        if logits.shape[-1] != cfg.vocab_size:  # mask vocab padding
            pad = torch.arange(logits.shape[-1], device=x.device) >= cfg.vocab_size
            logits = logits.masked_fill(pad, -1e30)
        return logits, cache, terms

    def loss(self, params, tokens, targets, embeds=None, pos3=None,
             aux_weight: float = 0.01) -> torch.Tensor:
        """The reference's training loss (``repro/models/lm.py::LM.loss``):
        the mean next-token NLL of ``targets`` (B, S) under the float32
        log-softmax of the padded-vocab logits, plus ``aux_weight`` times
        the MoE aux loss.  Differentiable in ``params`` when they require
        grad."""
        logits, _, aux = self.forward(params, tokens=tokens, embeds=embeds, pos3=pos3)
        return _mean_nll(logits, targets) + aux_weight * aux

    def loss_terms(self, params, tokens, targets, embeds=None, pos3=None
                   ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
        """``loss`` before the MoE aux is formed: ``(mean NLL, terms)``,
        ``terms`` every MoE layer's ``(mean gates, top-1 shares)`` over these
        tokens, in layer order (``L.moe_aux`` of a pair is the layer's aux).
        A data-parallel step averages each pair over the ranks before
        ``moe_aux``, which makes the aux the one-rank step's."""
        train = _records_grad(params, embeds)
        with contextlib.nullcontext() if train else torch.inference_mode():
            logits, _, terms = self._forward(params, tokens, embeds, pos3, None, None,
                                             False, train)
            return _mean_nll(logits, targets), terms

    # ------------------------------------------------------------ cache ----
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> List[Dict]:
        """Stacked cache: one entry per pattern position, leaves with a
        leading ``num_groups`` dim (as the parameters): ``{"k", "v"}`` of
        (B, Hkv, T, Dh) for attention, MLA's latent ``{"c_kv": (B, T, r),
        "k_r": (B, 1, T, rope)}``, and ``{"conv", "ssm"}`` for Mamba2 (its
        SSM state in float32)."""
        cfg = self.cfg
        g = cfg.num_groups
        dev = self.device
        cache = []
        for mixer, _ in cfg.block_pattern:
            if mixer in ("attn", "local"):
                kv = (g, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
                cache.append({"k": torch.zeros(kv, dtype=dtype, device=dev),
                              "v": torch.zeros(kv, dtype=dtype, device=dev)})
            elif mixer == "mla":
                cache.append({
                    "c_kv": torch.zeros((g, batch, max_len, cfg.mla_kv_rank),
                                        dtype=dtype, device=dev),
                    "k_r": torch.zeros((g, batch, 1, max_len, cfg.mla_rope_dim),
                                       dtype=dtype, device=dev),
                })
            else:  # ssm
                cache.append({
                    "conv": torch.zeros((g, batch, cfg.conv_width - 1, cfg.conv_dim),
                                        dtype=dtype, device=dev),
                    "ssm": torch.zeros((g, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                        cfg.ssm_state), dtype=torch.float32, device=dev),
                })
        return cache


def make_model(cfg: ArchConfig, device="cuda", remat: str = "full") -> LM:
    """An :class:`LM` for ``cfg`` on ``device``."""
    return LM(cfg, device=device, remat=remat)
