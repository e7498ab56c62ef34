"""Cells as callables with their inputs: the JAX package's ``input_specs``
and ``build_cell_fn`` (``repro/launch/dryrun.py:116-271``) for real tensors.

The reference builds each (arch x shape) cell as a jitted function and
``ShapeDtypeStruct`` stand-ins for its arguments, sharded over the mesh,
for XLA to lower.  Here a cell is an eager function and its arguments are
seeded tensors on the mesh's device (``mesh.ranks[0]``, where the port's
train step keeps its state), or shapes alone on a mesh of ``meta`` ranks:

  * ``train``: ``build_train_step``'s step with a fresh ``TrainState``,
    tokens and targets from ``SyntheticTokens`` (step 0);
  * ``prefill``: ``LM.forward(last_only=True)``, the serving prefill's
    last-position logits;
  * ``decode``: one step of one new token against ``init_cache(B, S)`` at
    ``cache_pos = S - 1``, the cache written in place (the reference
    donates it).

A model fed embeddings (``cfg.frontend != "none"``: the audio and vision
stubs) takes frames that carry the token ids: the rows of a bf16 table
drawn from ``seed``, one per id, so that a train step's targets follow its
inputs.  ``spec`` may be a ``dataclasses.replace`` of a ``SHAPES`` entry
with a cut ``global_batch``.  The reference's GSPMD hints
(``ATTN_SHARDING``, ``BATCH_AXES``) have no counterpart: the port's mesh
places ranks, it does not partition a program.

Example::

    spec = dataclasses.replace(SHAPES["prefill_32k"], global_batch=4)
    fn, args = build_cell_fn(get_config("smollm-135m"), spec, mesh)
    logits = fn(*args)  # (4, 1, padded vocab)
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import SHAPES, ArchConfig, ShapeSpec
from repro_torch.models.lm import LM
from repro_torch.train._lm_pspecs import cache_pspecs
from repro_torch.train.data import SyntheticTokens
from repro_torch.train.train_step import build_train_step, init_train_state

TRAIN_LR = 1e-3  # the reference cell's rate (dryrun.py:175)


def _microbatches(cfg: ArchConfig, spec: ShapeSpec, mesh: Mesh) -> int:
    """One batch row per data shard per microbatch (bounds activations +
    full-vocab logits independently of model size)."""
    dp_total = int(np.prod([mesh.shape[a] for a in ("pod", "data")
                            if a in mesh.axis_names]))
    return max(1, spec.global_batch // dp_total)


def frame_embeddings(cfg: ArchConfig, tokens: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """bf16 frames ``(B, S, d_model)`` for a model fed embeddings: row ``i``
    of a ``(vocab, d_model)`` table drawn from ``seed`` (on the CPU) for
    each id ``i`` of ``tokens``, on ``tokens``' device."""
    table = torch.randn((cfg.vocab_size, cfg.d_model),
                        generator=torch.Generator().manual_seed(seed))
    return table.to(torch.bfloat16).to(tokens.device)[tokens.long()]


def input_specs(cfg: Union[str, ArchConfig], spec: Union[str, ShapeSpec], mesh: Mesh,
                model: Optional[LM] = None, seed: int = 0) -> Dict[str, Any]:
    """Every model input of a cell on the mesh's device: ``spec`` and
    ``use_embeds``; for train and prefill ``tokens`` (ids (B, S) int32, or
    frames (B, S, D) bf16 for a model fed embeddings) and ``targets`` (B,
    S); for decode ``tokens`` (B, 1), the cache of ``init_cache(B, S)``
    (zeros), its ``cache_specs`` and ``cache_pos = S - 1``.  Seeded
    (``SyntheticTokens(..., seed)`` step 0; the decode token is that
    batch's id at position S - 1); zeros of the shapes on ``meta``."""
    cfg = get_config(cfg) if isinstance(cfg, str) else cfg
    spec = SHAPES[spec] if isinstance(spec, str) else spec
    dev = mesh.ranks[0]
    b, s = spec.global_batch, spec.seq_len
    use_embeds = cfg.frontend != "none"
    out: Dict[str, Any] = {"spec": spec, "use_embeds": use_embeds}
    if dev.type == "meta":
        tok = torch.zeros((b, s), dtype=torch.int32, device=dev)
        tgt = torch.zeros((b, s), dtype=torch.int32, device=dev)
    else:
        tok_np, tgt_np = SyntheticTokens(cfg.vocab_size, s, b, seed=seed).host_batch(0)
        tok = torch.from_numpy(np.ascontiguousarray(tok_np)).to(dev)
        tgt = torch.from_numpy(np.ascontiguousarray(tgt_np)).to(dev)
    if spec.kind in ("train", "prefill"):
        if use_embeds:
            out["tokens"] = (torch.zeros((b, s, cfg.d_model), dtype=torch.bfloat16, device=dev)
                             if dev.type == "meta" else frame_embeddings(cfg, tok, seed))
        else:
            out["tokens"] = tok
        out["targets"] = tgt
    else:  # decode: one new token against a seq_len cache (a copy: a view
        # would hold the whole (B, S) batch of ids on the device)
        out["tokens"] = tok[:, s - 1:].clone()
        m = model if model is not None else LM(cfg, device=dev)
        out["cache"] = m.init_cache(b, s)
        out["cache_specs"] = cache_pspecs(cfg, out["cache"], mesh, b)
        out["cache_pos"] = s - 1
    return out


def build_cell_fn(cfg: ArchConfig, spec: ShapeSpec, mesh: Mesh,
                  microbatches: Optional[int] = None, seed: int = 0
                  ) -> Tuple[Callable[..., Any], Tuple]:
    """``(fn, args)`` of one cell; ``fn(*args)`` runs it.  ``fn.model`` is
    its ``LM`` (remat full, as the reference's) and ``fn.microbatches`` the
    train step's microbatch count (default one batch row per data shard,
    the reference's ``_microbatches``; 1 off train).

      * train: ``fn(state, tokens, targets) -> (state, metrics)``, the
        step of ``build_train_step`` at lr 1e-3;
      * prefill: ``fn(params, tokens) -> logits (B, 1, padded vocab)``;
      * decode: ``fn(params, tokens, cache, cache_pos) -> (logits (B, 1,
        padded vocab), cache)``, the cache updated in place."""
    dev = mesh.ranks[0]
    model = LM(cfg, device=dev, remat="full")
    ins = input_specs(cfg, spec, mesh, model=model, seed=seed)

    def kw(tok):
        return {"tokens": None, "embeds": tok} if ins["use_embeds"] else {"tokens": tok}

    if spec.kind == "train":
        mb = microbatches if microbatches is not None else _microbatches(cfg, spec, mesh)
        step_fn, _ = build_train_step(model, mesh, spec.global_batch, lr=TRAIN_LR,
                                      microbatches=mb, use_embeds=ins["use_embeds"])

        def fn(state, tok, tgt):
            return step_fn(state, tok, tgt)

        args: Tuple = (init_train_state(model, seed), ins["tokens"], ins["targets"])
    elif spec.kind == "prefill":
        mb = 1

        def fn(params, tok):
            return model.forward(params, last_only=True, **kw(tok))[0]

        args = (model.init(seed), ins["tokens"])
    else:
        mb = 1

        def fn(params, tok, cache, cache_pos):
            logits, cache, _ = model.forward(params, tokens=tok, cache=cache,
                                             cache_pos=cache_pos)
            return logits, cache

        args = (model.init(seed), ins["tokens"], ins["cache"], ins["cache_pos"])
    fn.model, fn.microbatches = model, mb
    return fn, args
