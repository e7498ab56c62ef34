"""LM train step: loss -> grad -> clip -> (compress) -> AdamW, the JAX
package's ``repro.train.train_step``.

``build_train_step`` returns a step function over a ``TrainState``;
microbatching (gradient accumulation in ``GRAD_ACCUM_DTYPE``, in
microbatch order) bounds activation memory independently of the global
batch.  The reference's step is one GSPMD program whose meaning is global:
the loss and gradients of the whole batch.  The port runs it eagerly in
one process: with one rank on the mesh's data axes, on the device that
holds the state; with ``n`` data ranks, each rank computes its rows of
every microbatch on its own device, the ranks' gradients are summed in
rank order on ``mesh.ranks[0]`` (where the state lives), and the update
runs there, which gives the one-rank step's loss and gradients up to float
reassociation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import moe_aux
from repro_torch.models.lm import LM, init_params
from repro_torch.train import compress as C
from repro_torch.train._lm_pspecs import data_pspec, data_rank_devices, param_pspecs
from repro_torch.train.hgnn_step import value_and_grad
from repro_torch.train.optim import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm)
from repro_torch.train.tree import flatten_up_to, tree_flatten, tree_map, tree_unflatten

# Gradient-accumulation dtype across microbatches (the reference's
# default); bfloat16 would halve the accumulators' memory at a numerics
# cost.
GRAD_ACCUM_DTYPE = "float32"
AUX_WEIGHT = 0.01


@dataclasses.dataclass
class TrainState:
    """Parameters, AdamW state and the error-feedback residuals of
    gradient compression (``None`` without it); leaves in that order."""

    params: Any
    opt: AdamWState
    residuals: Optional[Any]


def init_train_state(model: LM, seed: int, use_compression: bool = False) -> TrainState:
    """A fresh state from the model's seeded init, on its device."""
    params = model.init(seed)
    return TrainState(params=params, opt=adamw_init(params),
                      residuals=C.init_residuals(params) if use_compression else None)


def state_pspecs(cfg: ArchConfig, state: TrainState, fsdp="data",
                 model_axis_size: int = 16) -> TrainState:
    """The state's partition specs: the parameters' for the parameters,
    the moments and the residuals; the step counter replicated."""
    pspec = param_pspecs(cfg, state.params, fsdp=fsdp, model_axis_size=model_axis_size)
    return TrainState(params=pspec, opt=AdamWState(step=(), mu=pspec, nu=pspec),
                      residuals=pspec if state.residuals is not None else None)


def _tree_add(acc: Any, grads: Any, dtype: torch.dtype) -> Any:
    flat, treedef = tree_flatten(acc)
    return tree_unflatten(treedef, [a + g.to(device=a.device, dtype=dtype)
                                    for a, g in zip(flat, flatten_up_to(treedef, grads))])


def _accumulate(acc: Any, grads: Any, rank: int, dtype: torch.dtype) -> Any:
    """``acc`` plus data rank ``rank``'s gradient tree, each leaf moved to
    ``acc``'s device and cast to ``dtype`` first.  The step calls it rank
    after rank, microbatch after microbatch: a fixed order and no float
    atomics, so a step repeats bit for bit."""
    return _tree_add(acc, grads, dtype)


def aux_share(own: List[Tuple[torch.Tensor, torch.Tensor]], top1_shares: List[torch.Tensor],
              n: int) -> Any:
    """A data rank's share of its microbatch's MoE aux: over the MoE layers,
    ``moe_aux`` of the rank's own mean gates (``LM.loss_terms``) and the
    top-1 shares over all ``n`` ranks' tokens, over ``n``.  ``moe_aux`` is
    linear in the mean gates, and the microbatch's are the ranks' average
    (equal token counts), so the shares add up to the aux of the whole
    microbatch, and each share's gradient is that aux's through the rank's
    own gates (the top-1 shares carry none).  The mean of the ranks' own
    aux values would be neither the one-rank step's aux nor its router
    gradient."""
    aux = 0.0
    for (mean_gates, _), fe in zip(own, top1_shares):
        aux = aux + moe_aux(mean_gates, fe.to(mean_gates.device))
    return aux / n


def _rank_rows(tok, tgt, n: int, global_batch: int, microbatches: int):
    """``rows(j, r) -> (tok, tgt)``: rank ``r``'s rows of microbatch ``j``,
    global rows ``[j B/mb + r B/(mb n), ...)``, from one ``(B, ...)`` tensor
    pair or from the per-rank pairs of ``SyntheticTokens.sharded_batch``
    (rank ``q`` holding rows ``[q B/n, (q + 1) B/n)``).  A microbatch's rank
    slice lies inside one source rank, since ``B/(mb n)`` divides ``B/n``."""
    per = global_batch // (microbatches * n)
    if tgt is None:
        if len(tok) != n:
            raise ValueError(f"the step takes {n} per-rank batches, got {len(tok)}")
        held = global_batch // n

        def rows(j, r):
            start = j * (global_batch // microbatches) + r * per
            t, g = tok[start // held]
            off = start % held
            return t[off:off + per], g[off:off + per]
    else:
        if tok.shape[0] != global_batch:
            raise ValueError(f"the step was built for batch {global_batch}, got {tok.shape[0]}")

        def rows(j, r):
            start = j * (global_batch // microbatches) + r * per
            return tok[start:start + per], tgt[start:start + per]
    return rows


def build_train_step(
    model: LM,
    mesh: Mesh,
    global_batch: int,
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4,
    microbatches: int = 1,
    max_grad_norm: float = 1.0,
    use_compression: bool = False,
    use_embeds: bool = False,
    donate: bool = False,
) -> Tuple[Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]], TrainState]:
    """Returns ``(step_fn, specs)``; ``step_fn(state, tok, tgt) -> (state,
    {"loss", "grad_norm", "lr"})`` with ``tok`` token ids (B, S), or
    embeddings (B, S, D) with ``use_embeds``, and ``tgt`` (B, S); or
    ``step_fn(state, shards)`` with the per-rank ``(tok, tgt)`` pairs of
    ``SyntheticTokens.sharded_batch`` (the counterpart of a sharded global
    array).

    The step: ``value_and_grad`` of ``model.loss`` (aux weight 0.01); with
    ``microbatches > 1`` the batch's rows split into that many consecutive
    microbatches whose losses and gradients are summed in microbatch order
    in ``GRAD_ACCUM_DTYPE`` and divided by ``microbatches``; then
    ``clip_by_global_norm(max_grad_norm)``, ``compress_decompress`` with
    ``use_compression``, and ``adamw_update`` at ``lr(state.opt.step)``
    (or the constant ``lr``).  With ``donate`` (the reference's buffer
    donation, on by default there) the update writes the new parameters and
    moments into the state's own tensors (``adamw_update(inplace=True)``):
    the state passed in is consumed, and the step needs one state's memory
    where the functional update holds two (a 4B-parameter state is 41 GB).
    Off by default, since an eager caller may still read the state it
    passed; the bits are the same either way.

    Over a mesh whose data axes ('pod', 'data'; ``data_pspec``) split the
    batch into ``n > 1`` ranks, microbatch ``j`` is still rows ``[j B/mb,
    (j + 1) B/mb)``, split over the ranks: rank ``r`` runs its ``B/(mb n)``
    rows on its device (``data_rank_devices``), with the parameters copied
    there once a step if that is not ``mesh.ranks[0]``'s device (ranks on
    one device share the tensors).  Every rank's forward runs first
    (``LM.loss_terms``), so the MoE aux is formed from the means over all
    the microbatch's tokens; each rank's backward
    then takes its share of the loss, ``nll_r / n`` plus ``aux_share``.  The ranks' gradients are summed
    in rank order in ``GRAD_ACCUM_DTYPE`` on ``mesh.ranks[0]``, where the
    state lives (``shard_params``) and the update runs.  A MoE model needs
    each rank's tokens to fill whole routing groups (``moe_group_size``),
    as the one-rank forward groups them; other counts raise ``ValueError``.
    """
    cfg = model.cfg
    if global_batch % microbatches:
        raise ValueError(f"batch {global_batch} does not split into {microbatches} microbatches")
    ranks = data_rank_devices(mesh, data_pspec(mesh, global_batch))
    n = len(ranks)
    if n > 1 and global_batch % (microbatches * n):
        raise ValueError(f"batch {global_batch} does not split into {microbatches} "
                         f"microbatches over {n} data ranks")
    dummy_params = init_params(0, cfg, device="meta")
    dummy = TrainState(params=dummy_params, opt=adamw_init(dummy_params),
                       residuals=dummy_params if use_compression else None)
    specs = state_pspecs(cfg, dummy, model_axis_size=int(mesh.shape.get("model", 1)))
    acc_dt = getattr(torch, GRAD_ACCUM_DTYPE)
    has_moe = any(ffn == "moe" for _, ffn in cfg.block_pattern)

    def inputs(tok):
        return {"tokens": None, "embeds": tok} if use_embeds else {"tokens": tok}

    def loss_fn(params, tok, tgt):
        return model.loss(params, targets=tgt, aux_weight=AUX_WEIGHT, **inputs(tok))

    def one_rank(state: TrainState, tok, tgt):
        if microbatches == 1:
            return value_and_grad(lambda p: loss_fn(p, tok, tgt), state.params)
        rows = tok.shape[0] // microbatches
        loss = torch.zeros((), dtype=torch.float32, device=tok.device)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt, device=p.device),
                         state.params)
        for i in range(microbatches):
            sl = slice(i * rows, (i + 1) * rows)
            l_i, (g_i,) = value_and_grad(lambda p: loss_fn(p, tok[sl], tgt[sl]),
                                         state.params)
            loss = loss + l_i
            grads = _tree_add(grads, g_i, acc_dt)
        return loss / microbatches, (tree_map(lambda g: g / microbatches, grads),)

    def microbatch(replicas, rows, j, grads):
        """Microbatch ``j``'s loss, and ``grads`` plus each rank's gradient
        in rank order (each rank's added as soon as its backward ends)."""
        live, parts = [], []
        for r, dev in enumerate(ranks):
            leaves, treedef = tree_flatten(replicas[dev])
            xs = [x.detach().requires_grad_(True) for x in leaves]
            tok, tgt = (t.to(dev) for t in rows(j, r))
            if has_moe and (tok.shape[0] * tok.shape[1]) % cfg.moe_group_size:
                raise ValueError(
                    f"{cfg.name}: a data rank's {tok.shape[0] * tok.shape[1]} tokens of "
                    f"a microbatch do not fill whole MoE routing groups of "
                    f"{cfg.moe_group_size}, so they would group unlike the one-rank step's")
            with torch.enable_grad():
                parts.append(model.loss_terms(tree_unflatten(treedef, xs), targets=tgt,
                                              **inputs(tok)))
            live.append((xs, treedef))
        dev0 = mesh.ranks[0]
        top1 = [sum(f.to(dev0) for _, f in layer) / n
                for layer in zip(*(terms for _, terms in parts))]
        loss = torch.zeros((), dtype=torch.float32, device=dev0)
        for r, ((xs, treedef), (nll, terms)) in enumerate(zip(live, parts)):
            own = nll / n + AUX_WEIGHT * aux_share(terms, top1, n)
            loss = loss + own.detach().to(dev0)
            g = torch.autograd.grad(own, xs, allow_unused=True)
            grads = _accumulate(grads, tree_unflatten(
                treedef, [torch.zeros_like(x) if gi is None else gi for x, gi in zip(xs, g)]),
                r, acc_dt)
            del g
        return loss, grads

    def data_parallel(state: TrainState, tok, tgt):
        rows = _rank_rows(tok, tgt, n, global_batch, microbatches)
        replicas = {dev: tree_map(lambda p: p.to(dev), state.params) for dev in set(ranks)}
        dev0 = mesh.ranks[0]
        loss = torch.zeros((), dtype=torch.float32, device=dev0)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt, device=dev0),
                         state.params)
        for j in range(microbatches):
            l_j, grads = microbatch(replicas, rows, j, grads)
            loss = loss + l_j
        return loss / microbatches, (tree_map(lambda g: g / microbatches, grads),)

    def step(state: TrainState, tok, tgt=None):
        if n == 1:
            if tgt is None:
                (tok, tgt), = tok
            loss, (grads,) = one_rank(state, tok, tgt)
        else:
            loss, (grads,) = data_parallel(state, tok, tgt)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        residuals = state.residuals
        if use_compression:
            grads, residuals = C.compress_decompress(grads, residuals)
        lr_t = lr(state.opt.step) if callable(lr) else lr
        new_params, new_opt = adamw_update(grads, state.opt, state.params, lr_t,
                                           inplace=donate)
        return (TrainState(params=new_params, opt=new_opt, residuals=residuals),
                {"loss": loss, "grad_norm": gnorm,
                 "lr": torch.as_tensor(lr_t, dtype=torch.float32)})

    return step, specs
