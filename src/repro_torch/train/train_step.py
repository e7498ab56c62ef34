"""LM train step: loss -> grad -> clip -> (compress) -> AdamW, the JAX
package's ``repro.train.train_step``.

``build_train_step`` returns a step function over a ``TrainState``;
microbatching (gradient accumulation in ``GRAD_ACCUM_DTYPE``, in
microbatch order) bounds activation memory independently of the global
batch.  The step runs eagerly on the device that holds the state: a mesh
whose ranks all sit on one device runs it there.  Data parallelism over
more than one rank is ROADMAP slice 14.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import LM, init_params
from repro_torch.train import compress as C
from repro_torch.train._lm_pspecs import param_pspecs
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
    return tree_unflatten(treedef, [a + g.to(dtype)
                                    for a, g in zip(flat, flatten_up_to(treedef, grads))])


def build_train_step(
    model: LM,
    mesh: Mesh,
    global_batch: int,
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4,
    microbatches: int = 1,
    max_grad_norm: float = 1.0,
    use_compression: bool = False,
    use_embeds: bool = False,
    donate: bool = True,
) -> Tuple[Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]], TrainState]:
    """Returns ``(step_fn, specs)``; ``step_fn(state, tok, tgt) -> (state,
    {"loss", "grad_norm", "lr"})`` with ``tok`` token ids (B, S), or
    embeddings (B, S, D) with ``use_embeds``, and ``tgt`` (B, S).

    The step: ``value_and_grad`` of ``model.loss`` (aux weight 0.01); with
    ``microbatches > 1`` the batch's rows split into that many consecutive
    microbatches whose losses and gradients are summed in microbatch order
    in ``GRAD_ACCUM_DTYPE`` and divided by ``microbatches``; then
    ``clip_by_global_norm(max_grad_norm)``, ``compress_decompress`` with
    ``use_compression``, and ``adamw_update`` at ``lr(state.opt.step)``
    (or the constant ``lr``).  The step builds new tensors, so ``donate``
    (the reference's buffer donation) changes nothing here.

    ``mesh`` must put every rank on one device and have one rank on its
    data axes ('pod', 'data'); more raise ``NotImplementedError`` (ROADMAP
    slice 14).
    """
    n_data = math.prod(n for a, n in mesh.shape.items() if a in ("pod", "data"))
    if n_data > 1:
        raise NotImplementedError(
            f"the port's LM train step runs one data rank; mesh {dict(mesh.shape)} has "
            f"{n_data} on its data axes (data parallelism over ranks is ROADMAP slice 14)")
    if len(set(mesh.ranks)) > 1:
        raise NotImplementedError(
            f"the port's LM train step runs on one device; mesh {dict(mesh.shape)} "
            f"spans {sorted(set(map(str, mesh.ranks)))} (ROADMAP slice 14)")
    if global_batch % microbatches:
        raise ValueError(f"batch {global_batch} does not split into {microbatches} microbatches")
    dummy_params = init_params(0, model.cfg, device="meta")
    dummy = TrainState(params=dummy_params, opt=adamw_init(dummy_params),
                       residuals=dummy_params if use_compression else None)
    specs = state_pspecs(model.cfg, dummy, model_axis_size=int(mesh.shape.get("model", 1)))
    acc_dt = getattr(torch, GRAD_ACCUM_DTYPE)

    def loss_fn(params, tok, tgt):
        if use_embeds:
            return model.loss(params, None, tgt, embeds=tok, aux_weight=AUX_WEIGHT)
        return model.loss(params, tok, tgt, aux_weight=AUX_WEIGHT)

    def step(state: TrainState, tok, tgt):
        if microbatches == 1:
            loss, (grads,) = value_and_grad(lambda p: loss_fn(p, tok, tgt), state.params)
        else:
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
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        residuals = state.residuals
        if use_compression:
            grads, residuals = C.compress_decompress(grads, residuals)
        lr_t = lr(state.opt.step) if callable(lr) else lr
        new_params, new_opt = adamw_update(grads, state.opt, state.params, lr_t)
        return (TrainState(params=new_params, opt=new_opt, residuals=residuals),
                {"loss": loss, "grad_norm": gnorm,
                 "lr": torch.as_tensor(lr_t, dtype=torch.float32)})

    return step, specs
