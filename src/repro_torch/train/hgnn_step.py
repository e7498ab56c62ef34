"""Semi-supervised HGNN training on either NA executor, as the JAX
package's ``repro.train.hgnn_step`` trains.

The task is node classification: a full-graph forward, cross-entropy on a
masked train split, accuracy on held-out splits.  One step is one
``value_and_grad`` of ``HGNN.execute_loss`` and one AdamW update.  On the
banded executor the gradients flow through the NA kernels'
``torch.autograd.Function``s (the reference's VJPs; K1 runs their
transposes on a CUDA device), so the same semantic-graph batches serve
every step.  The reference jits the step; here it runs eagerly (CUDA-graph
capture is ROADMAP M4a).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.hgnn.models import params_from_numpy
from repro_torch.train.optim import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm, warmup_cosine)
from repro_torch.train.tree import tree_flatten, tree_unflatten


@dataclasses.dataclass
class HGNNTrainState:
    """Parameters and optimizer state; leaves in the order (params, opt)."""

    params: Any
    opt: AdamWState


def init_train_state(model, seed: int, device="cuda") -> HGNNTrainState:
    """A fresh state from the port's seeded init (``HGNN.init``)."""
    params = model.init(int(seed), device=device)
    return HGNNTrainState(params=params, opt=adamw_init(params))


def train_state_from_numpy(params, device) -> HGNNTrainState:
    """A fresh state from a numpy parameter tree (for example the JAX
    package's, after ``jax.tree.map(np.asarray, ...)``)."""
    p = params_from_numpy(params, device)
    return HGNNTrainState(params=p, opt=adamw_init(p))


def _resolve_executor(executor: Optional[Any], na_executor: str) -> str:
    """An executor spec (duck-typed: anything with ``na_executor``) wins
    over the string argument."""
    return na_executor if executor is None else executor.na_executor


def _to_device(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(a.astype(dtype)).to(device)


def semi_supervised_masks(
    num_nodes: int,
    seed: int = 0,
    train_frac: float = 0.6,
    val_frac: float = 0.2,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """Random train/val/test split as float32 masks (numpy-seeded: the
    same masks as the JAX package's for one seed)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_nodes)
    n_train = int(round(num_nodes * train_frac))
    n_held = n_train + int(round(num_nodes * val_frac))
    masks = {}
    for name, ids in (("train", perm[:n_train]), ("val", perm[n_train:n_held]),
                      ("test", perm[n_held:])):
        m = np.zeros(num_nodes, np.float32)
        m[ids] = 1.0
        masks[name] = _to_device(m, np.float32, device)
    return masks


def degree_bucket_labels(
    semantic: Dict[str, Any],
    targets: List[str],
    num_dst: int,
    num_classes: int = 3,
    device="cuda",
) -> torch.Tensor:
    """Int32 labels: quantile buckets of the summed in-degree over every
    semantic graph ending at the target type (memorisable, not predictable
    from the synthetic features)."""
    deg = np.zeros(num_dst, np.float64)
    for t in targets:
        rel = semantic[t]
        if rel.num_dst == num_dst:
            deg += np.bincount(rel.dst, minlength=num_dst)
    qs = np.quantile(deg, np.linspace(0, 1, num_classes + 1)[1:-1])
    return _to_device(np.digitize(deg, qs), np.int32, device)


def propagated_feature_labels(
    semantic: Dict[str, Any],
    targets: List[str],
    features: Dict[str, np.ndarray],
    num_dst: int,
    num_classes: int = 3,
    seed: int = 0,
    device="cuda",
) -> torch.Tensor:
    """Int32 labels a GNN can generalise on: quantile buckets of a random
    linear probe of the mean-aggregated neighbour features (numpy features,
    as ``HetGraph.features`` holds them; numpy-seeded)."""
    rng = np.random.default_rng(seed)
    y_raw = np.zeros(num_dst, np.float64)
    probes: Dict[str, np.ndarray] = {}
    for t in targets:
        rel = semantic[t]
        if rel.num_dst != num_dst:
            continue
        st = t[0]
        x = features.get(st)
        if x is None:  # featureless source type: fall back to degree
            p = np.ones(rel.num_src, np.float64)
        else:
            if st not in probes:
                probes[st] = rng.standard_normal(x.shape[1])
            p = np.asarray(x, np.float64) @ probes[st]
        summed = np.zeros(num_dst, np.float64)
        np.add.at(summed, rel.dst, p[rel.src])
        deg = np.bincount(rel.dst, minlength=num_dst)
        y_raw += summed / np.maximum(deg, 1)
    qs = np.quantile(y_raw, np.linspace(0, 1, num_classes + 1)[1:-1])
    return _to_device(np.digitize(y_raw, qs), np.int32, device)


def value_and_grad(fn: Callable[..., torch.Tensor], *trees: Any
                   ) -> Tuple[torch.Tensor, Tuple[Any, ...]]:
    """``fn(*trees)`` (a 0-d tensor) and its gradient with respect to every
    leaf of every tree, as ``jax.value_and_grad`` with one argnum per tree:
    a leaf with no path to the value gets zeros, not ``None``.  The trees
    themselves are not modified.  ``fn`` runs in the span ``train.forward``
    and the gradient in ``train.backward``, which adopts the spans that
    autograd's device thread opens."""
    flats = [tree_flatten(t) for t in trees]
    live = [[x.detach().requires_grad_(True) for x in leaves] for leaves, _ in flats]
    args = [tree_unflatten(d, xs) for (_, d), xs in zip(flats, live)]
    with tracing.span("train.forward"):
        value = fn(*args)
    every = [x for xs in live for x in xs]
    with tracing.span("train.backward", adopt=True):
        grads = torch.autograd.grad(value, every, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(every, grads)]
    out, i = [], 0
    for (_, d), xs in zip(flats, live):
        out.append(tree_unflatten(d, grads[i:i + len(xs)]))
        i += len(xs)
    return value.detach(), tuple(out)


def make_train_step(
    model,
    graphs: List[Any],
    *,
    lr: float = 3e-3,
    warmup: int = 20,
    total: int = 200,
    weight_decay: float = 0.0,
    clip_norm: Optional[float] = None,
    na_executor: str = "banded",
    executor: Optional[Any] = None,
) -> Callable[..., Tuple[HGNNTrainState, torch.Tensor]]:
    """The train step ``(state, features, labels, mask) -> (state, loss)``
    for one (model, graphs, executor); ``graphs`` must match the executor
    (``BandedBatch`` for "banded", ``SemanticGraphBatch`` for "jnp").
    ``executor`` (anything with an ``na_executor`` attribute, such as an
    ``ExecutorSpec``) overrides ``na_executor``.  With ``clip_norm`` the
    gradients are clipped to that global norm before AdamW.  The learning
    rate is read at the step before its increment."""
    na_executor = _resolve_executor(executor, na_executor)
    lr_fn = warmup_cosine(lr, warmup=warmup, total=total)

    def step(state: HGNNTrainState, features, labels, mask):
        with tracing.span("train.step"):
            loss, (grads,) = value_and_grad(
                lambda p: model.execute_loss(p, features, graphs, labels, mask=mask,
                                             na_executor=na_executor), state.params)
            with tracing.span("train.optimizer"):
                if clip_norm is not None:
                    grads, _ = clip_by_global_norm(grads, clip_norm)
                params, opt = adamw_update(grads, state.opt, state.params,
                                           lr_fn(state.opt.step), weight_decay=weight_decay)
        return HGNNTrainState(params=params, opt=opt), loss

    return step


def make_eval_fn(model, graphs: List[Any], *, na_executor: str = "banded",
                 executor: Optional[Any] = None) -> Callable[..., torch.Tensor]:
    """Masked accuracy ``(params, features, labels, mask) -> ()``."""
    na_executor = _resolve_executor(executor, na_executor)

    @torch.no_grad()
    def accuracy(params, features, labels, mask):
        logits = model.execute(params, features, graphs, na_executor=na_executor)
        hit = (logits.argmax(-1) == labels.long()).to(torch.float32)
        return torch.sum(hit * mask) / torch.clamp(mask.sum(), min=1.0)

    return accuracy


def fit(
    model,
    graphs: List[Any],
    features: Dict[str, torch.Tensor],
    labels: torch.Tensor,
    masks: Dict[str, torch.Tensor],
    *,
    epochs: int = 100,
    seed: int = 0,
    lr: float = 3e-3,
    weight_decay: float = 0.0,
    na_executor: str = "banded",
    executor: Optional[Any] = None,
    epoch_callback: Optional[Callable[[int, float], None]] = None,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 1,
) -> Dict[str, Any]:
    """Full-graph training loop; returns the final state and metrics.

    One epoch is one full-graph step; the state starts from
    ``init_train_state(model, seed)`` on ``labels``' device.
    ``epoch_callback(epoch, loss)`` runs after every epoch.  With
    ``ckpt_dir`` the state (params and optimizer) is saved atomically every
    ``ckpt_every`` epochs, and a ``fit`` over a directory that holds
    checkpoints resumes from the newest complete one; the loss history
    travels in the checkpoint, so ``losses`` covers every epoch.
    """
    na_executor = _resolve_executor(executor, na_executor)
    state = init_train_state(model, seed, device=labels.device)
    ckpt = None
    start_epoch = 0
    losses: List[float] = []
    if ckpt_dir is not None:
        if ckpt_every < 1:
            raise ValueError(f"ckpt_every must be >= 1, got {ckpt_every}")
        from repro_torch.train.checkpoint import CheckpointManager

        ckpt = CheckpointManager(ckpt_dir)
        restored = ckpt.restore_latest(state)
        if restored is not None:
            _, state, extra = restored
            start_epoch = int(extra["epoch"])
            losses = [float(x) for x in extra.get("losses", [])]
    step = make_train_step(model, graphs, lr=lr, warmup=max(1, epochs // 10),
                           total=epochs, weight_decay=weight_decay,
                           na_executor=na_executor)
    acc_fn = make_eval_fn(model, graphs, na_executor=na_executor)
    for epoch in range(start_epoch, epochs):
        state, loss = step(state, features, labels, masks["train"])
        losses.append(float(loss))
        if epoch_callback is not None:
            epoch_callback(epoch, losses[-1])
        if ckpt is not None and (epoch + 1) % ckpt_every == 0:
            ckpt.save(epoch + 1, state, extra={"epoch": epoch + 1, "losses": losses})
    return {
        "state": state,
        "losses": losses,
        "train_acc": float(acc_fn(state.params, features, labels, masks["train"])),
        "val_acc": float(acc_fn(state.params, features, labels, masks["val"])),
        "test_acc": float(acc_fn(state.params, features, labels, masks["test"])),
    }
