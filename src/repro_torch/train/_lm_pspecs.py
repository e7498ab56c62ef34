"""Sharding rules of the LM parameters, batches and caches: FSDP ('data')
x TP/EP ('model'), multi-pod DP ('pod'), as the JAX package's
``repro.train._lm_pspecs`` gives them.

A spec is a tuple with one entry per array dimension: an axis name, a
tuple of names, or ``None`` (replicated), which is ``tuple(P)`` of the
reference's ``PartitionSpec`` (a one-name tuple reads as the name).
Parameters get specs by leaf name (stacked leaves carry a leading group
dim -> leading None):

  * dense in-projections  (G, D, X): (_, fsdp, 'model')   — TP on out dim
  * dense out-projections (G, X, D): (_, 'model', fsdp)   — TP on in dim
  * experts               (G, E, ...): experts over 'model' (EP), D over fsdp
  * embedding             (V, D): vocab over 'model'
  * norms / scalars: replicated

The port runs a mesh in one process and keeps each leaf whole on the rank
that holds its first shard, mesh position 0 (``shard_params``); the specs
say how a multi-rank step would split it (ROADMAP slice 14).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ArchConfig
from repro_torch.train.tree import flatten_up_to, tree_flatten, tree_unflatten

Spec = Tuple


def _canon(entry):
    """A spec entry as ``PartitionSpec`` keeps it: a one-name tuple is the
    name."""
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _spec_for(path: Tuple[str, ...], shape: Tuple[int, ...], fsdp,
              attn_model: bool = True) -> Spec:
    name = path[-1]
    in_blocks = "blocks" in path
    lead = (None,) if in_blocks else ()

    def mk(*axes):
        return tuple(_canon(a) for a in (*lead, *axes))

    if name == "embed":
        return ("model", None)
    if name == "unembed":
        return (None, "model")
    if name == "final_norm":
        return (None,)

    ndim = len(shape) - len(lead)
    # Attention projections: TP over 'model' only when the head count
    # divides the axis (attn_model); otherwise the attention core runs
    # context-parallel and the projections stay FSDP-only.
    if name in ("wq", "wk", "wv"):
        return mk(fsdp, "model" if attn_model else None)
    if name == "wo":
        return mk("model" if attn_model else None, fsdp)
    if name in ("w_in", "w_kr", "w_dkv"):
        return mk(fsdp, "model" if name == "w_in" else None)
    if name == "w_out":
        return mk("model", fsdp)
    if name == "w_ukv":
        return mk(None, "model" if attn_model else None)
    if name == "w_router":
        return mk(fsdp, None)
    if name in ("w_gate", "w_up"):
        if ndim == 3:  # moe (E, D, F)
            return mk("model", fsdp, None)
        return mk(fsdp, "model")
    if name == "w_down":
        if ndim == 3:  # moe (E, F, D)
            return mk("model", None, fsdp)
        return mk("model", fsdp)
    if name == "w_conv":
        return mk(None, "model")
    if name in ("b_conv", "norm", "a_log", "dt_bias"):
        return mk("model")
    # norms (ln1, ln2, ln1_post, ln2_post, kv_norm) and anything else:
    # replicated
    return mk(*([None] * ndim))


def param_pspecs(cfg: ArchConfig, params: Dict, fsdp="data",
                 model_axis_size: int = 16) -> Dict:
    """A tree of specs shaped like ``params`` (leaves need only a
    ``shape``)."""
    attn_model = cfg.num_heads > 0 and cfg.num_heads % model_axis_size == 0 \
        and cfg.num_kv_heads % model_axis_size == 0

    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(path, v) for v in node)
        return _spec_for(path, tuple(node.shape), fsdp, attn_model)

    return walk((), params)


def data_pspec(mesh: Mesh, batch: int) -> Spec:
    """Shard the batch over every data-parallel axis that divides it."""
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    usable = []
    for a in axes:
        size = mesh.shape[a]
        if batch % int(np.prod([mesh.shape[u] for u in usable] or [1]) * size) == 0:
            usable.append(a)
    if not usable:
        return (None,)
    return (_canon(tuple(usable)),)


def data_ranks(mesh: Mesh, spec: Spec) -> int:
    """How many shards the batch dimension of ``spec`` (its first entry)
    splits into over ``mesh``."""
    entry = spec[0] if spec else None
    names = () if entry is None else (entry,) if isinstance(entry, str) else entry
    return int(np.prod([mesh.shape[a] for a in names] or [1]))


def cache_pspecs(cfg: ArchConfig, cache: Any, mesh: Mesh, batch: int) -> Any:
    """KV/SSM cache specs.

    Batch shards over the data axes.  KV heads shard over 'model' only when
    the head count divides the axis; otherwise the cache TIME dimension
    shards over 'model' (flash-decode style).  MLA's latent cache always
    shards T over 'model'.  batch=1 long-context decode shards T over every
    available axis.
    """
    dp = data_pspec(mesh, batch)
    batch_axis = dp[0] if len(dp) and dp[0] is not None else None
    msize = int(mesh.shape.get("model", 1))
    kv_heads_ok = cfg.num_kv_heads > 0 and cfg.num_kv_heads % msize == 0
    ssm_heads_ok = cfg.ssm_heads > 0 and cfg.ssm_heads % msize == 0

    def one(pos_cache):
        out = {}
        for k, v in pos_cache.items():
            nd = len(v.shape)
            if k in ("k", "v"):  # (G, B, Hkv, T, dh)
                if batch_axis is not None:
                    out[k] = ((None, batch_axis, "model", None, None) if kv_heads_ok
                              else (None, batch_axis, None, "model", None))
                else:  # batch=1 long-context decode
                    out[k] = ((None, None, "model", "data", None) if kv_heads_ok
                              else (None, None, None, ("data", "model"), None))
            elif k == "c_kv":  # (G, B, T, r)
                out[k] = ((None, batch_axis, "model", None) if batch_axis
                          else (None, None, ("data", "model"), None))
            elif k == "k_r":  # (G, B, 1, T, rope)
                out[k] = ((None, batch_axis, None, "model", None) if batch_axis
                          else (None, None, None, ("data", "model"), None))
            elif k == "conv":  # (G, B, cw-1, conv_dim)
                out[k] = (None, batch_axis, None, "model")
            elif k == "ssm":  # (G, B, H, P, N)
                out[k] = ((None, batch_axis, "model", None, None) if ssm_heads_ok
                          else (None, batch_axis, None, None, "model"))
            else:
                out[k] = (None,) * nd
        return out

    return [one(c) for c in cache]


def shard_params(params: Dict, mesh: Mesh, specs: Dict) -> Dict:
    """Place every leaf of ``params`` on the rank of ``mesh`` that holds
    its spec's first shard (mesh position 0, ``mesh.ranks[0]``), whole."""
    leaves, treedef = tree_flatten(params)
    flatten_up_to(treedef, specs)  # the specs must have the params' structure
    return tree_unflatten(treedef, [x.to(mesh.ranks[0]) for x in leaves])
