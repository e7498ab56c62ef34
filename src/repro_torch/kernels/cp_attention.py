"""Zigzag context-parallel causal attention over a mesh's 'model' axis, the
JAX package's ``repro.kernels.cp_attention``.

Causal attention over a sequence split into contiguous chunks unbalances
the ranks (the last does P times the first's work).  The zigzag schedule
splits S into 2P chunks of c rows and gives rank ``i`` of P the chunks
``i`` and ``2P-1-i``: (i + 1) + (2P - i) = 2P + 1 chunk pairs of causal
work on every rank.  K and V are replicated.

The reference runs that schedule as one ``shard_map`` program of jnp chunk
pairs.  Here each rank runs its two query chunks through K4
(``ops.attention_k4``) on its own device, as two plain causal calls with the
queries end-aligned at T - S: the low chunk ``i`` attends to keys ``[0,
(i+1) c)``, the high chunk ``2P-1-i`` to keys ``[0, (2P-i) c)``, so no mask
beyond K4's own causal one is needed.  The outputs are gathered onto q's
device in zigzag chunk order and, in the plain mode, put back in sequence
order.  Differentiable through K4's autograd Function; on the CPU (and on
``meta`` tensors) each call is K4's plain version.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, get_mesh


def _zigzag_perm(two_p: int) -> List[int]:
    """Chunk order such that contiguous per-shard slices hold the zigzag
    pair: [0, 2P-1, 1, 2P-2, ...]."""
    idx = []
    for i in range(two_p // 2):
        idx.extend([i, two_p - 1 - i])
    return idx


def zigzag_positions(s: int, p_shards: int = 16) -> np.ndarray:
    """Logical position of each index when the sequence is STORED in
    zigzag chunk order (the end-to-end layout of the 'native' mode)."""
    two_p = 2 * p_shards
    c = s // two_p
    return np.concatenate(
        [np.arange(p * c, (p + 1) * c) for p in _zigzag_perm(two_p)])


def _rank_devices(mesh: Mesh, axis: str, b: int) -> List[List[torch.device]]:
    """``[d][i]``: the device of model rank ``i`` in batch shard ``d`` (the
    'data' axis splits the batch, as the reference's ``shard_map`` does;
    every other axis at position 0)."""
    names = mesh.axis_names
    data = mesh.shape["data"] if "data" in names else 1
    if b % data:
        raise ValueError(f"batch {b} does not split over the mesh's 'data' axis of {data}")
    out = []
    for d in range(data):
        row = []
        for i in range(mesh.shape[axis]):
            pos = [0] * len(names)
            pos[names.index(axis)] = i
            if "data" in names:
                pos[names.index("data")] = d
            row.append(mesh.devices[tuple(pos)])
        out.append(row)
    return out


def cp_zigzag_attention(
    q: torch.Tensor,  # (B, Hq, S, Dh)
    k: torch.Tensor,  # (B, Hkv, S, Dh)
    v: torch.Tensor,  # (B, Hkv, S, Dv)
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    axis: str = "model",
    p_shards: int = 16,
    pre_permuted: bool = False,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Causal attention ``(B, Hq, S, Dv)`` with the zigzag schedule over
    ``mesh``'s ``axis`` (default: the ambient mesh of ``set_mesh``), whose
    size must be ``p_shards``; each of its ranks launches K4 twice on its
    device.  ``pre_permuted=True``: q, k and v are already stored in zigzag
    chunk order (the 'native' mode: tokens permuted at ingestion, RoPE on
    ``zigzag_positions``) and so is the output; K and V are put back in
    sequence order once per device for the ranks' key prefixes."""
    from repro_torch.kernels.ops import attention_k4

    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None or axis not in mesh.axis_names:
        raise ValueError(f"cp_zigzag_attention needs a mesh with a {axis!r} axis "
                         f"(launch.mesh.set_mesh), got {mesh and mesh.axis_names}")
    if mesh.shape[axis] != p_shards:
        raise ValueError(f"cp_zigzag_attention with p_shards={p_shards} needs the mesh's "
                         f"{axis!r} axis to have {p_shards} ranks, it has {mesh.shape[axis]}")
    b, _, s, _ = q.shape
    two_p = 2 * p_shards
    if s % two_p or k.shape[2] != s or v.shape[2] != s:
        raise ValueError(f"cp_zigzag_attention takes q, k and v of one sequence length "
                         f"divisible by 2 * p_shards = {two_p}, got {q.shape[2]}, "
                         f"{k.shape[2]}, {v.shape[2]}")
    c = s // two_p
    if pre_permuted:  # stored chunk inv[p] holds logical chunk p
        inv = np.argsort(_zigzag_perm(two_p))

        def logical(t):
            return torch.cat([t[:, :, inv[p] * c:(inv[p] + 1) * c] for p in range(two_p)], 2)
    rows = _rank_devices(mesh, axis, b)
    per = b // len(rows)
    chunks: List[List[torch.Tensor]] = [[] for _ in range(two_p)]  # logical chunk -> batch shards
    for d, devices in enumerate(rows):
        bs = slice(d * per, (d + 1) * per)
        kv = {}
        for i, dev in enumerate(devices):
            if dev not in kv:
                kd, vd = k[bs].to(dev), v[bs].to(dev)
                kv[dev] = (logical(kd), logical(vd)) if pre_permuted else (kd, vd)
            kd, vd = kv[dev]
            for slot, chunk in ((2 * i, i), (2 * i + 1, two_p - 1 - i)):
                # the chunk's rows: storage slot in the native mode, else its own place
                at = slot if pre_permuted else chunk
                qc = q[bs, :, at * c:(at + 1) * c].to(dev)
                end = (chunk + 1) * c
                out = attention_k4(qc, kd[:, :, :end], vd[:, :, :end], causal=True,
                                   softcap=softcap, scale=scale)
                chunks[chunk].append(out.to(q.device))
    order = _zigzag_perm(two_p) if pre_permuted else range(two_p)
    return torch.cat([torch.cat(chunks[p], 0) for p in order], 2)
