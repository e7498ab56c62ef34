"""Error-feedback int8 gradient compression, the JAX package's
``repro.train.compress``.

Compressing gradients 4x (float32 -> int8 with a per-leaf scale) cuts the
traffic of a cross-pod gradient all-reduce proportionally.  Plain
quantization biases training; error feedback keeps a residual buffer of
the quantization error and adds it back before the next compression.
The train step applies it to the clipped gradients before the optimizer;
``compress_decompress`` returns what the optimizer would see after the
all-reduce of the int8 values.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.train.tree import flatten_up_to, tree_flatten, tree_leaves, tree_map, tree_unflatten


def init_residuals(params: Any) -> Any:
    """Zero float32 residuals shaped like ``params``, on their devices."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def compress_decompress(grads: Any, residuals: Any) -> Tuple[Any, Any]:
    """``(decompressed grads, new residuals)``: per leaf, ``g + r`` in
    float32 quantized to int8 at scale ``max|g + r| / 127`` (at least
    1e-12 / 127), rounded half to even, dequantized and cast to ``g``'s
    dtype; the new residual is what the quantization lost."""

    def one(g, r):
        g32 = g.to(torch.float32) + r
        scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        deq = q.to(torch.float32) * scale
        return deq.to(g.dtype), g32 - deq

    flat_g, treedef = tree_flatten(grads)
    out = [one(g, r) for g, r in zip(flat_g, flatten_up_to(treedef, residuals))]
    return (tree_unflatten(treedef, [o[0] for o in out]),
            tree_unflatten(treedef, [o[1] for o in out]))


def compressed_bytes(params: Any) -> Tuple[int, int]:
    """(uncompressed float32 bytes, compressed int8 + scale bytes) a step."""
    leaves = tree_leaves(params)
    return (sum(int(p.numel()) * 4 for p in leaves),
            sum(int(p.numel()) + 4 for p in leaves))
