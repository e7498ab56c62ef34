"""Atomic, versioned checkpoints in the JAX package's layout
(``repro.train.checkpoint``):

    <dir>/step_<N>.tmp-<nonce>/  -> fsync'd -> renamed to step_<N>/
    <dir>/step_<N>/manifest.json + leaf_<i>.npy

Renames are atomic on POSIX, so a crash mid-save never corrupts the
latest complete checkpoint: ``steps`` lists only directories with a
manifest, and ``.tmp-`` directories are skipped and removed by the next
save.  Leaves are stored in ``jax.tree.flatten``'s order
(``train.tree``), so a checkpoint written by either package restores in
the other.  A bfloat16 leaf (every LM matrix), which ``.npy`` cannot
hold, is stored as its raw bytes (``uint8``, the last dimension doubled)
with ``"bfloat16"`` in the manifest's dtypes, byte for byte as the
reference stores it.  Leaves are logically global: ``restore`` puts each
on the rank of a mesh that holds its spec's first shard (the one-process
port keeps a whole leaf there), or on ``like``'s device without a mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import uuid
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.tree import flatten_up_to, tree_flatten, tree_unflatten


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the numpy array ``.npy`` stores: a bfloat16 tensor as its
    bytes, ``uint8`` with the last dimension doubled (numpy's ``view`` of
    the reference's ``ml_dtypes`` array)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.reshape(t.shape or (1,)).view(torch.uint8).numpy()
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _from_numpy(arr: np.ndarray, dtype: str, shape) -> torch.Tensor:
    """A stored leaf back as a tensor of the manifest's ``dtype`` and
    ``shape``: ``bfloat16`` from its bytes, any numpy dtype as it is."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr)).view(torch.bfloat16).reshape(shape)
    want = np.dtype(dtype)
    if arr.dtype != want:
        arr = arr.view(want).reshape(shape)
    return torch.from_numpy(np.array(arr))


def spec_repr(spec) -> Optional[str]:
    """A partition spec (a tuple of axis names, ``None`` and tuples of
    names) as the reference's manifest records it: the ``repr`` of the
    ``jax.sharding.PartitionSpec`` with the same entries."""
    return None if spec is None else "PartitionSpec" + repr(tuple(spec))


def _spec_leaves(tree, specs, n: int) -> list:
    """The spec of each of ``tree``'s ``n`` leaves (each spec is a tuple,
    a leaf of ``specs`` at a leaf of ``tree``), or ``None`` for each."""
    if specs is None:
        return [None] * n
    return flatten_up_to(tree_flatten(tree)[1], specs)


class CheckpointManager:
    """Save and restore trees of tensors under ``directory``, keeping the
    ``keep`` newest complete checkpoints."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Any, specs: Optional[Any] = None,
             extra: Optional[dict] = None) -> str:
        """Write ``tree`` as ``step_<step>`` (atomically); returns its path.
        ``specs`` (a tree of partition specs shaped like ``tree``, or None)
        are recorded for inspection only; ``extra`` is any
        JSON-serialisable dict, returned by ``restore``."""
        leaves, _ = tree_flatten(tree)
        spec_leaves = _spec_leaves(tree, specs, len(leaves))
        tmp = os.path.join(self.directory, f"step_{step}.tmp-{uuid.uuid4().hex[:8]}")
        final = os.path.join(self.directory, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "num_leaves": len(leaves),
                    "specs": [spec_repr(sp) for sp in spec_leaves], "extra": extra or {},
                    "dtypes": [], "shapes": []}
        for i, leaf in enumerate(leaves):
            arr = _to_numpy(leaf)
            manifest["dtypes"].append(_dtype_name(leaf))
            manifest["shapes"].append(list(getattr(leaf, "shape", arr.shape)))
            with open(os.path.join(tmp, f"leaf_{i}.npy"), "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def steps(self):
        """Steps of the complete checkpoints (with a manifest), ascending."""
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and ".tmp" not in d:
                if os.path.exists(os.path.join(self.directory, d, "manifest.json")):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def restore(self, step: int, like: Any, mesh=None,
                specs: Optional[Any] = None) -> Tuple[Any, dict]:
        """``(tree, extra)`` of checkpoint ``step``.  ``like`` supplies the
        structure; dtypes and shapes are the stored ones.  With a ``mesh``
        (``launch.mesh.Mesh``) a leaf whose spec is given goes to the rank
        holding the spec's first shard, mesh position 0 (``mesh.ranks[0]``);
        any other leaf to ``like``'s leaf's device (the CPU for a
        non-tensor)."""
        path = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves, treedef = tree_flatten(like)
        if manifest["num_leaves"] != len(leaves):
            raise ValueError(f"checkpoint has {manifest['num_leaves']} leaves, "
                             f"the tree {len(leaves)}: structure mismatch")
        spec_leaves = _spec_leaves(like, specs, len(leaves))
        out = []
        for i, leaf in enumerate(leaves):
            arr = np.load(os.path.join(path, f"leaf_{i}.npy"))
            t = _from_numpy(arr, manifest["dtypes"][i], manifest["shapes"][i])
            if mesh is not None and spec_leaves[i] is not None:
                device = mesh.ranks[0]
            else:
                device = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
            out.append(t.to(device))
        return tree_unflatten(treedef, out), manifest["extra"]

    def restore_latest(self, like: Any, mesh=None, specs: Optional[Any] = None):
        """``(step, tree, extra)`` of the newest complete checkpoint, or
        None; ``mesh`` and ``specs`` as in ``restore``."""
        steps = self.steps()
        if not steps:
            return None
        tree, extra = self.restore(steps[-1], like, mesh=mesh, specs=specs)
        return steps[-1], tree, extra

    def _gc(self):
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)
        for d in os.listdir(self.directory):  # stale tmp dirs of crashed saves
            if ".tmp-" in d:
                shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)
