"""Atomic, versioned checkpoints in the JAX package's layout
(``repro.train.checkpoint``):

    <dir>/step_<N>.tmp-<nonce>/  -> fsync'd -> renamed to step_<N>/
    <dir>/step_<N>/manifest.json + leaf_<i>.npy

Renames are atomic on POSIX, so a crash mid-save never corrupts the
latest complete checkpoint: ``steps`` lists only directories with a
manifest, and ``.tmp-`` directories are skipped and removed by the next
save.  Leaves are stored in ``jax.tree.flatten``'s order
(``train.tree``), so a checkpoint written by either package restores in
the other.  HGNN parameters are replicated on every rank of a sharded
forward, so they restore as they are; restoring LM parameters onto a
mesh by partition spec is not ported yet.
"""
from __future__ import annotations

import json
import os
import shutil
import uuid
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.tree import tree_flatten, tree_unflatten


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class CheckpointManager:
    """Save and restore trees of tensors under ``directory``, keeping the
    ``keep`` newest complete checkpoints."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> str:
        """Write ``tree`` as ``step_<step>`` (atomically); returns its path.
        ``extra`` is any JSON-serialisable dict, returned by ``restore``."""
        leaves, _ = tree_flatten(tree)
        tmp = os.path.join(self.directory, f"step_{step}.tmp-{uuid.uuid4().hex[:8]}")
        final = os.path.join(self.directory, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "num_leaves": len(leaves),
                    "specs": [None] * len(leaves), "extra": extra or {},
                    "dtypes": [], "shapes": []}
        for i, leaf in enumerate(leaves):
            arr = _to_numpy(leaf)
            manifest["dtypes"].append(str(arr.dtype))
            manifest["shapes"].append(list(arr.shape))
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

    def restore(self, step: int, like: Any) -> Tuple[Any, dict]:
        """``(tree, extra)`` of checkpoint ``step``.  ``like`` supplies the
        structure and, leaf by leaf, the device; dtypes are the stored
        ones."""
        path = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves, treedef = tree_flatten(like)
        if manifest["num_leaves"] != len(leaves):
            raise ValueError(f"checkpoint has {manifest['num_leaves']} leaves, "
                             f"the tree {len(leaves)}: structure mismatch")
        out = []
        for i, leaf in enumerate(leaves):
            arr = np.load(os.path.join(path, f"leaf_{i}.npy"))
            want = np.dtype(manifest["dtypes"][i])
            if arr.dtype != want:
                arr = arr.view(want).reshape(manifest["shapes"][i])
            device = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
            out.append(torch.from_numpy(np.array(arr)).to(device))
        return tree_unflatten(treedef, out), manifest["extra"]

    def restore_latest(self, like: Any):
        """``(step, tree, extra)`` of the newest complete checkpoint, or
        None."""
        steps = self.steps()
        if not steps:
            return None
        tree, extra = self.restore(steps[-1], like)
        return steps[-1], tree, extra

    def _gc(self):
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)
        for d in os.listdir(self.directory):  # stale tmp dirs of crashed saves
            if ".tmp-" in d:
                shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)
