"""Deterministic synthetic token pipeline (restart-stable), the JAX
package's ``repro.train.data``.

Every (step, batch row) is generated from a counter-based hash, so the
stream is identical whatever the number of ranks or the restart point —
the property a fault-tolerant data loader must have.  ``host_batch`` is
bitwise the reference's; ``sharded_batch`` builds each data rank's rows
from those rows alone, on that rank's device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.train._lm_pspecs import Spec, data_ranks


def _hash_tokens(step: int, row: np.ndarray, seq: int, vocab: int,
                 seed: int) -> np.ndarray:
    """Counter-based generator (splitmix-ish), vectorized over rows."""
    # uint64 wraparound IS the splitmix mixing function: silence numpy's
    # overflow RuntimeWarning for exactly this block
    with np.errstate(over="ignore"):
        ctr = (
            np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15)
            + np.uint64(step) * np.uint64(0xBF58476D1CE4E5B9)
            + row[:, None].astype(np.uint64) * np.uint64(0x94D049BB133111EB)
            + np.arange(seq, dtype=np.uint64)[None, :]
        )
        z = ctr
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
        return (z % np.uint64(vocab)).astype(np.int32)


@dataclasses.dataclass
class SyntheticTokens:
    """Token batches ``(tokens, targets)`` of ``global_batch`` rows of
    ``seq_len`` ids below ``vocab_size``, targets shifted by one."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def _rows(self, step: int, rows: np.ndarray) -> np.ndarray:
        return _hash_tokens(step, rows, self.seq_len + 1, self.vocab_size, self.seed)

    def host_batch(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """Full-batch int32 numpy arrays."""
        toks = self._rows(step, np.arange(self.global_batch))
        return toks[:, :-1], toks[:, 1:]

    def sharded_batch(self, step: int, mesh: Mesh, spec: Spec
                      ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """One ``(tokens, targets)`` pair of int32 tensors per data rank of
        ``spec``'s batch entry, in rank order: rank ``i`` gets rows ``[i *
        B/n, (i + 1) * B/n)``, generated from those rows alone and placed
        on the mesh position with index ``i`` over the batch axes (0 on the
        others).  Concatenated, they are ``host_batch(step)``."""
        n = data_ranks(mesh, spec)
        if self.global_batch % n:
            raise ValueError(f"batch {self.global_batch} does not split over {n} data ranks")
        entry = spec[0] if spec else None
        names = () if entry is None else (entry,) if isinstance(entry, str) else entry
        sizes = [mesh.shape[a] for a in names]
        per = self.global_batch // n
        out = []
        for i in range(n):
            pos = [0] * len(mesh.axis_names)
            for a, j in zip(names, np.unravel_index(i, sizes) if names else ()):
                pos[mesh.axis_names.index(a)] = int(j)
            device = mesh.devices[tuple(pos)]
            toks = self._rows(step, np.arange(i * per, (i + 1) * per))
            out.append((torch.from_numpy(np.ascontiguousarray(toks[:, :-1])).to(device),
                        torch.from_numpy(np.ascontiguousarray(toks[:, 1:])).to(device)))
        return out
