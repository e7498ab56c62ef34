"""Frozen copy of the port's synthetic heterogeneous-graph generator
(``repro_torch/hetero/datasets.py``, itself bitwise the JAX package's).

The benchmark makes its graphs here, not through the port, so that a later
change to the port cannot change the benchmark's inputs.  For the same
``(name, seed, scale)`` every array equals the port's ``make_dataset``
(``tests/test_gpubench_inputs.py`` holds them bitwise).  Relations are
returned as plain ``(src, dst)`` int32 arrays in canonical order: sorted
by ``(src, dst)`` and deduplicated.
"""
from __future__ import annotations

import zlib
from typing import Dict, Tuple

import numpy as np

IDX = np.int32

# (vertex counts, feature dims, forward relations with mean out-degree):
# the paper's Table 2
SPECS: Dict[str, dict] = {
    "IMDB": dict(
        vertices={"M": 4932, "D": 2393, "A": 6124, "K": 7971},
        features={"M": 3489, "D": 3341, "A": 3341, "K": 0},
        relations=[("A", "M", 2.4), ("K", "M", 2.9), ("D", "M", 2.1)],
    ),
    "ACM": dict(
        vertices={"P": 3025, "A": 5959, "S": 56, "T": 1902},
        features={"P": 1902, "A": 1902, "S": 1902, "T": 0},
        relations=[("T", "P", 4.5), ("S", "P", 54.0), ("P", "P", 1.8), ("A", "P", 1.6)],
    ),
    "DBLP": dict(
        vertices={"A": 4057, "P": 14328, "T": 7723, "V": 20},
        features={"A": 334, "P": 4231, "T": 50, "V": 0},
        relations=[("A", "P", 4.8), ("V", "P", 716.0), ("T", "P", 11.0)],
    ),
}


def _powerlaw_degrees(rng: np.random.Generator, n: int, mean_deg: float,
                      alpha: float = 2.1) -> np.ndarray:
    raw = rng.pareto(alpha - 1.0, size=n) + 1.0
    deg = raw * (mean_deg / raw.mean())
    return np.maximum(np.round(deg), 0).astype(np.int64)


def _bipartite_edges(rng: np.random.Generator, num_src: int, num_dst: int,
                     mean_out_deg: float, p_in: float = 0.75
                     ) -> Tuple[np.ndarray, np.ndarray]:
    deg = _powerlaw_degrees(rng, num_src, mean_out_deg)
    total = int(deg.sum())
    src = np.repeat(np.arange(num_src, dtype=IDX), deg)

    n_comm = max(2, num_dst // 48)
    comm_src = rng.integers(0, n_comm, size=num_src)
    comm_dst = rng.integers(0, n_comm, size=num_dst)
    order = np.argsort(comm_dst, kind="stable")
    sorted_comm = comm_dst[order]
    starts = np.searchsorted(sorted_comm, np.arange(n_comm))
    ends = np.searchsorted(sorted_comm, np.arange(n_comm), side="right")

    w = 1.0 / (np.arange(1, num_dst + 1) ** 0.8)
    w = rng.permutation(w)
    w /= w.sum()

    ec = comm_src[src]
    lo, hi = starts[ec], ends[ec]
    in_comm = (rng.random(total) < p_in) & (hi > lo)
    pos = lo + (rng.random(total) * (hi - lo)).astype(np.int64)
    dst_in = order[np.minimum(pos, np.maximum(lo, hi - 1))]
    dst_glob = rng.choice(num_dst, size=total, p=w)
    dst = np.where(in_comm, dst_in, dst_glob).astype(IDX)
    return src, dst


def canonical(num_dst: int, src, dst) -> Tuple[np.ndarray, np.ndarray]:
    """Edges sorted by ``(src, dst)`` and deduplicated, as int32."""
    src = np.asarray(src, dtype=IDX)
    dst = np.asarray(dst, dtype=IDX)
    if src.size:
        key = np.unique(src.astype(np.int64) * num_dst + dst.astype(np.int64))
        src = (key // num_dst).astype(IDX)
        dst = (key % num_dst).astype(IDX)
    return src, dst


def make_graph(name: str, seed: int = 0, scale: float = 1.0,
               features: bool = True) -> dict:
    """The Table 2 graph ``name`` at ``scale``: ``{"num_vertices",
    "feature_dims", "relations": {"AP": (src, dst), ...}, "features"}``.
    With ``features=False`` the feature draws (the last the generator
    makes) are skipped and ``"features"`` is empty."""
    spec = SPECS[name]
    rng = np.random.default_rng(np.random.SeedSequence([zlib.crc32(name.encode()), seed]))
    nv = {t: max(2, int(round(c * scale))) for t, c in spec["vertices"].items()}
    relations: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for s, d, mean_deg in spec["relations"]:
        src, dst = _bipartite_edges(rng, nv[s], nv[d], mean_deg)
        fs, fd = canonical(nv[d], src, dst)
        if s != d:
            relations[s + d] = (fs, fd)
            relations[d + s] = canonical(nv[s], fd, fs)
        else:
            rs, rd = canonical(nv[s], fd, fs)
            relations[s + d] = canonical(nv[d], np.concatenate([fs, rs]),
                                         np.concatenate([fd, rd]))
    feats: Dict[str, np.ndarray] = {}
    if features:
        for t, dim in spec["features"].items():
            if dim > 0:
                feats[t] = rng.standard_normal((nv[t], dim)).astype(np.float32) * 0.1
    return {"num_vertices": nv, "feature_dims": dict(spec["features"]),
            "relations": relations, "features": feats}
