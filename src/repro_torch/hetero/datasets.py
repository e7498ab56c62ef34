"""Synthetic HetG generators calibrated to the paper's Table 2.

ACM / DBLP / IMDB are generated synthetically with the vertex-type counts,
feature dims and relation sets of Table 2 and power-law degree
distributions.  Generators are seeded and deterministic: for the same
``(name, seed, scale)`` every array is bitwise-equal to the JAX package's
``repro.hetero.make_dataset``, features included, so the two packages see
identical graphs.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.hetero.graph import IDX, HetGraph, Relation


def _powerlaw_degrees(
    rng: np.random.Generator, n: int, mean_deg: float, alpha: float = 2.1
) -> np.ndarray:
    """Zipf-ish degree sequence with the requested mean (>=0 per vertex)."""
    raw = rng.pareto(alpha - 1.0, size=n) + 1.0
    deg = raw * (mean_deg / raw.mean())
    return np.maximum(np.round(deg), 0).astype(np.int64)


def _bipartite_edges(
    rng: np.random.Generator,
    num_src: int,
    num_dst: int,
    mean_out_deg: float,
    p_in: float = 0.75,
) -> Tuple[np.ndarray, np.ndarray]:
    """Power-law out-degrees + planted (id-shuffled) community structure.

    Each vertex gets a community; an edge lands inside its source's
    community with probability ``p_in``, else on a global Zipf-weighted
    destination.  Membership is random over ids, so the raw layout carries
    no locality — recovering it is the restructurer's job.
    """
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


# (vertex counts, feature dims, forward relations with mean out-degree)
_SPECS: Dict[str, dict] = {
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

DATASETS: List[str] = sorted(_SPECS)


def make_dataset(name: str, seed: int = 0, scale: float = 1.0) -> HetGraph:
    """Build a synthetic HetG calibrated to Table 2.

    ``scale`` scales vertex counts.  Every forward relation gets its
    reverse; the self-relation (ACM PP) is the union with its reverse.
    """
    if name not in _SPECS:
        raise KeyError(f"unknown dataset {name!r}; have {DATASETS}")
    spec = _SPECS[name]
    # zlib.crc32 is stable across processes (str hash is randomized)
    rng = np.random.default_rng(np.random.SeedSequence([zlib.crc32(name.encode()), seed]))

    nv = {t: max(2, int(round(c * scale))) for t, c in spec["vertices"].items()}
    relations: Dict[str, Relation] = {}
    for s, d, mean_deg in spec["relations"]:
        src, dst = _bipartite_edges(rng, nv[s], nv[d], mean_deg)
        fwd = Relation.from_edges(s, d, nv[s], nv[d], src, dst)
        relations[fwd.name] = fwd
        rev = fwd.reverse()
        if s != d:
            relations[rev.name] = rev
        else:
            relations[fwd.name] = Relation.from_edges(
                s, d, nv[s], nv[d],
                np.concatenate([fwd.src, rev.src]),
                np.concatenate([fwd.dst, rev.dst]),
            )

    features = {}
    for t, dim in spec["features"].items():
        if dim > 0:
            features[t] = rng.standard_normal((nv[t], dim)).astype(np.float32) * 0.1

    return HetGraph(
        name=name,
        num_vertices=nv,
        feature_dims=dict(spec["features"]),
        relations=relations,
        features=features,
    )
