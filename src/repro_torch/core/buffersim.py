"""On-chip feature-buffer simulator — the measurement tool behind Figs. 3/4/16/17.

Host numpy, the same model as the JAX package's ``repro.core.buffersim``
(its statistics equal bit for bit over the same streams).  Models the NA
sub-stage's source-feature buffer (HiHGNN's NA-Buf; on a GPU the feature
rows a block of threads keeps in shared memory or L2) as an LRU cache of
vertex-feature lines.  The
simulator consumes the NA edge stream in execution order and counts hits,
misses (DRAM/HBM fetches), evictions, and per-vertex replacement counts —
the exact metrics of the paper's Fig. 3 (hit rate) and Fig. 4 (replacement
histogram).  Running it on the original CSR edge order vs the restructured
order quantifies the Graph Restructurer.

``line_rows`` sets the fetch granularity: 1 = per-vertex lines (the ASIC
model of the paper); 8/16/128 = row-tile granularity (a gather that brings a
whole feature tile from device memory at once).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class BufferStats:
    accesses: int
    hits: int
    misses: int
    evictions: int
    dram_bytes: int
    capacity_bytes: int
    line_bytes: int
    replacements_per_vertex: np.ndarray  # evictions counted per line id

    @property
    def hit_rate(self) -> float:
        return self.hits / max(1, self.accesses)

    def replacement_histogram(self, max_bucket: int = 8) -> Dict[str, np.ndarray]:
        """Paper Fig. 4: ratio of #vertex and of #access by replacement count.

        Bucket i = lines evicted exactly i times (last bucket = >=max).
        """
        rep = self.replacements_per_vertex
        touched = rep >= 0
        counts = np.clip(rep[touched], 0, max_bucket)
        n = counts.size
        vert_ratio = np.bincount(counts, minlength=max_bucket + 1) / max(1, n)
        # each eviction of a line later re-fetched = one extra DRAM access
        acc = np.bincount(counts, weights=counts + 1, minlength=max_bucket + 1)
        acc_ratio = acc / max(1.0, acc.sum())
        return {"vertex_ratio": vert_ratio, "access_ratio": acc_ratio}


class BufferSim:
    """Fully-associative LRU buffer over feature lines."""

    def __init__(
        self,
        capacity_bytes: int,
        feature_dim: int,
        feature_bytes: int = 2,
        line_rows: int = 1,
    ):
        self.capacity_bytes = int(capacity_bytes)
        self.line_bytes = int(feature_dim) * feature_bytes * line_rows
        self.num_lines = max(1, self.capacity_bytes // self.line_bytes)
        self.line_rows = line_rows

    def run(self, row_stream: np.ndarray, num_rows: Optional[int] = None) -> BufferStats:
        """Consume vertex-row accesses in order; return stats.

        ``row_stream`` — int array of feature-row ids (the NA edge stream's
        source endpoints, in execution order).
        """
        lines = np.asarray(row_stream, dtype=np.int64) // self.line_rows
        n_ids = int(lines.max()) + 1 if lines.size else 1
        if num_rows is not None:
            n_ids = max(n_ids, (num_rows + self.line_rows - 1) // self.line_rows)
        lru: OrderedDict[int, None] = OrderedDict()
        hits = misses = evictions = 0
        # -1 = never touched; else eviction count
        rep = np.full(n_ids, -1, dtype=np.int64)
        cap = self.num_lines
        for ln in lines:
            ln = int(ln)
            if ln in lru:
                hits += 1
                lru.move_to_end(ln)
            else:
                misses += 1
                if rep[ln] < 0:
                    rep[ln] = 0
                if len(lru) >= cap:
                    victim, _ = lru.popitem(last=False)
                    evictions += 1
                    rep[victim] += 1
                lru[ln] = None
        return BufferStats(
            accesses=int(lines.size),
            hits=hits,
            misses=misses,
            evictions=evictions,
            dram_bytes=misses * self.line_bytes,
            capacity_bytes=self.capacity_bytes,
            line_bytes=self.line_bytes,
            replacements_per_vertex=rep,
        )


@dataclasses.dataclass
class GFPCycleModel:
    """Roofline-flavoured cycle model for the GFP stage on the backend.

    compute: MAC throughput of the backend's systolic/SIMD datapath.
    memory:  DRAM bytes (from BufferSim misses) over HBM bandwidth.
    cycles = max(compute, memory) — the backend pipelines the two.

    Defaults approximate HiHGNN (Table 3: 512 GB/s HBM 1.0; 32x32 systolic
    @1 GHz ≈ 1024 MACs/cycle).
    """

    macs_per_cycle: float = 1024.0
    bytes_per_cycle: float = 512.0  # 512 GB/s at 1 GHz

    def cycles(self, macs: int, dram_bytes: int) -> float:
        return max(macs / self.macs_per_cycle, dram_bytes / self.bytes_per_cycle)


def na_edge_stream_original(rel_src: np.ndarray, rel_dst: np.ndarray) -> np.ndarray:
    """Baseline NA execution order: edges sorted by destination (CSR walk),
    source features gathered in whatever order the topology dictates."""
    o = np.lexsort((rel_src, rel_dst))
    return np.asarray(rel_src)[o]


def simulate_na(
    src_stream: np.ndarray,
    feature_dim: int,
    capacity_bytes: int,
    feature_bytes: int = 2,
    line_rows: int = 1,
    num_rows: Optional[int] = None,
) -> BufferStats:
    sim = BufferSim(capacity_bytes, feature_dim, feature_bytes, line_rows)
    return sim.run(src_stream, num_rows=num_rows)


def simulate_na_dual(
    src_stream: np.ndarray,
    dst_stream: np.ndarray,
    num_src: int,
    num_dst: int,
    feature_dim: int,
    capacity_bytes: int,
    feature_bytes: int = 2,
    line_rows: int = 1,
) -> BufferStats:
    """NA buffer model with BOTH access streams sharing the buffer:
    per edge, the source feature line and the destination partial-sum line
    are touched (HiHGNN's NA-Buf holds both).

    Destination lines occupy the id range [num_src, num_src+num_dst); the
    Fig. 3/4-style per-*vertex-feature* statistics are the first ``num_src``
    entries of ``replacements_per_vertex``.
    """
    src_stream = np.asarray(src_stream, dtype=np.int64)
    dst_stream = np.asarray(dst_stream, dtype=np.int64)
    assert src_stream.shape == dst_stream.shape
    comb = np.empty(2 * src_stream.size, dtype=np.int64)
    comb[0::2] = src_stream
    comb[1::2] = num_src + dst_stream
    sim = BufferSim(capacity_bytes, feature_dim, feature_bytes, line_rows)
    return sim.run(comb, num_rows=num_src + num_dst)
