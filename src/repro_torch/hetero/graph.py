"""Typed heterogeneous graph structures and relation composition.

A ``Relation`` is a directed bipartite edge set between two vertex types,
stored as a sorted COO edge list.  ``compose_relations`` is the SGB
primitive: the boolean product of two relations (reachability through the
shared middle vertex type), with an exact cost model counting the work the
paper's SGB stage performs (join multiply-accumulates and bytes moved).

Host-side numpy, bitwise-equal to the JAX package's ``repro.hetero.graph``
(the port keeps its own copy so that it never imports that package).
``Relation.dense_padded`` writes a relation straight into a tile-padded 0/1
tensor on a device, the input form of the device SGB composer.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

IDX = np.int32
_IDX_BYTES = 4
# Feature element size used for memory-traffic accounting (bf16).
FEATURE_BYTES = 2


@dataclasses.dataclass(frozen=True)
class CompositionCost:
    """Exact operation/byte counters for one relation composition.

    ``macs`` counts join pairs generated (the multiply-accumulates an
    SpGEMM datapath performs before output dedup); ``bytes_read`` and
    ``bytes_written`` count edge-list traffic in and out.
    """

    macs: int
    bytes_read: int
    bytes_written: int

    def __add__(self, other: "CompositionCost") -> "CompositionCost":
        return CompositionCost(
            self.macs + other.macs,
            self.bytes_read + other.bytes_read,
            self.bytes_written + other.bytes_written,
        )

    @staticmethod
    def zero() -> "CompositionCost":
        """The additive identity."""
        return CompositionCost(0, 0, 0)

    @property
    def total_bytes(self) -> int:
        """Edge-list bytes read and written."""
        return self.bytes_read + self.bytes_written


@dataclasses.dataclass(frozen=True)
class Relation:
    """Directed bipartite edge set ``src_type -> dst_type``.

    Edges are kept sorted by (src, dst) and deduplicated; this is the
    canonical layout the frontend relies on.
    """

    src_type: str
    dst_type: str
    num_src: int
    num_dst: int
    src: np.ndarray  # (E,) int32
    dst: np.ndarray  # (E,) int32

    def __post_init__(self):
        if self.src.dtype != IDX or self.dst.dtype != IDX:
            raise TypeError("Relation edge arrays must be int32")
        if self.src.shape != self.dst.shape:
            raise ValueError("Relation src/dst shapes differ")

    @property
    def name(self) -> str:
        """Two-letter relation name, e.g. ``"AP"``."""
        return f"{self.src_type}{self.dst_type}"

    @property
    def num_edges(self) -> int:
        """Edge count."""
        return int(self.src.shape[0])

    @property
    def nbytes(self) -> int:
        """Edge-list bytes (two int32 per edge)."""
        return self.num_edges * 2 * _IDX_BYTES

    @staticmethod
    def from_edges(
        src_type: str,
        dst_type: str,
        num_src: int,
        num_dst: int,
        src: np.ndarray,
        dst: np.ndarray,
    ) -> "Relation":
        """Build a canonical (sorted, deduped) relation from raw edges."""
        src = np.asarray(src, dtype=IDX)
        dst = np.asarray(dst, dtype=IDX)
        if src.size:
            key = src.astype(np.int64) * num_dst + dst.astype(np.int64)
            key = np.unique(key)
            src = (key // num_dst).astype(IDX)
            dst = (key % num_dst).astype(IDX)
        return Relation(src_type, dst_type, num_src, num_dst, src, dst)

    def reverse(self) -> "Relation":
        """The reverse relation (dst -> src), canonicalized."""
        return Relation.from_edges(
            self.dst_type, self.src_type, self.num_dst, self.num_src, self.dst, self.src
        )

    def to_csr(self) -> Tuple[np.ndarray, np.ndarray]:
        """Return (row_ptr[num_src+1], col_idx[E]) sorted by (src, dst)."""
        counts = np.bincount(self.src, minlength=self.num_src)
        row_ptr = np.zeros(self.num_src + 1, dtype=np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        return row_ptr, self.dst.copy()

    def out_degrees(self) -> np.ndarray:
        """Out-degree of every source vertex."""
        return np.bincount(self.src, minlength=self.num_src)

    def in_degrees(self) -> np.ndarray:
        """In-degree of every destination vertex."""
        return np.bincount(self.dst, minlength=self.num_dst)

    def dense(self, dtype=np.float32) -> np.ndarray:
        """Dense 0/1 adjacency on the host — oracle use (small graphs)."""
        a = np.zeros((self.num_src, self.num_dst), dtype=dtype)
        a[self.src, self.dst] = 1
        return a

    def dense_padded(self, device, tile: int, dtype=torch.uint8) -> torch.Tensor:
        """Tile-padded dense 0/1 adjacency written straight on ``device``.

        The edges scatter into a zero ``(ceil(num_src/tile)*tile,
        ceil(num_dst/tile)*tile)`` tensor with one ``index_put_``; no host
        dense matrix is built.  The device SGB composer's input form.
        """
        rows = -(-self.num_src // tile) * tile
        cols = -(-self.num_dst // tile) * tile
        out = torch.zeros((rows, cols), dtype=dtype, device=device)
        src = torch.from_numpy(self.src).to(device=device, dtype=torch.long)
        dst = torch.from_numpy(self.dst).to(device=device, dtype=torch.long)
        out.index_put_((src, dst), torch.ones((), dtype=dtype, device=device))
        return out

    @staticmethod
    def from_dense(src_type: str, dst_type: str, dense) -> "Relation":
        """Inverse of :meth:`dense`: 0/1 adjacency (numpy array or torch
        tensor on any device) -> canonical relation.

        ``np.nonzero`` and ``torch.nonzero`` both walk row-major, so the
        edge list comes out already in the canonical (src, dst) order.
        """
        if isinstance(dense, torch.Tensor):
            nz = torch.nonzero(dense > 0).to(torch.int32).cpu().numpy()
            src, dst = nz[:, 0], nz[:, 1]
        else:
            src, dst = np.nonzero(np.asarray(dense) > 0)
        return Relation(
            src_type, dst_type, int(dense.shape[0]), int(dense.shape[1]),
            np.ascontiguousarray(src, dtype=IDX), np.ascontiguousarray(dst, dtype=IDX),
        )


def compose_relations(
    r1: Relation, r2: Relation
) -> Tuple[Relation, CompositionCost]:
    """Boolean relation product: edges (u, w) s.t. exists v with u->v in r1, v->w in r2.

    Sorted-merge join on the shared middle type.  The cost model counts the
    join pairs *before* dedup (``macs``) plus the edge bytes streamed.
    """
    if r1.dst_type != r2.src_type:
        raise ValueError(f"cannot compose {r1.name} with {r2.name}")
    if r1.num_dst != r2.num_src:
        raise ValueError("middle-type cardinality mismatch")

    order1 = np.argsort(r1.dst, kind="stable")
    mid1 = r1.dst[order1]
    left = r1.src[order1]

    ptr2, cols2 = r2.to_csr()
    deg2 = (ptr2[1:] - ptr2[:-1]).astype(np.int64)

    # every r1 edge (u, v) expands to deg2[v] output pairs
    expand = deg2[mid1]
    macs = int(expand.sum())
    if macs == 0:
        out = Relation.from_edges(
            r1.src_type, r2.dst_type, r1.num_src, r2.num_dst,
            np.empty(0, IDX), np.empty(0, IDX),
        )
    else:
        out_src = np.repeat(left, expand)
        starts = ptr2[mid1]
        offs = np.arange(macs, dtype=np.int64) - np.repeat(
            np.cumsum(expand) - expand, expand
        )
        out_dst = cols2[np.repeat(starts, expand) + offs]
        out = Relation.from_edges(
            r1.src_type, r2.dst_type, r1.num_src, r2.num_dst, out_src, out_dst
        )

    cost = CompositionCost(
        macs=macs,
        bytes_read=r1.nbytes + r2.nbytes,
        bytes_written=out.nbytes,
    )
    return out, cost


@dataclasses.dataclass
class HetGraph:
    """A heterogeneous graph: typed vertex sets, features, one-hop relations."""

    name: str
    num_vertices: Dict[str, int]  # vertex type -> count
    feature_dims: Dict[str, int]  # vertex type -> raw feature dim (0 = featureless)
    relations: Dict[str, Relation]  # "AP" -> Relation(A->P)
    features: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    _fingerprint: Optional[str] = dataclasses.field(
        default=None, repr=False, compare=False)

    def fingerprint(self) -> str:
        """Stable content hash of the topology (cache key for the pipeline).

        Covers vertex counts and every relation's edge *set*, hashed through
        the canonical sorted-unique key form.  Features are excluded: the
        frontend operates on topology only.  Equal to the JAX package's
        fingerprint of the same graph.
        """
        if self._fingerprint is None:
            h = hashlib.blake2b(digest_size=16)
            for t in self.vertex_types:
                h.update(f"{t}:{self.num_vertices[t]};".encode())
            for rname in self.relation_names:
                r = self.relations[rname]
                key = r.src.astype(np.int64) * r.num_dst + r.dst.astype(np.int64)
                key = np.unique(key)
                h.update(
                    f"{rname}:{r.num_src}x{r.num_dst}:{key.size};".encode())
                h.update(np.ascontiguousarray(key).tobytes())
            object.__setattr__(
                self, "_fingerprint", f"{self.name}-{h.hexdigest()}")
        return self._fingerprint

    @property
    def vertex_types(self) -> List[str]:
        """Sorted vertex type names."""
        return sorted(self.num_vertices)

    @property
    def relation_names(self) -> List[str]:
        """Sorted one-hop relation names."""
        return sorted(self.relations)

    def relation(self, name: str) -> Relation:
        """The one-hop relation called ``name``."""
        return self.relations[name]

    def total_vertices(self) -> int:
        """Vertex count over every type."""
        return sum(self.num_vertices.values())

    def total_edges(self) -> int:
        """Edge count over every one-hop relation."""
        return sum(r.num_edges for r in self.relations.values())

    def apply_delta(self, delta) -> "HetGraph":
        """Return a new canonical graph with a :class:`GraphDelta` applied.

        Thin forwarder to :func:`repro_torch.hetero.delta.apply_delta`
        (kept there to avoid a circular import); the result shares no
        mutable state with ``self`` and its fingerprint memo starts cold.
        """
        from repro_torch.hetero.delta import apply_delta as _apply

        return _apply(self, delta)

    def metapath_is_valid(self, metapath: str) -> bool:
        """A metapath 'APSPA' is valid iff every adjacent pair is a relation."""
        if len(metapath) < 2:
            return False
        return all(
            metapath[i : i + 2] in self.relations for i in range(len(metapath) - 1)
        )

    def enumerate_metapaths(self, max_hops: int, start: Optional[str] = None) -> List[str]:
        """All valid metapaths up to ``max_hops`` relations (paper Fig. 2 x-axis)."""
        paths: List[str] = []
        level = [t for t in self.vertex_types if start is None or t == start]
        for _ in range(max_hops):
            nxt = []
            for p in level:
                last = p[-1]
                for rel in self.relations.values():
                    if rel.src_type == last:
                        nxt.append(p + rel.dst_type)
            paths.extend(q for q in nxt if len(q) >= 2)
            level = nxt
        return paths
