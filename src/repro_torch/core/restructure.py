"""Graph Restructurer — paper §4.3: decoupling (Alg. 1) + recoupling (Alg. 2).

Decoupling finds a maximum bipartite matching; recoupling completes the
backbone (a vertex cover) with König's construction and partitions the
edges into three subgraphs with no ``Src_out``–``Dst_out`` edges:

    G_a : Src_in  -> Dst_out
    G_b : Src_out -> Dst_in
    G_c : Src_in  -> Dst_in

Vertices are renumbered so that each subgraph's hot side occupies a
contiguous row range of the feature matrix; the banded NA kernels consume
that layout.  Host numpy, bitwise-equal to the JAX package's
``repro.core.restructure``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import tracing
from repro_torch.hetero.graph import IDX, Relation


def decouple(rel: Relation, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Maximum bipartite matching via greedy init + Kuhn augmentation.

    Returns ``(match_src, match_dst)``: for each source vertex the matched
    destination (or -1), and vice versa.  ``seed`` is accepted for the
    reference's signature and unused: the matching is deterministic.
    """
    row_ptr, cols = rel.to_csr()
    n_src, n_dst = rel.num_src, rel.num_dst
    match_src = np.full(n_src, -1, dtype=np.int64)
    match_dst = np.full(n_dst, -1, dtype=np.int64)

    for u in range(n_src):
        for v in cols[row_ptr[u] : row_ptr[u + 1]]:
            if match_dst[v] < 0:
                match_src[u] = v
                match_dst[v] = u
                break

    visited = np.zeros(n_dst, dtype=np.int64)  # stamp per phase
    stamp = 0
    for u0 in range(n_src):
        if match_src[u0] >= 0:
            continue
        stamp += 1
        stack: List[Tuple[int, int]] = [(u0, int(row_ptr[u0]))]
        parent_edge: Dict[int, Tuple[int, int]] = {}
        found = -1
        while stack:
            u, cur = stack[-1]
            if cur >= row_ptr[u + 1]:
                stack.pop()
                continue
            stack[-1] = (u, cur + 1)
            v = int(cols[cur])
            if visited[v] == stamp:
                continue
            visited[v] = stamp
            parent_edge[v] = (u, cur)
            if match_dst[v] < 0:
                found = v
                break
            stack.append((int(match_dst[v]), int(row_ptr[match_dst[v]])))
        if found >= 0:
            v = found
            while True:
                u, _ = parent_edge[v]
                pv = match_src[u]
                match_src[u] = v
                match_dst[v] = u
                if u == u0:
                    break
                v = pv
    return match_src, match_dst


@dataclasses.dataclass
class Backbone:
    """Backbone membership masks over source and destination vertices."""

    src_in: np.ndarray  # bool mask over src vertices (in backbone)
    dst_in: np.ndarray  # bool mask over dst vertices (in backbone)

    @property
    def size(self) -> int:
        """Number of backbone vertices."""
        return int(self.src_in.sum() + self.dst_in.sum())


def select_backbone(
    rel: Relation, match_src: np.ndarray, match_dst: np.ndarray
) -> Backbone:
    """König construction of the backbone (minimum vertex cover).

    Z = vertices reachable from unmatched sources via alternating paths;
    backbone = (Src \\ Z) ∪ (Dst ∩ Z).
    """
    row_ptr, cols = rel.to_csr()
    n_src, n_dst = rel.num_src, rel.num_dst
    z_src = np.zeros(n_src, dtype=bool)
    z_dst = np.zeros(n_dst, dtype=bool)

    frontier = np.where(match_src < 0)[0]
    z_src[frontier] = True
    while frontier.size:
        segs = [cols[row_ptr[u] : row_ptr[u + 1]] for u in frontier]
        if segs:
            nbrs = np.unique(np.concatenate(segs)) if len(segs) > 1 else np.unique(segs[0])
        else:
            nbrs = np.empty(0, dtype=cols.dtype)
        new_dst = nbrs[~z_dst[nbrs]]
        z_dst[new_dst] = True
        back = match_dst[new_dst]
        back = back[back >= 0]
        back = back[~z_src[back]]
        z_src[back] = True
        frontier = back
    deg = rel.out_degrees() if n_src else np.zeros(0)
    src_in = (~z_src) & (deg > 0)
    dst_in = z_dst.copy()
    return Backbone(src_in=src_in, dst_in=dst_in)


@dataclasses.dataclass
class Subgraph:
    """A recoupled subgraph with compact local vertex numbering.

    ``src_ids``/``dst_ids`` map local -> global vertex ids; ``src``/``dst``
    are local edge endpoints.  ``kind`` in {"in_out", "out_in", "in_in"}.
    """

    kind: str
    src_ids: np.ndarray
    dst_ids: np.ndarray
    src: np.ndarray
    dst: np.ndarray

    @property
    def num_edges(self) -> int:
        """Edge count."""
        return int(self.src.shape[0])

    @property
    def num_src(self) -> int:
        """Source vertex count."""
        return int(self.src_ids.shape[0])

    @property
    def num_dst(self) -> int:
        """Destination vertex count."""
        return int(self.dst_ids.shape[0])


def _first_appearance_perm(id_lists: List[np.ndarray], n: int) -> np.ndarray:
    """New id of each global vertex = rank of its first appearance across
    the concatenated id lists; vertices never appearing go to the tail."""
    perm = np.full(n, -1, np.int64)
    cat = (np.concatenate(id_lists) if id_lists else np.empty(0, np.int64))
    touched = 0
    if cat.size:
        uniq, first = np.unique(cat, return_index=True)
        order = uniq[np.argsort(first)]
        perm[order] = np.arange(order.size)
        touched = order.size
    rest = np.flatnonzero(perm < 0)
    perm[rest] = np.arange(touched, touched + rest.size)
    return perm


@dataclasses.dataclass
class RestructuredGraph:
    """Output of the Graph Restructurer for one semantic graph."""

    original: Relation
    backbone: Backbone
    subgraphs: List[Subgraph]  # scheduled order: in_in, in_out, out_in
    match_src: np.ndarray
    match_dst: np.ndarray
    _perms: Optional[Tuple[np.ndarray, np.ndarray]] = dataclasses.field(
        default=None, repr=False, compare=False)

    def scheduled_edges(self, renumbered: bool = False
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """(src, dst) edge stream in restructured execution order.

        ``renumbered=False`` gives global vertex ids (only the order
        changes); ``renumbered=True`` gives the banded layout the NA
        kernels consume, with vertices renumbered by ``permutations()``.
        """
        srcs = [sg.src_ids[sg.src] for sg in self.subgraphs]
        dsts = [sg.dst_ids[sg.dst] for sg in self.subgraphs]
        s = np.concatenate(srcs)
        d = np.concatenate(dsts)
        if renumbered:
            sp, dp = self.permutations()
            s, d = sp[s], dp[d]
        return s, d

    def permutations(self) -> Tuple[np.ndarray, np.ndarray]:
        """(src_perm, dst_perm): new id of each global vertex under the
        restructured layout (first-appearance order over the scheduled
        subgraphs; untouched vertices go to the tail).  Memoized."""
        if self._perms is None:
            rel = self.original
            self._perms = (
                _first_appearance_perm(
                    [sg.src_ids for sg in self.subgraphs], rel.num_src),
                _first_appearance_perm(
                    [sg.dst_ids for sg in self.subgraphs], rel.num_dst),
            )
        return self._perms

    def packed(self, renumbered: bool = True,
               weight: Optional[np.ndarray] = None):
        """Banded ``PackedEdges`` blocks for the NA kernels.

        Built from the scheduled (by default renumbered) edge stream; the
        pipeline caches this per semantic graph.  ``weight`` gives per-edge
        weights in scheduled order (None: unweighted).
        """
        from repro_torch.kernels.seg_sum import pack_edge_blocks

        s, d = self.scheduled_edges(renumbered=renumbered)
        return pack_edge_blocks(s, d, self.original.num_src,
                                self.original.num_dst, weight=weight)

    def packed_delta(self, old_rg: "RestructuredGraph", old_packed,
                     renumbered: bool = True):
        """Banded blocks via block-local repack against a prior packing.

        Splices the unchanged prefix/suffix blocks of ``old_packed`` (the
        packing of ``old_rg``'s scheduled stream) around a freshly packed
        edit window (``kernels.seg_sum.splice_pack_edge_blocks``):
        bitwise-equal to :meth:`packed`.  Returns ``(packed,
        reused_blocks, total_blocks)``; a splice-incompatible prior
        packing degrades to a full repack (``reused_blocks == 0``).
        """
        from repro_torch.kernels.seg_sum import splice_pack_edge_blocks

        s, d = self.scheduled_edges(renumbered=renumbered)
        so, do = old_rg.scheduled_edges(renumbered=renumbered)
        out = splice_pack_edge_blocks(
            s, d, so, do, old_packed,
            self.original.num_src, self.original.num_dst)
        if out is None:
            pk = self.packed(renumbered=renumbered)
            return pk, 0, pk.num_blocks
        return out

    def validate(self) -> None:
        """Check the invariants of §4.3.1; raises ``ValueError`` on a breach."""
        rel = self.original
        bb = self.backbone
        covered = bb.src_in[rel.src] | bb.dst_in[rel.dst]
        if not bool(covered.all()):
            raise ValueError("backbone is not a vertex cover")
        s, d = self.scheduled_edges()
        key = np.sort(s.astype(np.int64) * rel.num_dst + d)
        ref = np.sort(rel.src.astype(np.int64) * rel.num_dst + rel.dst)
        if not np.array_equal(key, ref):
            raise ValueError("subgraphs do not partition the edges")
        if bb.size != int((self.match_src >= 0).sum()):
            raise ValueError("backbone size differs from the matching size")


def _barycenter_ranks(
    ls: np.ndarray, ld: np.ndarray, n_s: int, n_d: int, iters: int = 4
) -> Tuple[np.ndarray, np.ndarray]:
    """Iterative barycenter (bandwidth-minimizing) ranks for a bipartite
    edge set: alternately place each side at the mean position of its
    neighbours."""
    ps = np.argsort(np.argsort(-np.bincount(ls, minlength=n_s)))
    pd = np.arange(n_d)
    for _ in range(iters):
        sums = np.zeros(n_d)
        cnt = np.zeros(n_d)
        np.add.at(sums, ld, ps[ls])
        np.add.at(cnt, ld, 1)
        key_d = np.where(cnt > 0, sums / np.maximum(cnt, 1), n_s)
        pd = np.argsort(np.argsort(key_d))
        sums = np.zeros(n_s)
        cnt = np.zeros(n_s)
        np.add.at(sums, ls, pd[ld])
        np.add.at(cnt, ls, 1)
        key_s = np.where(cnt > 0, sums / np.maximum(cnt, 1), n_d)
        ps = np.argsort(np.argsort(key_s))
    return ps, pd


def _mk_subgraph(
    kind: str,
    src_mask_edges: np.ndarray,
    rel: Relation,
    order_src: np.ndarray,
    order_dst: np.ndarray,
    affinity: str = "barycenter",
) -> Subgraph:
    """Extract masked edges; renumber endpoints compactly for locality.

    ``affinity`` picks the within-subgraph ordering: "none", "minsrc"
    (group destinations under their hottest source) or "barycenter".
    """
    es = rel.src[src_mask_edges]
    ed = rel.dst[src_mask_edges]
    sid = order_src[np.isin(order_src, es, assume_unique=True)]
    did = order_dst[np.isin(order_dst, ed, assume_unique=True)]
    lmap_s = np.full(rel.num_src, -1, dtype=np.int64)
    lmap_s[sid] = np.arange(sid.size)
    lmap_d = np.full(rel.num_dst, -1, dtype=np.int64)
    lmap_d[did] = np.arange(did.size)
    ls, ld = lmap_s[es], lmap_d[ed]

    if ld.size and affinity == "minsrc":
        min_src = np.full(did.size, np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(min_src, ld, ls)
        rerank = np.lexsort((np.arange(did.size), min_src))
        new_of_old = np.empty(did.size, dtype=np.int64)
        new_of_old[rerank] = np.arange(did.size)
        did = did[rerank]
        ld = new_of_old[ld]
    elif ld.size and affinity == "barycenter":
        ps, pd = _barycenter_ranks(ls, ld, sid.size, did.size)
        inv_s = np.argsort(ps)
        inv_d = np.argsort(pd)
        sid = sid[inv_s]
        did = did[inv_d]
        ls = ps[ls]
        ld = pd[ld]

    # sort edges by (dst, src) — the NA stream order on device
    o = np.lexsort((ls, ld))
    return Subgraph(
        kind=kind,
        src_ids=sid.astype(IDX),
        dst_ids=did.astype(IDX),
        src=ls[o].astype(IDX),
        dst=ld[o].astype(IDX),
    )


def recouple(
    rel: Relation,
    match_src: np.ndarray,
    match_dst: np.ndarray,
    degree_order: bool = True,
    affinity: str = "barycenter",
) -> RestructuredGraph:
    """Algorithm 2: backbone selection + subgraph generation.

    ``degree_order=True`` renumbers vertices within each class by
    descending degree.  Scheduled order is in_in -> in_out -> out_in.
    """
    bb = select_backbone(rel, match_src, match_dst)
    in_s = bb.src_in[rel.src]
    in_d = bb.dst_in[rel.dst]
    masks = {
        "in_in": in_s & in_d,
        "in_out": in_s & ~in_d,
        "out_in": ~in_s & in_d,
    }
    if (~(in_s | in_d)).any():
        raise ValueError("Src_out–Dst_out edge found (cover violated)")

    if degree_order:
        order_src = np.argsort(-rel.out_degrees(), kind="stable")
        order_dst = np.argsort(-rel.in_degrees(), kind="stable")
    else:
        order_src = np.arange(rel.num_src)
        order_dst = np.arange(rel.num_dst)

    subs = [
        _mk_subgraph(k, masks[k], rel, order_src, order_dst, affinity=affinity)
        for k in ("in_in", "in_out", "out_in")
    ]
    return RestructuredGraph(
        original=rel,
        backbone=bb,
        subgraphs=subs,
        match_src=match_src,
        match_dst=match_dst,
    )


def restructure(
    rel: Relation, degree_order: bool = True, affinity: str = "barycenter",
    metapath: str = "",
) -> RestructuredGraph:
    """Full Graph Restructurer pass: decouple -> recouple -> validate.
    Each stage is a span carrying ``metapath`` (the relation's name when
    not given) and the edge count."""
    attrs = {"metapath": metapath or rel.name, "edges": rel.num_edges}
    with tracing.span("frontend.restructure.decouple", **attrs):
        ms, md = decouple(rel)
    with tracing.span("frontend.restructure.recouple", **attrs):
        rg = recouple(rel, ms, md, degree_order=degree_order, affinity=affinity)
    with tracing.span("frontend.restructure.validate", **attrs):
        rg.validate()
    return rg
