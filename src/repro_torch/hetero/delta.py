"""Graph deltas: typed, validated topology mutations for streaming tenants.

A ``GraphDelta`` is a value describing edge insertions/removals per
relation plus vertex additions per type.  ``HetGraph.apply_delta`` turns
it into a new canonical graph; the pipeline layer
(``FrontendPipeline.apply_delta``) uses the same object to bound the
blast radius of the update — only metapaths that cross a *touched*
relation recompute, everything else migrates from the warm cache.

Host-side numpy, a copy of the JAX package's ``repro.hetero.delta``: a
delta-applied graph and its fingerprint are equal to the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Set, Tuple

import numpy as np

from repro_torch.hetero.graph import IDX, HetGraph, Relation

EdgeList = Tuple[np.ndarray, np.ndarray]  # (src, dst) index arrays


def _canon_edges(src, dst) -> EdgeList:
    src = np.atleast_1d(np.asarray(src, dtype=IDX))
    dst = np.atleast_1d(np.asarray(dst, dtype=IDX))
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError("delta edge lists must be matching 1-D arrays")
    return src, dst


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """Edge/vertex mutations to apply to a :class:`HetGraph`.

    ``add_edges`` / ``remove_edges`` map relation names (e.g. ``"PA"``)
    to ``(src, dst)`` index arrays; ``add_vertices`` maps vertex types to
    the number of fresh vertices appended to that type.  Removing a
    relation's edge that is not present, or referencing an out-of-range
    vertex, is an error at :meth:`HetGraph.apply_delta` time — a delta
    that silently no-ops hides upstream bugs.
    """

    add_edges: Mapping[str, EdgeList] = dataclasses.field(default_factory=dict)
    remove_edges: Mapping[str, EdgeList] = dataclasses.field(default_factory=dict)
    add_vertices: Mapping[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "add_edges", {
            k: _canon_edges(*v) for k, v in dict(self.add_edges).items()})
        object.__setattr__(self, "remove_edges", {
            k: _canon_edges(*v) for k, v in dict(self.remove_edges).items()})
        object.__setattr__(self, "add_vertices", {
            k: int(v) for k, v in dict(self.add_vertices).items()})

    @staticmethod
    def insert(relation: str, src, dst) -> "GraphDelta":
        """Convenience: a pure edge-insert delta on one relation."""
        return GraphDelta(add_edges={relation: (src, dst)})

    @staticmethod
    def remove(relation: str, src, dst) -> "GraphDelta":
        """Convenience: a pure edge-removal delta on one relation."""
        return GraphDelta(remove_edges={relation: (src, dst)})

    @property
    def insert_only(self) -> bool:
        """True when the delta only ever adds (edges or vertices).

        Insert-only deltas admit the exact incremental composition
        identity ``new = old ∪ (Δl ∘ r_new) ∪ (l_old ∘ Δr)`` (the boolean
        semiring is monotone); removals force a recompute of touched
        products.
        """
        return not self.remove_edges

    def touched_relations(self, graph: HetGraph) -> Set[str]:
        """Relation names whose edge set OR shape changes under this delta.

        A vertex addition touches every relation incident to the grown
        type: the edge lists survive but ``num_src``/``num_dst`` (and with
        them every composed product's shape) do not.
        """
        touched = set(self.add_edges) | set(self.remove_edges)
        for rname, r in graph.relations.items():
            if r.src_type in self.add_vertices or r.dst_type in self.add_vertices:
                touched.add(rname)
        return touched

    def touched_vertices(self, graph: HetGraph) -> Dict[str, np.ndarray]:
        """Per-type sorted-unique vertex ids incident to any edge change.

        This is the blast radius used to invalidate ``DependencyExtractor``
        memo entries: a cached k-hop closure that avoids every touched
        vertex of every type is still exact after the delta.  Newly added
        vertices are included (a fresh vertex changes frontier arrays of
        any closure that would now reach it — none can, but shapes of
        per-type universes do change, which ``touched_relations`` already
        forces through recompute).
        """
        acc: Dict[str, list] = {}
        for rname in set(self.add_edges) | set(self.remove_edges):
            rel = graph.relations[rname]
            for edges in (self.add_edges.get(rname), self.remove_edges.get(rname)):
                if edges is None:
                    continue
                src, dst = edges
                acc.setdefault(rel.src_type, []).append(src)
                acc.setdefault(rel.dst_type, []).append(dst)
        return {t: np.unique(np.concatenate(v).astype(np.int64))
                for t, v in acc.items()}

    def delta_relation(self, graph: HetGraph, name: str) -> Relation:
        """The added edges of ``name`` as a canonical relation.

        Shapes use the *post-delta* vertex counts so the delta relation
        composes against post-delta operands.  Relations without added
        edges come back empty (composition with an empty operand is the
        empty relation — the union identity degenerates correctly).
        """
        rel = graph.relations[name]
        n_src = rel.num_src + self.add_vertices.get(rel.src_type, 0)
        n_dst = rel.num_dst + self.add_vertices.get(rel.dst_type, 0)
        src, dst = self.add_edges.get(name, (np.empty(0, IDX), np.empty(0, IDX)))
        return Relation.from_edges(
            rel.src_type, rel.dst_type, n_src, n_dst, src, dst)


def union_relations(a: Relation, b: Relation) -> Relation:
    """Canonical union of two same-typed relations (boolean OR).

    ``Relation.from_edges`` sorts and dedups, so the result is bitwise
    identical to composing the union from scratch — the property the
    incremental SGB's bitwise-equality guarantee rests on.
    """
    if (a.src_type, a.dst_type) != (b.src_type, b.dst_type):
        raise ValueError(f"cannot union {a.name} with {b.name}")
    if (a.num_src, a.num_dst) != (b.num_src, b.num_dst):
        raise ValueError("shape mismatch in relation union")
    return Relation.from_edges(
        a.src_type, a.dst_type, a.num_src, a.num_dst,
        np.concatenate([a.src, b.src]), np.concatenate([a.dst, b.dst]))


def apply_delta(graph: HetGraph, delta: GraphDelta) -> HetGraph:
    """Return a new canonical graph with ``delta`` applied.

    Validates every referenced relation/vertex/edge: out-of-range indices
    and removals of absent edges raise ``ValueError``.  Features of grown
    types are zero-extended (fresh vertices start featureless); the new
    graph's fingerprint memo starts cold.
    """
    for name in set(delta.add_edges) | set(delta.remove_edges):
        if name not in graph.relations:
            raise ValueError(f"delta references unknown relation {name!r}")
    for t in delta.add_vertices:
        if t not in graph.num_vertices:
            raise ValueError(f"delta references unknown vertex type {t!r}")

    num_vertices = dict(graph.num_vertices)
    for t, n in delta.add_vertices.items():
        if n < 0:
            raise ValueError("add_vertices counts must be non-negative")
        num_vertices[t] += n

    relations: Dict[str, Relation] = {}
    for rname, rel in graph.relations.items():
        n_src = num_vertices[rel.src_type]
        n_dst = num_vertices[rel.dst_type]
        src, dst = rel.src, rel.dst
        key = src.astype(np.int64) * n_dst + dst.astype(np.int64)
        rm = delta.remove_edges.get(rname)
        if rm is not None:
            rsrc, rdst = rm
            if rsrc.size and (rsrc.min() < 0 or rsrc.max() >= n_src
                              or rdst.min() < 0 or rdst.max() >= n_dst):
                raise ValueError(f"remove_edges[{rname!r}] out of range")
            rkey = np.unique(rsrc.astype(np.int64) * n_dst + rdst.astype(np.int64))
            present = np.isin(rkey, key, assume_unique=False)
            if not present.all():
                raise ValueError(
                    f"remove_edges[{rname!r}] contains edges not in the graph")
            key = key[~np.isin(key, rkey)]
        ad = delta.add_edges.get(rname)
        if ad is not None:
            asrc, adst = ad
            if asrc.size and (asrc.min() < 0 or asrc.max() >= n_src
                              or adst.min() < 0 or adst.max() >= n_dst):
                raise ValueError(f"add_edges[{rname!r}] out of range")
            key = np.concatenate(
                [key, asrc.astype(np.int64) * n_dst + adst.astype(np.int64)])
        key = np.unique(key)
        relations[rname] = Relation(
            rel.src_type, rel.dst_type, n_src, n_dst,
            (key // n_dst).astype(IDX), (key % n_dst).astype(IDX))

    features = {}
    for t, f in graph.features.items():
        grow = delta.add_vertices.get(t, 0)
        if grow:
            f = np.concatenate(
                [f, np.zeros((grow,) + f.shape[1:], dtype=f.dtype)])
        features[t] = f

    return HetGraph(
        name=graph.name,
        num_vertices=num_vertices,
        feature_dims=dict(graph.feature_dims),
        relations=relations,
        features=features,
    )
