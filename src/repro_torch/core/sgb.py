"""Semantic Graph Build (SGB) stage: planners + host executor + cost model.

Planners (copies of the JAX package's ``repro.core.sgb``):

* ``plan_naive``  — every target metapath is built from scratch by
  left-folding one-hop relations (§3.1);
* ``plan_ctt``    — the paper's scheme: the CTT decomposes each target into
  the longest previously-materialized segments;
* ``plan_ctt_dp`` — optimal segmentation by dynamic programming over the
  materialized set, minimizing predicted join work.

``execute_plan`` runs a plan and accounts exact MACs and bytes, either with
the numpy sorted-merge join (``backend="host"``) or on a device with the
block-sparse SpGEMM (``backend="device"``, :class:`DeviceComposer`: kernel
K3 on a CUDA device, its plain version on the CPU).  Both give
edge-identical products and identical costs.  ``execute_plan_delta`` reruns
a plan over a delta-mutated graph on the host, reusing the pre-delta
products through the insert-only union identity.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.ctt import CallbackTrieTree
from repro_torch.hetero.graph import (CompositionCost, HetGraph, Relation,
                                      compose_relations)
from repro_torch.kernels import ops
from repro_torch.kernels.spgemm_bsr import TILE, spgemm_macs, tile_occupancy


@dataclasses.dataclass(frozen=True)
class PlanStep:
    """One composition ``left ∘ right -> out``."""

    left: str
    right: str
    out: str

    def __repr__(self) -> str:
        return f"{self.left} ∘ {self.right} -> {self.out}"


@dataclasses.dataclass
class Plan:
    """Ordered composition steps; ``targets`` are the requested metapaths."""

    steps: List[PlanStep]
    targets: List[str]
    kind: str  # "naive" | "ctt" | "ctt_dp"

    @property
    def num_compositions(self) -> int:
        """Number of composition steps."""
        return len(self.steps)


def _fold_name(segs: Sequence[str]) -> List[PlanStep]:
    """Left-fold segments (overlapping by one type) into composition steps."""
    steps = []
    acc = segs[0]
    for seg in segs[1:]:
        out = acc + seg[1:]
        steps.append(PlanStep(acc, seg, out))
        acc = out
    return steps


def _check_valid(graph: HetGraph, metapath: str) -> None:
    if not graph.metapath_is_valid(metapath):
        raise ValueError(f"metapath {metapath!r} invalid for dataset {graph.name}")


def plan_naive(graph: HetGraph, targets: Sequence[str]) -> Plan:
    """Conventional generation: each target re-built from one-hop relations."""
    steps: List[PlanStep] = []
    for t in sorted(targets, key=lambda m: (len(m), m)):
        _check_valid(graph, t)
        if len(t) == 2:
            continue
        hops = [t[i : i + 2] for i in range(len(t) - 1)]
        steps.extend(_fold_name(hops))
    return Plan(steps=steps, targets=list(targets), kind="naive")


def plan_ctt(
    graph: HetGraph,
    targets: Sequence[str],
    cache_intermediates: bool = False,
    preloaded: Sequence[str] = (),
) -> Plan:
    """CTT-guided generation (§4.2): reuse materialized semantic graphs.

    Targets run shortest-first; each generated target is inserted into the
    CTT.  ``preloaded`` seeds the CTT with already-materialized metapaths
    (the pipeline cache), so a warm cache shrinks the plan.
    """
    ctt = CallbackTrieTree(graph.relation_names)
    steps: List[PlanStep] = []
    produced = set(graph.relation_names)
    for p in preloaded:
        ctt.insert(p)
        produced.add(p)
    for t in sorted(targets, key=lambda m: (len(m), m)):
        _check_valid(graph, t)
        segs = ctt.decompose(t)
        for st in _fold_name(segs) if len(segs) > 1 else []:
            if st.out in produced:
                continue
            steps.append(st)
            produced.add(st.out)
            if cache_intermediates:
                ctt.insert(st.out)
        ctt.insert(t)
        produced.add(t)
    return Plan(steps=steps, targets=list(targets), kind="ctt")


def plan_ctt_dp(
    graph: HetGraph,
    targets: Sequence[str],
    edge_counts: Optional[Dict[str, int]] = None,
    preloaded: Sequence[str] = (),
) -> Plan:
    """Optimal segmentation via DP instead of the greedy Matcher walk.

    For each target, choose the segmentation over the currently
    materialized set minimizing (#compositions, predicted join work), with
    known edge counts as the prediction.  Intermediates are always cached.
    """
    ctt = CallbackTrieTree(graph.relation_names)
    known: Dict[str, int] = dict(edge_counts or {})
    for r in graph.relation_names:
        known.setdefault(r, graph.relation(r).num_edges)
    steps: List[PlanStep] = []
    produced = set(graph.relation_names)
    for p in preloaded:
        ctt.insert(p)
        produced.add(p)

    def seg_cost(seg: str) -> float:
        return float(known.get(seg, 10 * max(known.values())))

    for t in sorted(targets, key=lambda m: (len(m), m)):
        _check_valid(graph, t)
        n = len(t)
        inf = (1 << 30, float("inf"), [])
        dp: List[Tuple[int, float, List[str]]] = [inf] * n
        dp[0] = (0, 0.0, [])
        for i in range(n - 1):
            if dp[i][0] >= 1 << 30:
                continue
            for j in range(i + 2, n + 1):
                seg = t[i:j]
                if seg in ctt:
                    cand = (dp[i][0] + 1, dp[i][1] + seg_cost(seg), dp[i][2] + [seg])
                    if (cand[0], cand[1]) < (dp[j - 1][0], dp[j - 1][1]):
                        dp[j - 1] = cand
        segs = dp[n - 1][2]
        if not segs:
            raise KeyError(f"no segmentation for {t!r}")
        for st in _fold_name(segs) if len(segs) > 1 else []:
            if st.out in produced:
                continue
            steps.append(st)
            produced.add(st.out)
            ctt.insert(st.out)
        ctt.insert(t)
        produced.add(t)
    return Plan(steps=steps, targets=list(targets), kind="ctt_dp")


@dataclasses.dataclass
class SGBResult:
    """Products and cost counters of one plan execution."""

    graphs: Dict[str, Relation]  # every materialized metapath -> semantic graph
    cost: CompositionCost
    per_step: List[Tuple[PlanStep, CompositionCost]]
    wall_seconds: float
    backend: str = "host"
    device_stats: Optional[Dict[str, int]] = None  # tile-pruning counters

    def target_graphs(self, targets: Sequence[str]) -> Dict[str, Relation]:
        """The semantic graphs of ``targets``, in their order."""
        return {t: self.graphs[t] for t in targets}


class DeviceComposer:
    """PlanStep executor on the block-sparse SpGEMM (kernel K3).

    Every relation lives on ``device`` as a tile-padded uint8 0/1 matrix
    with its tile-occupancy bitmap for the whole plan: one-hop inputs are
    densified there on first use (``Relation.dense_padded``), every product
    stays padded with the bitmap K3 wrote for it, and step outputs become
    edge lists once, in :meth:`extract`.  MACs use the join-pair formula
    (colsum_A · rowsum_B over the middle type) and bytes the edge-list
    traffic, so per-step costs equal the host join's.  Each step brings
    its counters back as Python ints: two host syncs per step (the live
    tile pairs, then the MAC and output-edge counts).
    """

    def __init__(
        self,
        graph: HetGraph,
        device="cuda",
        preloaded: Optional[Dict[str, Relation]] = None,
    ):
        self.graph = graph
        self.device = torch.device(device)
        self._preloaded = dict(preloaded or {})
        # name -> (padded 0/1, occupancy, (rows, cols), edges)
        self._mats: Dict[str, Tuple] = {}
        self.stats: Dict[str, int] = {
            "tile_pairs_total": 0, "tile_pairs_live": 0, "compositions": 0,
        }

    def _get(self, name: str):
        if name not in self._mats:
            rel = self._preloaded.get(name) or self.graph.relation(name)
            padded = rel.dense_padded(self.device, TILE)
            self._mats[name] = (padded, tile_occupancy(padded),
                                (rel.num_src, rel.num_dst), rel.num_edges)
        return self._mats[name]

    def compose(self, step: PlanStep) -> CompositionCost:
        """Run one step; its output replaces any earlier one of that name."""
        a, ao, (m, k), left_edges = self._get(step.left)
        b, bo, (k2, n), right_edges = self._get(step.right)
        if k != k2:
            raise ValueError(f"middle-type cardinality mismatch in {step!r}")
        out, occ, st = ops.compose_boolean_padded(a, b, ao, bo)
        self.stats["tile_pairs_total"] += st["tile_pairs_total"]
        self.stats["tile_pairs_live"] += st["tile_pairs_live"]
        self.stats["compositions"] += 1
        macs, out_edges = torch.stack(
            [spgemm_macs(a, b), torch.count_nonzero(out)]).tolist()
        self._mats[step.out] = (out, occ, (m, n), out_edges)
        # byte accounting matches Relation.nbytes (2 int32 per edge)
        return CompositionCost(
            macs=macs,
            bytes_read=(left_edges + right_edges) * 2 * 4,
            bytes_written=out_edges * 2 * 4,
        )

    def extract(self, name: str) -> Relation:
        """Materialized metapath -> canonical edge-list relation."""
        dense, _, (rows, cols), _ = self._mats[name]
        return Relation.from_dense(name[0], name[-1], dense[:rows, :cols])


def execute_plan(
    graph: HetGraph,
    plan: Plan,
    backend: str = "host",
    device="cuda",
    preloaded: Optional[Dict[str, Relation]] = None,
) -> SGBResult:
    """Run every composition step; count exact MACs/bytes.

    ``backend="host"`` joins edge lists with the numpy sorted-merge join;
    ``backend="device"`` runs each step on ``device`` with the block-sparse
    SpGEMM (:class:`DeviceComposer`).  Both give edge-identical relations
    and identical per-step costs.  ``preloaded`` supplies already
    materialized semantic graphs (from the pipeline cache) that a
    cache-aware plan may use as step inputs.

    The naive plan repeats steps on purpose; a repeat overwrites its name
    with an identical graph.  The device backend extracts the unique step
    outputs in plan order.
    """
    if backend not in ("host", "device"):
        raise ValueError(f"unknown backend {backend!r}")
    t0 = time.perf_counter()
    total = CompositionCost.zero()
    per_step: List[Tuple[PlanStep, CompositionCost]] = []
    mats: Dict[str, Relation] = dict(graph.relations)
    if preloaded:
        mats.update(preloaded)
    if backend == "device":
        composer = DeviceComposer(graph, device=device, preloaded=preloaded)
        for st in plan.steps:
            cost = composer.compose(st)
            total = total + cost
            per_step.append((st, cost))
        for out_name in dict.fromkeys(st.out for st in plan.steps):
            mats[out_name] = composer.extract(out_name)
        return SGBResult(
            graphs=mats,
            cost=total,
            per_step=per_step,
            wall_seconds=time.perf_counter() - t0,
            backend="device",
            device_stats=dict(composer.stats),
        )
    for st in plan.steps:
        out, cost = compose_relations(mats[st.left], mats[st.right])
        mats[st.out] = out
        total = total + cost
        per_step.append((st, cost))
    return SGBResult(
        graphs=mats,
        cost=total,
        per_step=per_step,
        wall_seconds=time.perf_counter() - t0,
        backend="host",
    )


def _with_shape(rel: Relation, num_src: int, num_dst: int) -> Relation:
    """Same edge set under (possibly grown) vertex counts.

    The canonical (src, dst) sort order is shape-independent, so the
    arrays carry over verbatim — no re-sort, no copy.
    """
    if (rel.num_src, rel.num_dst) == (num_src, num_dst):
        return rel
    return Relation(rel.src_type, rel.dst_type, num_src, num_dst,
                    rel.src, rel.dst)


def _rel_diff(new: Relation, old: Relation) -> Relation:
    """Edges of ``new`` absent from ``old`` (both canonical) — the Δ
    operand of the incremental composition identity."""
    old = _with_shape(old, new.num_src, new.num_dst)
    nk = new.src.astype(np.int64) * new.num_dst + new.dst.astype(np.int64)
    ok = old.src.astype(np.int64) * old.num_dst + old.dst.astype(np.int64)
    keep = ~np.isin(nk, ok, assume_unique=True)
    return Relation(new.src_type, new.dst_type, new.num_src, new.num_dst,
                    new.src[keep], new.dst[keep])


def _hops(metapath: str) -> set:
    """The one-hop relation names a metapath crosses."""
    return {metapath[i:i + 2] for i in range(len(metapath) - 1)}


def execute_plan_delta(
    graph: HetGraph,
    plan: Plan,
    old_products: Dict[str, Relation],
    removed_relations: frozenset,
    preloaded: Optional[Dict[str, Relation]] = None,
) -> SGBResult:
    """Run a plan over a delta-mutated graph, reusing prior products.

    For each step ``out = left ∘ right`` where the pre-delta product of
    ``out`` (and of both operands) is known, the boolean semiring's
    monotonicity gives the exact incremental identity

        out_new = out_old ∪ (Δleft ∘ right_new) ∪ (left_old ∘ Δright)

    with ``Δx = x_new \\ x_old`` — O(Δ·deg) join work instead of a full
    recompose.  The identity only holds insert-side: any step whose
    metapath crosses a relation with *removed* edges (``out_old`` may
    hold edges that no longer exist) falls back to a full composition, as
    does any step whose prior product was evicted.  Either way every
    output is built through ``Relation.from_edges``' canonical
    sort-and-dedup, so results are bitwise-equal to a from-scratch
    rebuild of the mutated graph.

    ``old_products`` maps names to their pre-delta relations (one-hop
    relations of the old graph plus cached semantic graphs under the old
    fingerprint); ``removed_relations`` names one-hop relations with edge
    removals.  Host backend only, whatever the spec's ``sgb_backend``
    says (as in the JAX package): the delta path is a cache update, and
    the cache is host-side, so kernel K3 does not run here.

    The returned ``SGBResult.device_stats`` reports
    ``incremental_steps`` / ``full_steps``.
    """
    t0 = time.perf_counter()
    total = CompositionCost.zero()
    per_step: List[Tuple[PlanStep, CompositionCost]] = []
    mats: Dict[str, Relation] = dict(graph.relations)
    if preloaded:
        mats.update(preloaded)
    deltas: Dict[str, Optional[Relation]] = {}

    def delta_of(name: str) -> Optional[Relation]:
        if name not in deltas:
            old = old_products.get(name)
            new = mats.get(name)
            deltas[name] = None if old is None or new is None else _rel_diff(
                new, old)
        return deltas[name]

    stats = {"incremental_steps": 0, "full_steps": 0}
    for st in plan.steps:
        left_new, right_new = mats[st.left], mats[st.right]
        old_out = old_products.get(st.out)
        incremental = (
            old_out is not None
            and not (_hops(st.out) & removed_relations)
            and delta_of(st.left) is not None
            and delta_of(st.right) is not None
        )
        if incremental:
            dl, dr = delta_of(st.left), delta_of(st.right)
            old_l = _with_shape(
                old_products[st.left], left_new.num_src, left_new.num_dst)
            p1, c1 = compose_relations(dl, right_new)
            p2, c2 = compose_relations(old_l, dr)
            old_out = _with_shape(
                old_out, left_new.num_src, right_new.num_dst)
            out = Relation.from_edges(
                old_out.src_type, old_out.dst_type,
                old_out.num_src, old_out.num_dst,
                np.concatenate([old_out.src, p1.src, p2.src]),
                np.concatenate([old_out.dst, p1.dst, p2.dst]))
            cost = CompositionCost(
                macs=c1.macs + c2.macs,
                bytes_read=c1.bytes_read + c2.bytes_read + old_out.nbytes,
                bytes_written=out.nbytes)
            stats["incremental_steps"] += 1
        else:
            out, cost = compose_relations(left_new, right_new)
            stats["full_steps"] += 1
        mats[st.out] = out
        total = total + cost
        per_step.append((st, cost))
    return SGBResult(
        graphs=mats,
        cost=total,
        per_step=per_step,
        wall_seconds=time.perf_counter() - t0,
        backend="host+delta",
        device_stats=stats,
    )


def make_plan(
    graph: HetGraph,
    targets: Sequence[str],
    planner: str = "ctt",
    preloaded: Sequence[str] = (),
    edge_counts: Optional[Dict[str, int]] = None,
) -> Plan:
    """Dispatch to a planner by name: naive, ctt, ctt_cache or ctt_dp."""
    if planner == "naive":
        return plan_naive(graph, targets)
    if planner == "ctt":
        return plan_ctt(graph, targets, preloaded=preloaded)
    if planner == "ctt_cache":
        return plan_ctt(graph, targets, cache_intermediates=True,
                        preloaded=preloaded)
    if planner == "ctt_dp":
        return plan_ctt_dp(graph, targets, edge_counts=edge_counts,
                           preloaded=preloaded)
    raise ValueError(f"unknown planner {planner!r}")


def build_semantic_graphs(
    graph: HetGraph,
    targets: Sequence[str],
    planner: str = "ctt",
    backend: str = "host",
    device="cuda",
) -> SGBResult:
    """One-call SGB stage: plan + execute.  ``planner`` in {naive, ctt,
    ctt_dp}; ``device`` is where ``backend="device"`` composes."""
    plan = make_plan(graph, targets, planner=planner)
    return execute_plan(graph, plan, backend=backend, device=device)
