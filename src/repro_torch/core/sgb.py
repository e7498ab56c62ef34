"""Semantic Graph Build (SGB) stage: planners + host executor + cost model.

Planners (copies of the JAX package's ``repro.core.sgb``):

* ``plan_naive``  — every target metapath is built from scratch by
  left-folding one-hop relations (§3.1);
* ``plan_ctt``    — the paper's scheme: the CTT decomposes each target into
  the longest previously-materialized segments;
* ``plan_ctt_dp`` — optimal segmentation by dynamic programming over the
  materialized set, minimizing predicted join work.

``execute_plan`` runs a plan with the numpy sorted-merge join and accounts
exact MACs and bytes.  The device composer (``sgb_backend="device"``, the
block-sparse SpGEMM kernel K3) is not ported yet: ROADMAP item M10.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.ctt import CallbackTrieTree
from repro_torch.hetero.graph import (CompositionCost, HetGraph, Relation,
                                      compose_relations)


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


def execute_plan(
    graph: HetGraph,
    plan: Plan,
    backend: str = "host",
    preloaded: Optional[Dict[str, Relation]] = None,
) -> SGBResult:
    """Run every composition step with the numpy join; count exact MACs/bytes.

    ``preloaded`` supplies already-materialized semantic graphs (from the
    pipeline cache) that a cache-aware plan may use as step inputs.
    ``backend="device"`` (the SpGEMM kernel) is not ported yet.
    """
    if backend == "device":
        raise NotImplementedError(
            "sgb_backend='device' needs the block-sparse SpGEMM kernel (K3), "
            "not ported yet: ROADMAP item M10")
    if backend != "host":
        raise ValueError(f"unknown backend {backend!r}")
    t0 = time.perf_counter()
    total = CompositionCost.zero()
    per_step: List[Tuple[PlanStep, CompositionCost]] = []
    mats: Dict[str, Relation] = dict(graph.relations)
    if preloaded:
        mats.update(preloaded)
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
