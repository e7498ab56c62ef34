"""FrontendPipeline: SGB -> Graph Restructurer -> edge-block packing.

1. **SGB** — cache-aware planning (the CTT is pre-seeded with every
   semantic graph already materialized for this topology) and execution on
   the numpy sorted-merge join (``backend="host"``) or on ``device`` with
   the block-sparse SpGEMM kernel K3 (``backend="device"``).
2. **Graph Restructurer** — decouple/recouple once per semantic graph per
   layout knob; permutations are cached and shared by every model.
3. **Packing** — banded ``PackedEdges`` blocks for the NA kernels, built
   with ``pack=True`` or on the first ``banded_batches()`` request.

Everything is keyed by ``HetGraph.fingerprint()`` in a
``SemanticGraphCache``.  ``apply_delta`` updates the products for a
``GraphDelta`` incrementally: cache migration, incremental SGB on the host,
and the block-splice repack.  Every product is bitwise-equal to the JAX
package's ``repro.pipeline`` on the same graph, whichever SGB backend built
it, so cached products serve every backend and device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import tracing
from repro_torch.core.restructure import RestructuredGraph, restructure
from repro_torch.core.sgb import (SGBResult, execute_plan,
                                  execute_plan_delta, make_plan)
from repro_torch.hetero.delta import GraphDelta
from repro_torch.hetero.graph import HetGraph, Relation
from repro_torch.pipeline.cache import (CacheStats, SemanticGraphCache,
                                        default_cache)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Knobs for one frontend engine; hashable so configs can key caches.

    ``renumbered`` selects the banded (renumbered-vertex) layout for the
    ``PackedEdges`` blocks only; model-facing tensors keep global ids.
    ``backend`` is the SGB executor: ``"host"`` or ``"device"``;
    ``device`` is where ``backend="device"`` composes (a CUDA device runs
    kernel K3, ``"cpu"`` its plain version).  Neither enters a cache key:
    products do not depend on them.
    """

    planner: str = "ctt"  # naive | ctt | ctt_cache | ctt_dp
    backend: str = "host"  # SGB executor: host | device
    device: str = "cuda"  # where the device SGB executor runs
    restructure: bool = True
    degree_order: bool = True
    affinity: str = "barycenter"
    renumbered: bool = True
    pack: bool = False

    def __post_init__(self):
        if self.pack and not self.restructure:
            raise ValueError(
                "pack=True requires restructure=True (PackedEdges blocks "
                "are built from the restructured schedule)")


@dataclasses.dataclass
class FrontendResult:
    """Everything the HGNN models need, built once."""

    targets: List[str]
    config: PipelineConfig
    semantic: Dict[str, Relation]  # target metapath -> semantic graph
    restructured: Dict[str, RestructuredGraph]
    packed: Dict[str, object]  # target -> PackedEdges (when config.pack)
    sgb: Optional[SGBResult]  # None when every target came from cache
    timings: Dict[str, float]  # stage wall seconds
    cache_stats: CacheStats  # hits/misses attributable to this run
    _batches: Dict[str, list] = dataclasses.field(default_factory=dict, repr=False)
    _banded: Dict[str, list] = dataclasses.field(default_factory=dict, repr=False)

    @property
    def cold(self) -> bool:
        """Whether this run executed SGB steps."""
        return self.sgb is not None and bool(self.sgb.per_step)

    def batches(self, device) -> list:
        """``SemanticGraphBatch`` list on ``device`` for the segment-sum
        executor (``na_executor="jnp"``) — built once per device, shared by
        every model.

        Delegates to ``package_batches``: global vertex ids, the
        restructurer's schedule when the config restructures, edge-type ids
        in ``sorted(targets)`` order as ``banded_batches``, so one parameter
        dict drives both executors.
        """
        key = str(torch.device(device))
        if key not in self._batches:
            from repro_torch.core.hgnn.models import package_batches

            self._batches[key] = package_batches(
                self.semantic, self.targets,
                restructured=self.config.restructure,
                restructured_graphs=self.restructured, device=device)
        return self._batches[key]

    def banded_batches(self, device) -> list:
        """``BandedBatch`` list on ``device`` for the banded NA executor —
        built once per device, shared by every model.

        Uses the run's cached renumbered ``PackedEdges`` when the config
        packed them; otherwise packs on demand, once per semantic graph,
        and keeps the packing on this result.  Edge-type ids follow
        ``sorted(targets)``.
        """
        key = str(torch.device(device))
        if key not in self._banded:
            if not self.config.restructure:
                raise ValueError(
                    "banded batches need restructure=True (the banded "
                    "layout is the restructurer's renumbered schedule)")
            from repro_torch.core.hgnn.models import BandedBatch

            use_cached = self.config.renumbered
            out = []
            for i, mp in enumerate(sorted(self.targets)):
                rg = self.restructured[mp]
                pk = self.packed.get(mp) if use_cached else None
                if pk is None:
                    pk = rg.packed(renumbered=True)
                    if use_cached:
                        self.packed[mp] = pk
                out.append(BandedBatch.from_restructured(mp, rg, pk, i, device))
            self._banded[key] = out
        return self._banded[key]


@dataclasses.dataclass
class DeltaResult:
    """Products of one incremental frontend update (``apply_delta``)."""

    graph: HetGraph  # the post-delta graph (canonical)
    result: FrontendResult  # frontend products over the new graph
    touched: List[str]  # target metapaths that crossed a touched relation
    migrated: int  # warm cache entries re-keyed old fp -> new fp
    # per touched metapath: (reused_blocks, total_blocks) of the splice
    spliced: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)


class FrontendPipeline:
    """Cached SGB -> Restructure -> packing engine over one cache
    (``default_cache()``, shared process-wide, unless one is given)."""

    def __init__(self, config: Optional[PipelineConfig] = None,
                 cache: Optional[SemanticGraphCache] = None):
        self.config = config or PipelineConfig()
        self.cache = cache if cache is not None else default_cache()

    def _sgb(self, graph: HetGraph, targets: Sequence[str], fp: str
             ) -> Tuple[Dict[str, Relation], Optional[SGBResult]]:
        cfg = self.config
        semantic: Dict[str, Relation] = {}
        missing: List[str] = []
        for t in targets:
            if len(t) == 2 and t in graph.relations:
                semantic[t] = graph.relations[t]
                continue
            hit = self.cache.get_relation(fp, t)
            if hit is not None:
                semantic[t] = hit
            else:
                missing.append(t)
        if not missing:
            return semantic, None

        preloaded = self.cache.relations_for(fp)
        counts = {name: rel.num_edges for name, rel in preloaded.items()}
        plan = make_plan(graph, missing, planner=cfg.planner,
                         preloaded=sorted(preloaded), edge_counts=counts)
        res = execute_plan(graph, plan, backend=cfg.backend, device=cfg.device,
                           preloaded=preloaded)
        for name, rel in res.graphs.items():
            if len(name) > 2:  # one-hop relations live on the HetGraph
                self.cache.put_relation(fp, name, rel)
        for t in missing:
            semantic[t] = res.graphs[t]
        return semantic, res

    def _restructure(self, semantic: Dict[str, Relation], fp: str
                     ) -> Dict[str, RestructuredGraph]:
        cfg = self.config
        out: Dict[str, RestructuredGraph] = {}
        for mp, rel in semantic.items():
            rg = self.cache.get_restructured(fp, mp, cfg.degree_order, cfg.affinity)
            if rg is None:
                rg = restructure(rel, degree_order=cfg.degree_order,
                                 affinity=cfg.affinity, metapath=mp)
                self.cache.put_restructured(fp, mp, cfg.degree_order, cfg.affinity, rg)
            out[mp] = rg
        return out

    def _pack(self, restructured: Dict[str, RestructuredGraph], fp: str
              ) -> Dict[str, object]:
        cfg = self.config
        out: Dict[str, object] = {}
        for mp, rg in restructured.items():
            pk = self.cache.get_packed(
                fp, mp, cfg.degree_order, cfg.affinity, cfg.renumbered)
            if pk is None:
                pk = rg.packed(renumbered=cfg.renumbered)
                self.cache.put_packed(
                    fp, mp, cfg.degree_order, cfg.affinity, cfg.renumbered, pk)
            out[mp] = pk
        return out

    def run(self, graph: HetGraph, targets: Sequence[str]) -> FrontendResult:
        """Full frontend pass for ``targets``; cache-served where possible."""
        for t in targets:
            if not graph.metapath_is_valid(t):
                raise ValueError(
                    f"metapath {t!r} invalid for dataset {graph.name}")
        before = self.cache.stats.snapshot()
        # stage seconds, from the stage spans' own clock reads
        timings: Dict[str, float] = {}
        with tracing.timed("frontend.sgb", timings, "sgb"):
            fp = graph.fingerprint()
            semantic, sgb_res = self._sgb(graph, targets, fp)
        with tracing.timed("frontend.restructure", timings, "restructure"):
            restructured = (
                self._restructure(semantic, fp) if self.config.restructure else {})
        with tracing.timed("frontend.pack", timings, "pack"):
            packed = self._pack(restructured, fp) if self.config.pack else {}
        timings["total"] = sum(timings.values())
        return FrontendResult(
            targets=list(targets),
            config=self.config,
            semantic=semantic,
            restructured=restructured,
            packed=packed,
            sgb=sgb_res,
            timings=timings,
            cache_stats=self.cache.stats.delta(before),
        )

    def apply_delta(self, graph: HetGraph, delta: GraphDelta,
                    targets: Sequence[str]) -> DeltaResult:
        """Incremental frontend update: delta in, warm products out.

        Instead of letting the mutated fingerprint force a cold rebuild,
        the update is bounded to the delta's blast radius:

        1. warm cache entries whose metapath avoids every touched
           relation migrate in place to the new fingerprint
           (``SemanticGraphCache.migrate`` — no recompute, no eviction);
        2. touched semantic graphs recompose incrementally
           (``core.sgb.execute_plan_delta`` — the insert-only union
           identity over the stale cached products; removals fall back to
           a full compose of just the touched products);
        3. touched packings splice the unchanged edge blocks of the stale
           ``PackedEdges`` around a freshly packed edit window
           (``RestructuredGraph.packed_delta``); restructuring itself
           re-runs for touched graphs (it is deterministic host work, so
           the permutations stay bitwise-equal to a cold rebuild).

        Every product is bitwise-equal to ``run(graph.apply_delta(delta),
        targets)`` on a cold cache; only the work differs.
        """
        cfg = self.config
        before = self.cache.stats.snapshot()
        timings: Dict[str, float] = {}
        with tracing.timed("frontend.migrate", timings, "migrate"):
            fp_old = graph.fingerprint()
            new_graph = graph.apply_delta(delta)
            for t in targets:
                if not new_graph.metapath_is_valid(t):
                    raise ValueError(
                        f"metapath {t!r} invalid for dataset {new_graph.name}")
            fp_new = new_graph.fingerprint()
            touched_rel = delta.touched_relations(graph)

            def untouched(mp: str) -> bool:
                return not any(mp[i:i + 2] in touched_rel
                               for i in range(len(mp) - 1))

            moved, stale = ((0, {}) if fp_new == fp_old
                            else self.cache.migrate(fp_old, fp_new, untouched))
            # stale entries are consumed by kind+metapath+knobs; the old
            # fingerprint is lineage bookkeeping, not part of the lookup
            stale = {(k[0],) + k[2:]: v for k, v in stale.items()}
        with tracing.timed("frontend.sgb", timings, "sgb"):
            semantic, sgb_res = self._sgb_delta(
                graph, new_graph, delta, targets, fp_new, stale)
        with tracing.timed("frontend.restructure", timings, "restructure"):
            restructured = (
                self._restructure(semantic, fp_new) if cfg.restructure else {})
        with tracing.timed("frontend.pack", timings, "pack"):
            packed, spliced = (
                self._pack_delta(restructured, fp_new, stale)
                if cfg.pack else ({}, {}))
        timings["total"] = sum(timings.values())
        result = FrontendResult(
            targets=list(targets),
            config=cfg,
            semantic=semantic,
            restructured=restructured,
            packed=packed,
            sgb=sgb_res,
            timings=timings,
            cache_stats=self.cache.stats.delta(before),
        )
        return DeltaResult(
            graph=new_graph,
            result=result,
            touched=[t for t in targets if not untouched(t)],
            migrated=moved,
            spliced=spliced,
        )

    def _sgb_delta(self, old_graph: HetGraph, new_graph: HetGraph,
                   delta: GraphDelta, targets: Sequence[str], fp_new: str,
                   stale: Dict) -> Tuple[Dict[str, Relation],
                                         Optional[SGBResult]]:
        """SGB stage of ``apply_delta``: cache-served where migrated,
        incrementally recomposed where touched."""
        cfg = self.config
        semantic: Dict[str, Relation] = {}
        missing: List[str] = []
        for t in targets:
            if len(t) == 2 and t in new_graph.relations:
                semantic[t] = new_graph.relations[t]
                continue
            hit = self.cache.get_relation(fp_new, t)
            if hit is not None:
                semantic[t] = hit
            else:
                missing.append(t)
        if not missing:
            return semantic, None

        preloaded = self.cache.relations_for(fp_new)
        counts = {name: rel.num_edges for name, rel in preloaded.items()}
        plan = make_plan(new_graph, missing, planner=cfg.planner,
                         preloaded=sorted(preloaded), edge_counts=counts)
        # prior state: the old graph's one-hop relations, the stale
        # (touched) cached products, and the migrated untouched products
        # (unchanged by the delta, so they are their own pre-delta values)
        old_products = dict(old_graph.relations)
        old_products.update(
            {k[1]: v for k, v in stale.items() if k[0] == "rel"})
        old_products.update(preloaded)
        res = execute_plan_delta(
            new_graph, plan,
            old_products=old_products,
            removed_relations=frozenset(delta.remove_edges),
            preloaded=preloaded)
        for name, rel in res.graphs.items():
            if len(name) > 2:
                self.cache.put_relation(fp_new, name, rel)
        for t in missing:
            semantic[t] = res.graphs[t]
        return semantic, res

    def _pack_delta(self, restructured: Dict[str, RestructuredGraph],
                    fp_new: str, stale: Dict
                    ) -> Tuple[Dict[str, object],
                               Dict[str, Tuple[int, int]]]:
        """Pack stage of ``apply_delta``: block splice against the stale
        packing where one exists, full pack otherwise."""
        cfg = self.config
        out: Dict[str, object] = {}
        spliced: Dict[str, Tuple[int, int]] = {}
        for mp, rg in restructured.items():
            pk = self.cache.get_packed(
                fp_new, mp, cfg.degree_order, cfg.affinity, cfg.renumbered)
            if pk is None:
                old_pk = stale.get(("pkd", mp, cfg.degree_order,
                                    cfg.affinity, cfg.renumbered))
                old_rg = stale.get(("rst", mp, cfg.degree_order,
                                    cfg.affinity))
                if old_pk is not None and old_rg is not None:
                    pk, reused, total = rg.packed_delta(
                        old_rg, old_pk, renumbered=cfg.renumbered)
                    spliced[mp] = (reused, total)
                else:
                    pk = rg.packed(renumbered=cfg.renumbered)
                self.cache.put_packed(
                    fp_new, mp, cfg.degree_order, cfg.affinity,
                    cfg.renumbered, pk)
            out[mp] = pk
        return out, spliced

    def run_dataset(self, name: str, targets: Sequence[str], seed: int = 0,
                    scale: float = 1.0) -> FrontendResult:
        """Frontend pass on a synthetic dataset; the HetGraph itself is
        memoized per (dataset, seed, scale), so repeated requests skip
        generation too."""
        return self.run(_dataset(name, seed, scale), targets)


_DATASETS: Dict[Tuple[str, int, float], HetGraph] = {}


def _dataset(name: str, seed: int, scale: float) -> HetGraph:
    key = (name, seed, float(scale))
    if key not in _DATASETS:
        from repro_torch.hetero import make_dataset

        _DATASETS[key] = make_dataset(name, seed=seed, scale=scale)
    return _DATASETS[key]
