"""Semantic-graph cache: frontend products keyed by topology fingerprint.

Everything the frontend produces is a pure function of the topology, so
products are cached under ``(HetGraph.fingerprint(), metapath[, layout
knobs])``: materialized semantic graphs (``Relation``), restructure
results (``RestructuredGraph``, keyed also by the degree_order/affinity
knobs) and ``PackedEdges`` blocks (keyed also by the renumbered flag).
Eviction is LRU by entry count.  A ``PackedEdges`` that has fed the banded
executor also pins its device copies (``PackedEdges.device_blocked``).
After a graph delta, ``migrate`` re-keys the entries the delta cannot
change to the new fingerprint (the same objects, device copies included)
and hands the touched ones back as prior state.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.restructure import RestructuredGraph
from repro_torch.hetero.graph import Relation


@dataclasses.dataclass
class CacheStats:
    """Lookup counters of one cache."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    migrations: int = 0  # entries re-keyed in place by a graph delta

    @property
    def hit_rate(self) -> float:
        """Hits over lookups (0 before the first lookup)."""
        return self.hits / max(1, self.hits + self.misses)

    def snapshot(self) -> "CacheStats":
        """A copy of the counters."""
        return CacheStats(self.hits, self.misses, self.evictions, self.migrations)

    def delta(self, before: "CacheStats") -> "CacheStats":
        """Counters accumulated since ``before``."""
        return CacheStats(
            self.hits - before.hits,
            self.misses - before.misses,
            self.evictions - before.evictions,
            self.migrations - before.migrations,
        )


class SemanticGraphCache:
    """LRU cache of frontend products for reuse across requests/models."""

    def __init__(self, max_entries: Optional[int] = 4096):
        self.max_entries = max_entries
        self._store: "OrderedDict[Tuple, object]" = OrderedDict()
        self.stats = CacheStats()
        # delta lineage: new fingerprint -> the fingerprint its warm
        # entries migrated from (most recent delta only)
        self.lineage: Dict[str, str] = {}

    def _get(self, key: Tuple):
        if key in self._store:
            self.stats.hits += 1
            self._store.move_to_end(key)
            return self._store[key]
        self.stats.misses += 1
        return None

    def _put(self, key: Tuple, value) -> None:
        self._store[key] = value
        self._store.move_to_end(key)
        if self.max_entries is not None:
            while len(self._store) > self.max_entries:
                self._store.popitem(last=False)
                self.stats.evictions += 1

    def __len__(self) -> int:
        return len(self._store)

    def clear(self) -> None:
        """Drop every entry (the counters and lineage stay)."""
        self._store.clear()

    def nbytes(self) -> int:
        """Approximate resident bytes (numpy payloads of cached entries)."""
        total = 0
        for v in self._store.values():
            if isinstance(v, Relation):
                total += v.nbytes
            elif isinstance(v, RestructuredGraph):
                total += v.original.nbytes
                for sg in v.subgraphs:
                    total += sg.src.nbytes + sg.dst.nbytes
                    total += sg.src_ids.nbytes + sg.dst_ids.nbytes
            elif dataclasses.is_dataclass(v):
                for a in vars(v).values():
                    if isinstance(a, np.ndarray):
                        total += a.nbytes
        return total

    def get_relation(self, fp: str, metapath: str) -> Optional[Relation]:
        """Cached semantic graph, or None."""
        return self._get(("rel", fp, metapath))

    def relations_for(self, fp: str) -> Dict[str, Relation]:
        """Every cached semantic graph for one topology (no stats impact) —
        the cache-aware planner's preloaded set."""
        return {k[2]: v for k, v in self._store.items() if k[0] == "rel" and k[1] == fp}

    def put_relation(self, fp: str, metapath: str, rel: Relation) -> None:
        """Store a semantic graph."""
        self._put(("rel", fp, metapath), rel)

    def get_restructured(
        self, fp: str, metapath: str, degree_order: bool, affinity: str
    ) -> Optional[RestructuredGraph]:
        """Cached restructure result, or None."""
        return self._get(("rst", fp, metapath, degree_order, affinity))

    def put_restructured(
        self, fp: str, metapath: str, degree_order: bool, affinity: str, rg: RestructuredGraph
    ) -> None:
        """Store a restructure result."""
        self._put(("rst", fp, metapath, degree_order, affinity), rg)

    def get_packed(
        self, fp: str, metapath: str, degree_order: bool, affinity: str, renumbered: bool
    ):
        """Cached ``PackedEdges``, or None."""
        return self._get(("pkd", fp, metapath, degree_order, affinity, renumbered))

    def put_packed(
        self,
        fp: str,
        metapath: str,
        degree_order: bool,
        affinity: str,
        renumbered: bool,
        packed,
    ) -> None:
        """Store a ``PackedEdges``."""
        self._put(("pkd", fp, metapath, degree_order, affinity, renumbered), packed)

    def migrate(self, fp_old: str, fp_new: str, keep) -> Tuple[int, Dict[Tuple, object]]:
        """Re-key one topology's warm entries after a graph delta.

        Every entry under ``fp_old`` whose metapath satisfies ``keep(mp)``
        (i.e. no hop crosses a touched relation — its products are
        unchanged by the delta) moves in place to ``fp_new``; touched
        entries are *removed* and handed back keyed by their full old key,
        so the delta path can consume them as prior state (old semantic
        graphs seed the incremental composition, old packings seed the
        block splice) instead of letting them rot under a fingerprint
        nobody will ask for again.  Records ``fp_new -> fp_old`` lineage
        and counts migrations; moved entries refresh to most-recently-used
        (a delta is evidence the tenant is live).

        Returns ``(moved_count, stale)`` where ``stale`` maps old cache
        keys of touched entries to their values.
        """
        moved = 0
        stale: Dict[Tuple, object] = {}
        for key in [k for k in self._store if k[1] == fp_old]:
            val = self._store.pop(key)
            if keep(key[2]):
                self._store[(key[0], fp_new) + key[2:]] = val
                moved += 1
            else:
                stale[key] = val
        self.stats.migrations += moved
        if moved or stale:
            self.lineage[fp_new] = fp_old
        return moved, stale


_DEFAULT: Optional[SemanticGraphCache] = None


def default_cache() -> SemanticGraphCache:
    """The process-wide cache shared by pipelines constructed without one."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = SemanticGraphCache()
    return _DEFAULT
