"""K-hop dependency extraction: the vertex-centric subset executor's frontend.

A target vertex's logits depend only on its ``num_layers``-hop receptive
field over the semantic graphs, so a node-subset request should pay for
that closure, not the whole topology.  ``DependencyExtractor`` walks the
cached per-metapath edge lists *backward* from the requested target ids —
per-type frontier sets, one hop per model layer, host numpy over
``FrontendResult`` products — and builds the induced sub-batch the
executors consume:

* jnp flavor (the segment-sum executor) — closure-local ``(src, dst)``
  edge segments per semantic graph;
* banded flavor — a slice of the cached ``PackedEdges`` stream keeping
  only blocks whose destination tile holds an expandable vertex, with
  band and tile indices re-ranked to the touched subset.  The slice is a
  ``PackedEdges`` of its own (``arrays["graphs"][i]["packed"]``), so K1
  reaches it through ``seg_sum_na`` like any packing (and K2 through
  ``edge_softmax_stats`` for the attention models): its row view and
  work list are built and uploaded once per extraction.

Every array is padded to power-of-two buckets exactly as in the JAX
package, and ``DependencySubset.signature`` is the tuple of every
bucketed shape: two extractions with equal signatures have equally shaped
arrays (the unit a captured forward would be keyed by).

Correctness (why one expandable set suffices): with frontiers
``F_0 ⊆ F_1 ⊆ ... ⊆ F_L`` (``F_0`` = requested ids) the induced batch keeps
every edge into ``F_{L-1}`` and features for all of ``F_L``.  After layer
``i`` every row in ``F_{L-i}`` is exact by induction; rows outside it may
hold garbage, but their values only flow into rows that are themselves not
needed at any later layer.  The one cross-row leak is semantic fusion's
beta (a mean over *all* rows of a type): it is request-independent, so the
executor takes it as an input frozen from one full calibration forward
(``HGNN.fusion_betas``), which keeps subset rows exact to reassociation
tolerance.

After a graph delta, ``migrate_from`` carries the predecessor's memo
entries that are still exact into the successor's extractor.  The banded
flavor carries none once a target metapath was repacked: its entries hold
sliced ``PackedEdges`` (and their uploaded row views) cut from the old
stream.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.edge_softmax import NEG, edge_softmax_stats
from repro_torch.kernels.seg_sum import (PackedEdges, _first_touch_flags,
                                         seg_sum_na)


def _pow2_bucket(n: int, lo: int = 1) -> int:
    """Smallest power of two >= max(n, lo)."""
    n = max(int(n), int(lo))
    return 1 << max(0, n - 1).bit_length()


def _gather_ranges(values: np.ndarray, starts: np.ndarray,
                   ends: np.ndarray) -> np.ndarray:
    """Concatenate ``values[starts[i]:ends[i]]`` for all i — vectorized."""
    counts = (ends - starts).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, values.dtype)
    offs = np.cumsum(counts) - counts
    idx = np.repeat(starts, counts) + (np.arange(total, dtype=np.int64)
                                       - np.repeat(offs, counts))
    return values[idx]


def _locate(sorted_ids: np.ndarray, gids: np.ndarray) -> np.ndarray:
    """Rows of ``gids`` in ``sorted_ids`` (int32); absent ids map to 0.

    Absent ids are legal on the banded path: a sliced block may carry
    edges whose source lies outside the closure, but those edges only
    target non-expandable rows, so reading row 0's (real, finite)
    features for them never contaminates a needed output.
    """
    out = np.zeros(gids.shape[0], np.int32)
    if sorted_ids.size == 0 or gids.size == 0:
        return out
    pos = np.searchsorted(sorted_ids, gids)
    posc = np.clip(pos, 0, sorted_ids.size - 1)
    ok = sorted_ids[posc] == gids
    out[ok] = posc[ok].astype(np.int32)
    return out


def _upload(tree, device):
    """The extraction's numpy arrays as tensors on ``device`` (dtypes kept;
    a sliced ``PackedEdges`` passes through)."""
    if isinstance(tree, dict):
        return {k: _upload(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_upload(v, device) for v in tree]
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree)).to(device)
    return tree


@dataclasses.dataclass
class DependencySubset:
    """One extracted k-hop dependency closure, device-ready.

    ``arrays`` is what the dependency executor takes (per-type feature
    gathers, closure-local edge segments or sliced banded blocks with
    their ``PackedEdges``, and the requested rows), as tensors on the
    extractor's device.  ``signature`` is the tuple of every bucketed
    shape: equal signatures mean identically shaped arrays.
    """

    node_ids: np.ndarray  # sorted unique requested target ids
    hops: Tuple[Dict[str, np.ndarray], ...]  # per-hop per-type frontiers
    closure: Dict[str, np.ndarray]  # == hops[-1]
    buckets: Dict[str, int]  # per-type closure bucket (pow2, >= size+1)
    signature: Tuple  # bucketed-shape tuple; equal => same shapes
    arrays: Dict  # device tensors (and sliced packings) for the executor
    closure_size: int  # total closure vertices across types
    total_size: int  # total graph vertices across types

    @property
    def num_ids(self) -> int:
        """Number of distinct requested ids."""
        return int(self.node_ids.size)

    @property
    def coverage(self) -> float:
        """Closure vertices over graph vertices — the serve-policy
        fallback signal (near 1.0 the closure pays for the whole graph
        and the full forward is the better plan)."""
        return self.closure_size / max(1, self.total_size)


class DependencyExtractor:
    """Host-side k-hop receptive-field extraction over cached frontend
    products, memoized per canonical id set.

    One extractor serves one ``CompiledHGNN`` (one graph fingerprint, one
    executor flavor, one device); the reverse CSR per metapath is built
    once from the semantic relations, and every ``extract`` is numpy over
    it, then one upload to ``device``.  ``extract`` is thread-safe: a
    lookup or build holds the extractor's lock, so two threads asking for
    one id set build (and upload) it once.
    """

    def __init__(self, model, graphs: List, semantic: Dict, *,
                 flavor: str = "jnp", device="cpu", max_memo: int = 128):
        if flavor not in ("jnp", "banded"):
            raise ValueError(f"unknown extractor flavor {flavor!r}")
        self.flavor = flavor
        self.device = torch.device(device)
        self.cfg = model.cfg
        self.num_vertices = dict(model.num_vertices)
        self.feature_dims = dict(model.feature_dims)
        self.types = sorted(self.num_vertices)
        self.graphs = list(graphs)
        self.max_memo = max_memo
        self._lock = threading.Lock()
        self._memo: "OrderedDict[Tuple, DependencySubset]" = OrderedDict()
        # reverse adjacency per metapath: in-neighbors by destination.
        # Relations are (src, dst)-sorted, so re-sort by dst once.
        self._rev: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for g in self.graphs:
            rel = semantic[g.metapath]
            order = np.argsort(rel.dst, kind="stable")
            sorted_dst = rel.dst[order].astype(np.int64)
            indptr = np.searchsorted(sorted_dst, np.arange(rel.num_dst + 1))
            self._rev[g.metapath] = (indptr, rel.src[order].astype(np.int64))
        if flavor == "banded":
            # host copies of the banded permutations (device-resident on
            # the BandedBatch; the extractor slices them per request)
            self._src_gather = {g.metapath: g.src_gather.cpu().numpy() for g in self.graphs}
            self._dst_gather = {g.metapath: g.dst_gather.cpu().numpy() for g in self.graphs}
            self._dst_scatter = {g.metapath: g.dst_scatter.cpu().numpy() for g in self.graphs}

    # ------------------------------------------------------------ frontiers --
    def khop_frontiers(self, ids: np.ndarray,
                       num_hops: Optional[int] = None) -> List[Dict[str, np.ndarray]]:
        """Per-type frontier sets ``F_0 .. F_k`` walking the semantic
        edges backward from ``ids`` (target type).  Monotone by
        construction: ``F_{k+1}[t] ⊇ F_k[t]`` for every type."""
        k = self.cfg.num_layers if num_hops is None else int(num_hops)
        cur = {t: np.zeros(0, np.int64) for t in self.types}
        cur[self.cfg.target_type] = np.unique(np.asarray(ids, np.int64))
        hops = [dict(cur)]
        for _ in range(k):
            acc = {t: [v] for t, v in cur.items()}
            for g in self.graphs:
                d = cur[g.dst_type]
                if d.size == 0:
                    continue
                indptr, srcs = self._rev[g.metapath]
                s = _gather_ranges(srcs, indptr[d], indptr[d + 1])
                if s.size:
                    acc[g.src_type].append(np.unique(s))
            cur = {t: (np.unique(np.concatenate(v)) if len(v) > 1 else v[0])
                   for t, v in acc.items()}
            hops.append(dict(cur))
        return hops

    # ------------------------------------------------------------- extract --
    def extract(self, node_ids, *, bucket_min: int = 8) -> DependencySubset:
        """Extract (or reuse) the dependency closure for an id set.

        Ids are canonicalized to sorted-unique before keying the memo, so
        resubmissions — and permutations or duplicates of the same set —
        return the identical ``DependencySubset`` object, device tensors
        and all.
        """
        ids = np.unique(np.asarray(node_ids, np.int64))
        n_target = self.num_vertices[self.cfg.target_type]
        if ids.size and (ids[0] < 0 or ids[-1] >= n_target):
            raise ValueError(
                f"node id out of bounds for target type "
                f"{self.cfg.target_type!r} (valid range [0, {n_target}))")
        key = (ids.tobytes(), int(bucket_min))
        with self._lock:
            hit = self._memo.get(key)
            if hit is not None:
                self._memo.move_to_end(key)
                return hit
            sub = self._build(ids, bucket_min)
            self._memo[key] = sub
            while len(self._memo) > self.max_memo:
                self._memo.popitem(last=False)
            return sub

    # ----------------------------------------------------- delta migration --
    def migrate_from(self, old: "DependencyExtractor",
                     changed_dst: Dict[str, np.ndarray],
                     touched: frozenset) -> int:
        """Adopt a pre-delta extractor's memo entries that are still exact.

        Frontier expansion only ever reads the in-neighborhoods of closure
        vertices, so an old ``DependencySubset`` is still the exact answer
        iff, for every semantic graph, no changed product edge lands on a
        closure vertex of its destination type (``changed_dst`` maps
        metapath -> destination ids of added/removed product edges; the
        source side is never indexed).  The banded flavor additionally
        drops every entry when any ``touched`` metapath re-packed — its
        sliced packings, row views and uploads were cut from the old
        stream layout.

        ``total_size`` is refreshed on adopted entries (vertex-add deltas
        grow the coverage denominator).  Returns the number of entries
        adopted.
        """
        new_total = sum(self.num_vertices.values())
        banded_stale = self.flavor == "banded" and any(
            g.metapath in touched for g in self.graphs)
        with old._lock:
            entries = [] if banded_stale else list(old._memo.items())
        adopted = 0
        with self._lock:
            for key, sub in entries:
                ok = True
                for g in self.graphs:
                    ch = changed_dst.get(g.metapath)
                    if ch is not None and ch.size and np.intersect1d(
                            sub.closure[g.dst_type], ch).size:
                        ok = False
                        break
                if not ok:
                    continue
                if sub.total_size != new_total:
                    sub = dataclasses.replace(sub, total_size=new_total)
                self._memo[key] = sub
                adopted += 1
            while len(self._memo) > self.max_memo:
                self._memo.popitem(last=False)
        return adopted

    def _build(self, ids: np.ndarray, bucket_min: int) -> DependencySubset:
        hops = self.khop_frontiers(ids)
        closure = hops[-1]
        expandable = hops[-2] if len(hops) >= 2 else hops[-1]
        buckets = {t: _pow2_bucket(closure[t].size + 1, lo=bucket_min)
                   for t in self.types}
        gather = {}
        for t in self.types:
            gt = np.zeros(buckets[t], np.int32)
            gt[: closure[t].size] = closure[t]
            gather[t] = gt
        tt = self.cfg.target_type
        n = ids.size
        id_bucket = max(int(bucket_min), 1 << max(0, n - 1).bit_length())
        node_rows = np.zeros(id_bucket, np.int32)
        node_rows[:n] = np.searchsorted(closure[tt], ids)

        graph_arrays = []
        sig_graphs = []
        for g in self.graphs:
            if self.flavor == "banded":
                dg = self._induce_banded(g, closure, expandable, bucket_min, buckets)
            else:
                dg = self._induce_jnp(g, closure, expandable, bucket_min, buckets)
            sig_graphs.append(tuple(sorted(
                (k, v.shape) for k, v in dg.items() if isinstance(v, np.ndarray))))
            graph_arrays.append(dg)
        signature = (tuple(sorted(buckets.items())), id_bucket, tuple(sig_graphs))
        # upload once: resubmissions reuse the device tensors, and the
        # sliced packings' row views (what K1 reads) go up with them
        arrays = _upload({"gather": gather, "node_rows": node_rows,
                          "graphs": graph_arrays}, self.device)
        for dg in arrays["graphs"]:
            if "packed" in dg:
                dg["packed"].device_blocked(self.device)
        return DependencySubset(
            node_ids=ids,
            hops=tuple(hops),
            closure=closure,
            buckets=buckets,
            signature=signature,
            arrays=arrays,
            closure_size=sum(int(closure[t].size) for t in self.types),
            total_size=sum(self.num_vertices.values()),
        )

    # ------------------------------------------------------- jnp induction --
    def _induce_jnp(self, g, closure, expandable, bucket_min, buckets
                    ) -> Dict[str, np.ndarray]:
        """Closure-local edge segment: every edge into an expandable dst.

        Pad edges point at the per-type pad row (bucket - 1), so the
        segment ops need no masks — pad contributions land on a row
        nothing reads.
        """
        st, dt = g.src_type, g.dst_type
        exp = expandable[dt]
        indptr, srcs = self._rev[g.metapath]
        src_g = _gather_ranges(srcs, indptr[exp], indptr[exp + 1])
        dst_g = np.repeat(exp, (indptr[exp + 1] - indptr[exp]))
        e = src_g.size
        eb = _pow2_bucket(e + 1, lo=8)
        src = np.full(eb, buckets[st] - 1, np.int32)
        dst = np.full(eb, buckets[dt] - 1, np.int32)
        # in-neighbors of expandable dsts are in the closure by construction
        src[:e] = np.searchsorted(closure[st], src_g)
        dst[:e] = np.searchsorted(closure[dt], dst_g)
        return {"src": src, "dst": dst}

    # ---------------------------------------------------- banded induction --
    def _induce_banded(self, g, closure, expandable, bucket_min, buckets) -> Dict:
        """Slice the cached ``PackedEdges`` stream to the touched blocks.

        Selection keeps every block whose destination tile contains an
        expandable vertex, so each destination in a touched tile retains
        its *full* in-neighborhood (all blocks into that tile survive) —
        degrees and softmax stats over the slice are exact for every row
        the executor later picks.  Band and tile indices are re-ranked to
        the touched subset; pad blocks target a dedicated pad tile whose
        first pad block carries the zero-init flag.  The arrays are the
        reference's, bucket for bucket; ``"packed"`` wraps the blocked
        ones as a ``PackedEdges`` (pad blocks count 0 valid slots) whose
        row view K1 reads.
        """
        pk = g.packed
        st, dt = g.src_type, g.dst_type
        td, sb = pk.dst_tile_rows, pk.src_band
        ebk = pk.src_local.shape[1] if pk.num_blocks else pk.edge_block
        exp = expandable[dt]
        if exp.size and pk.num_blocks:
            banded_rows = self._dst_scatter[g.metapath][exp].astype(np.int64)
            # only tiles some block actually targets: a tile holding only
            # zero-in-degree dsts has no block, and its rows' true NA
            # output is 0 anyway (the pick mask below supplies that zero)
            tiles = np.intersect1d(np.unique(banded_rows // td),
                                   pk.dst_tile.astype(np.int64))
            sel = np.flatnonzero(np.isin(pk.dst_tile, tiles))
        else:
            tiles = np.zeros(0, np.int64)
            sel = np.zeros(0, np.int64)
        nb = int(sel.size)
        nbb = _pow2_bucket(nb + 1)  # >= 1 pad block, always
        ntiles = int(tiles.size)
        tb = _pow2_bucket(ntiles + 1)  # tile tb-1 is the pure pad tile
        bands = np.unique(pk.band[sel]) if nb else np.zeros(0, np.int64)
        bb = _pow2_bucket(max(int(bands.size), 1))

        band_r = np.zeros(nbb, np.int32)
        dtile_r = np.full(nbb, tb - 1, np.int32)
        first = np.zeros(nbb, np.int32)
        srcl = np.zeros((nbb, ebk), np.int16)
        dstl = np.zeros((nbb, ebk), np.int16)
        weight = np.zeros((nbb, ebk), np.float32)
        count = np.zeros(nbb, np.int32)
        if nb:
            band_r[:nb] = np.searchsorted(bands, pk.band[sel])
            dtile_r[:nb] = np.searchsorted(tiles, pk.dst_tile[sel])
            first[:nb] = _first_touch_flags(dtile_r[:nb])
            srcl[:nb] = pk.src_local[sel]
            dstl[:nb] = pk.dst_local[sel]
            weight[:nb] = pk.valid_weight()[sel]
            count[:nb] = pk.count[sel]
        if nbb > nb:
            first[nb] = 1  # zero-init the pad tile exactly once

        # flat edge maps over the sliced stream (sliced-layout row ids)
        cnt = count[:nb].astype(np.int64)
        e = int(cnt.sum())
        ebq = _pow2_bucket(e + 1, lo=8)
        e_blk = np.full(ebq, nb, np.int32)  # pads hit the pad block
        e_slot = np.zeros(ebq, np.int32)
        e_src = np.zeros(ebq, np.int32)
        e_dst = np.zeros(ebq, np.int32)
        e_valid = np.zeros(ebq, np.float32)
        if e:
            blk_l = np.repeat(np.arange(nb, dtype=np.int64), cnt)
            offs = np.cumsum(cnt) - cnt
            slot = np.arange(e, dtype=np.int64) - np.repeat(offs, cnt)
            sl_sel = pk.src_local[sel].astype(np.int64)
            dl_sel = pk.dst_local[sel].astype(np.int64)
            e_blk[:e] = blk_l
            e_slot[:e] = slot
            e_src[:e] = band_r[blk_l].astype(np.int64) * sb + sl_sel[blk_l, slot]
            e_dst[:e] = dtile_r[blk_l].astype(np.int64) * td + dl_sel[blk_l, slot]
            e_valid[:e] = 1.0

        # sliced band row -> closure-local src row
        src_rows = np.zeros(bb * sb, np.int32)
        if bands.size:
            gb = (bands[:, None] * sb + np.arange(sb, dtype=np.int64)[None, :]).reshape(-1)
            in_range = gb < pk.num_src
            gids = np.zeros(gb.shape[0], np.int64)
            gids[in_range] = self._src_gather[g.metapath][gb[in_range]]
            loc = _locate(closure[st], gids)
            loc[~in_range] = 0
            src_rows[: bands.size * sb] = loc
        # sliced dst row -> closure-local dst row (logits side)
        dst_rows = np.zeros(tb * td, np.int32)
        if ntiles:
            gr = (tiles[:, None] * td + np.arange(td, dtype=np.int64)[None, :]).reshape(-1)
            in_range = gr < pk.num_dst
            gids = np.zeros(gr.shape[0], np.int64)
            gids[in_range] = self._dst_gather[g.metapath][gr[in_range]]
            loc = _locate(closure[dt], gids)
            loc[~in_range] = 0
            dst_rows[: ntiles * td] = loc
        # closure-local dst row -> sliced dst row (output pick); rows in
        # untouched tiles have zero in-degree here, so their pick is
        # masked to the exact NA output: 0
        dst_pick = np.zeros(buckets[dt], np.int32)
        pick_valid = np.zeros(buckets[dt], np.float32)
        cl = closure[dt]
        if cl.size and ntiles:
            fr = self._dst_scatter[g.metapath][cl].astype(np.int64)
            t = fr // td
            rt = np.searchsorted(tiles, t)
            rtc = np.clip(rt, 0, ntiles - 1)
            ok = tiles[rtc] == t
            dst_pick[: cl.size] = np.where(ok, rtc * td + fr % td, 0)
            pick_valid[: cl.size] = ok
        sliced = PackedEdges(
            srcl, dstl, weight, band_r, dtile_r, first, count,
            num_src=bb * sb, num_dst=tb * td, edge_block=ebk, src_band=sb,
            dst_tile_rows=td)
        return {
            "band": band_r, "dtile": dtile_r, "first": first,
            "srcl": srcl, "dstl": dstl, "weight": weight,
            "e_blk": e_blk, "e_slot": e_slot, "e_src": e_src,
            "e_dst": e_dst, "e_valid": e_valid,
            "src_rows": src_rows, "dst_rows": dst_rows,
            "dst_pick": dst_pick, "pick_valid": pick_valid,
            "packed": sliced,
        }


# ------------------------------------------------------- banded NA compute --
def na_mean_subset_banded(dg: Dict, h_src: torch.Tensor) -> torch.Tensor:
    """RGCN-style NA over one sliced banded graph (closure-local in/out).

    One ``seg_sum_na`` call over the slice's ``PackedEdges``: K1 on a CUDA
    ``h_src`` (counted in ``seg_sum_na.launches``), ``seg_sum_plain`` on a
    CPU one.  Rows no slice block reaches come out 0 (the reference leaves
    them uninitialised; both mask them by ``pick_valid``).  Degrees come
    from the sliced valid-edge map and are exact for every row the pick
    reads.
    """
    pk = dg["packed"]
    hb = h_src[dg["src_rows"]]
    out = seg_sum_na(pk, hb)
    deg = torch.zeros(pk.num_dst, dtype=torch.float32, device=hb.device).index_add_(
        0, dg["e_dst"], dg["e_valid"])
    z = out / torch.clamp(deg, min=1.0)[:, None]
    return z[dg["dst_pick"]] * dg["pick_valid"][:, None]


def na_attention_subset_banded(dg: Dict, h_src: torch.Tensor, h_dst: torch.Tensor,
                               a_src: torch.Tensor, a_dst: torch.Tensor,
                               edge_bias: Optional[torch.Tensor] = None,
                               leaky_slope: float = 0.2) -> torch.Tensor:
    """GAT-style NA over one sliced banded graph, on kernels K2 and K1.

    The logits are computed over the sliced flat edge map and written into
    the blocked layout of the slice's ``PackedEdges``; K2 folds them into
    per-destination ``(m, s)``, alpha is computed in the blocked layout,
    and K1 aggregates with alpha as the block weights.  No float atomics,
    so the rows repeat bit for bit on the card.  Pad edges all alias
    (pad block, slot 0), a slot that no real edge uses and that K2 and
    K1 skip (validity comes from ``count``); every pad writes the same
    value there, so the writes' order does not matter.
    """
    pk = dg["packed"]
    hb = h_src[dg["src_rows"]]
    hd = h_dst[dg["dst_rows"]]
    e_dst = dg["e_dst"].long()
    valid = dg["e_valid"] > 0
    logits = (hb @ a_src)[dg["e_src"]] + (hd @ a_dst)[e_dst]
    if edge_bias is not None:
        logits = logits + edge_bias
    logits = torch.nn.functional.leaky_relu(logits, leaky_slope)
    slots = (dg["e_blk"].long(), dg["e_slot"].long())

    def blocked(flat: torch.Tensor, fill) -> torch.Tensor:
        out = torch.full(dg["srcl"].shape, fill, dtype=flat.dtype, device=flat.device)
        return out.index_put_(slots, torch.where(valid, flat, torch.full_like(flat, fill)))

    lb = blocked(logits, NEG)
    dst_b = blocked(e_dst, 0)
    valid_b = blocked(valid, False)
    m, s = edge_softmax_stats(pk, lb)
    alpha = torch.exp(lb - m[dst_b]) / torch.clamp(s[dst_b], min=1e-9)
    out = seg_sum_na(pk, hb, torch.where(valid_b, alpha, torch.zeros_like(alpha)))
    return out[dg["dst_pick"]] * dg["pick_valid"][:, None]
