"""Sharded HGNN execution over packed edge-block streams, in one process.

The restructured banded layout (``kernels/seg_sum.py``) gives the semantic
graphs a natural shard boundary: every edge block targets exactly one dst
tile, and per-destination state (the softmax statistics, the zeroing of
rows) never crosses a tile.  A :class:`ShardPlan` therefore assigns *whole
dst tiles* of each semantic graph's block stream to the ranks of a mesh:

* ``mode="relation"``: every relation's stream stays whole and relations
  spread over ranks by LPT greedy on edge counts;
* ``mode="edge_block"``: relations whose edge count exceeds the mean
  per-rank load also split along dst-tile boundaries, so one oversized
  relation no longer serializes the mesh.

Plans are host numpy, bitwise equal to the JAX package's
(``repro/distributed/hgnn.py``).

:class:`ShardedHGNNExecutor` runs the banded forward over the plan.  The
JAX package runs one ``shard_map`` over a device mesh and sums the ranks'
outputs with ``psum``; the port keeps its single-controller model in one
process.  A mesh is an ordered list of ranks, each on a ``torch.device``
(``launch/mesh.py``; several ranks may share one device).  Each rank's
blocks, across all relations, form one merged ``PackedEdges`` over a
shared band and tile space (relation ``r``'s bands offset by
``band_offsets[r]``, its tiles by ``tile_offsets[r]``), so per layer a
rank runs one K2 (attention models) and one K1 over its merged stream, on
its own device.  A dst tile lives wholly on one rank, so each rank's
output rows are exact for the tiles it owns and zero elsewhere; the sum
of the ranks' outputs in ascending rank order on the group's lead device
is the port's ``psum``, and adds exact zeros.  FP, SF and the head run
once, on the lead device, with ``HGNN``'s own stage functions.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hgnn.models import HGNN
from repro_torch.kernels.edge_softmax import NEG, edge_softmax_stats
from repro_torch.kernels.seg_sum import (PackedEdges, _first_touch_flags,
                                         seg_sum_na, shard_blocked)
from repro_torch.launch.mesh import Mesh, device_pool, make_mesh_for

SHARD_MODES = ("relation", "edge_block")
_AXIS = "dev"


@dataclasses.dataclass(frozen=True)
class ShardSlice:
    """One relation's edge blocks assigned to one rank.

    ``block_ids`` index the relation's packed stream, strictly ascending
    so the shard preserves the schedule's within-tile accumulation order.
    Every dst tile's blocks land in exactly one slice (the plan invariant
    that keeps per-destination softmax and zeroing local to a rank).
    """

    metapath: str
    device: int
    block_ids: np.ndarray
    num_edges: int


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Assignment of every packed edge block to a rank.

    Built once per (graph fingerprint, targets, mode, rank count, hidden)
    by ``repro_torch.api.Session.compile`` and shared by every model over
    the same products.  ``feature_dim`` scales the MAC estimate in
    :meth:`summary` (one multiply-add per edge per feature).
    """

    mode: str
    num_devices: int
    feature_dim: int
    slices: Tuple[ShardSlice, ...]

    def slices_for(self, device: int) -> List[ShardSlice]:
        """The rank's slices, in deterministic metapath order."""
        return sorted((s for s in self.slices if s.device == device), key=lambda s: s.metapath)

    def device_block_counts(self) -> np.ndarray:
        """(num_devices,) edge blocks assigned per rank."""
        out = np.zeros(self.num_devices, np.int64)
        for s in self.slices:
            out[s.device] += int(s.block_ids.size)
        return out

    def device_edge_counts(self) -> np.ndarray:
        """(num_devices,) edges assigned per rank."""
        out = np.zeros(self.num_devices, np.int64)
        for s in self.slices:
            out[s.device] += s.num_edges
        return out

    def device_mac_counts(self) -> np.ndarray:
        """(num_devices,) NA multiply-adds per rank (edges x features)."""
        return self.device_edge_counts() * int(self.feature_dim)

    def load_balance(self) -> float:
        """Max-over-mean per-rank edge load (1.0 = perfectly balanced): a
        ratio of 2.0 means the busiest rank carries twice the mean load."""
        edges = self.device_edge_counts()
        total = int(edges.sum())
        if total == 0:
            return 1.0
        return float(edges.max() / (total / self.num_devices))

    def summary(self) -> Dict:
        """Per-rank block, edge and MAC counts plus the load-balance ratio.

        Example::

            plan.summary()["load_balance"]  # max/mean rank edge load
        """
        return {
            "mode": self.mode,
            "num_devices": self.num_devices,
            "per_device_edge_blocks": self.device_block_counts().tolist(),
            "per_device_edges": self.device_edge_counts().tolist(),
            "per_device_macs": self.device_mac_counts().tolist(),
            "load_balance": self.load_balance(),
        }


def build_shard_plan(
    graphs: Sequence,
    num_devices: int,
    mode: str,
    feature_dim: int = 64,
) -> ShardPlan:
    """Assign every semantic graph's packed blocks to ``num_devices`` ranks.

    ``graphs`` are ``BandedBatch``es (anything with ``metapath`` and
    ``packed``).  ``mode="relation"`` keeps each relation's stream whole;
    ``mode="edge_block"`` also splits relations whose edge count exceeds
    the mean per-rank load into dst-tile groups.  Atoms (whole relations
    or tile groups) are placed by LPT greedy, heaviest atom onto the
    least-loaded rank, which is deterministic and within 4/3 of the
    optimal makespan.  Both modes keep every dst tile's blocks on one
    rank; every block is assigned exactly once.
    """
    if mode not in SHARD_MODES:
        raise ValueError(f"shard mode {mode!r} not in {SHARD_MODES}")
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    atoms: List[Tuple[int, str, np.ndarray]] = []  # (edges, metapath, ids)
    total_edges = sum(int(g.packed.count.sum()) for g in graphs)
    split_above = total_edges / max(num_devices, 1)
    for g in graphs:
        p = g.packed
        if p.num_blocks == 0:
            continue
        edges = int(p.count.sum())
        ids_all = np.arange(p.num_blocks, dtype=np.int64)
        oversized = edges > split_above and p.num_blocks > 1
        if mode == "edge_block" and num_devices > 1 and oversized:
            tiles, inverse = np.unique(p.dst_tile, return_inverse=True)
            for t in range(tiles.size):
                ids = ids_all[inverse == t]
                atoms.append((int(p.count[ids].sum()), g.metapath, ids))
        else:
            atoms.append((edges, g.metapath, ids_all))
    order = sorted(range(len(atoms)), key=lambda i: (-atoms[i][0], atoms[i][1], i))
    load = np.zeros(num_devices, np.int64)
    assigned: Dict[Tuple[str, int], List[np.ndarray]] = {}
    for i in order:
        edges, metapath, ids = atoms[i]
        dev = int(np.argmin(load))  # ties resolve to the lowest rank
        load[dev] += edges
        assigned.setdefault((metapath, dev), []).append(ids)
    slices = []
    packed_by_mp = {g.metapath: g.packed for g in graphs}
    for (metapath, dev), id_lists in sorted(assigned.items()):
        ids = np.sort(np.concatenate(id_lists))
        num_edges = int(packed_by_mp[metapath].count[ids].sum())
        slices.append(ShardSlice(metapath=metapath, device=dev, block_ids=ids,
                                 num_edges=num_edges))
    return ShardPlan(mode=mode, num_devices=num_devices, feature_dim=int(feature_dim),
                     slices=tuple(slices))


@dataclasses.dataclass(frozen=True)
class _Geometry:
    """The shared band and tile space of every relation (host, static).

    Relation ``r``'s banded src rows live at band ``band_offsets[r]`` (in
    ``src_band`` units) of the merged feature matrix and its dst tiles at
    tile ``tile_offsets[r]`` of the merged output.
    """

    band_offsets: Tuple[int, ...]
    seg_bands: Tuple[int, ...]
    tile_offsets: Tuple[int, ...]
    seg_tiles: Tuple[int, ...]
    total_bands: int
    total_tiles: int
    src_band: int
    dst_tile_rows: int
    edge_block: int


def _build_geometry(graphs: Sequence) -> _Geometry:
    """Lay every relation's bands and tiles out in one shared space."""
    if not graphs:
        raise ValueError("sharded execution needs at least one semantic graph")
    sb = graphs[0].packed.src_band
    td = graphs[0].packed.dst_tile_rows
    eb = graphs[0].packed.edge_block
    band_offsets, seg_bands, tile_offsets, seg_tiles = [], [], [], []
    b_off = t_off = 0
    for g in graphs:
        p = g.packed
        if (p.src_band, p.dst_tile_rows, p.edge_block) != (sb, td, eb):
            raise ValueError("all packings must share the block geometry")
        bands = int(p.band.max()) + 1 if p.num_blocks else 1
        bands = max(bands, -(-p.num_src // sb))
        tiles = max(1, -(-p.num_dst // td))
        band_offsets.append(b_off)
        seg_bands.append(bands)
        tile_offsets.append(t_off)
        seg_tiles.append(tiles)
        b_off += bands
        t_off += tiles
    return _Geometry(
        band_offsets=tuple(band_offsets), seg_bands=tuple(seg_bands),
        tile_offsets=tuple(tile_offsets), seg_tiles=tuple(seg_tiles),
        total_bands=b_off, total_tiles=t_off, src_band=sb, dst_tile_rows=td,
        edge_block=eb)


def merged_stream(graphs: Sequence, plan: ShardPlan, geom: _Geometry,
                  rank: int) -> Tuple[Optional[PackedEdges], np.ndarray]:
    """One rank's blocks, across all relations, as one ``PackedEdges`` over
    the shared space, and the relation index of each block.

    Relation ``r``'s slice (``shard_blocked``) is offset by
    ``band_offsets[r]`` and ``tile_offsets[r]``; ``num_src`` is
    ``total_bands * src_band``, ``num_dst`` is ``total_tiles *
    dst_tile_rows``, and ``first_in_tile`` is recomputed over the merged
    stream.  Every tile's blocks keep their schedule order, so each row's
    edges in the row view (``row_edges()``) are the single-device
    packing's, in the same order.  ``(None, empty)`` for a rank the plan
    gives nothing.
    """
    index = {g.metapath: r for r, g in enumerate(graphs)}
    parts = []
    for s in plan.slices_for(rank):
        r = index[s.metapath]
        blk = shard_blocked(graphs[r].packed, s.block_ids)
        blk["band"] = blk["band"] + geom.band_offsets[r]
        blk["dst_tile"] = blk["dst_tile"] + geom.tile_offsets[r]
        blk["relation"] = np.full(blk["count"].shape, r, np.int64)
        parts.append(blk)
    if not parts:
        return None, np.zeros(0, np.int64)
    cat = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    packed = PackedEdges(
        cat["src_local"], cat["dst_local"], cat["weight"], cat["band"], cat["dst_tile"],
        _first_touch_flags(cat["dst_tile"]), cat["count"],
        num_src=geom.total_bands * geom.src_band,
        num_dst=geom.total_tiles * geom.dst_tile_rows,
        edge_block=geom.edge_block, src_band=geom.src_band,
        dst_tile_rows=geom.dst_tile_rows)
    return packed, cat["relation"]


@dataclasses.dataclass
class _RankStream:
    """A rank's merged stream and what its forward reads on its device:
    the blocked global source and destination ids, the valid-slot mask
    and each block's relation (for the attention logits)."""

    rank: int
    device: torch.device
    packed: PackedEdges
    src_id: torch.Tensor  # (nb, EB) int64
    dst_id: torch.Tensor  # (nb, EB) int64
    valid: torch.Tensor  # (nb, EB) bool
    relation: torch.Tensor  # (nb,) int64


class ShardedHGNNExecutor:
    """The banded forward of one model over a :class:`ShardPlan`, rank by
    rank in one process.

    Holds ``model``, ``graphs``, ``plan`` and the mesh.  Per layer, FP runs
    on the group's lead device (rank 0's); the banded, band-padded feature
    segments (and for rgat and shgn the per-row logit terms) are copied to
    each distinct device of the group; each rank with blocks runs K2 over
    its merged stream (attention models), alpha, then K1, on its device;
    the ranks' outputs are summed in ascending rank order on the lead
    device; then the per-relation degree division (rgcn), the scatter back
    to global order, SF and the head run as in ``HGNN.hidden_states``.
    A CUDA rank launches the kernels, a CPU rank runs their plain
    versions.  Inference only: no autograd through this path.

    ``traces`` counts how often the executor built its per-rank streams
    (and their uploads): 1 after any number of forwards.
    """

    def __init__(self, model: HGNN, graphs: Sequence, plan: ShardPlan, *,
                 devices: Optional[Sequence] = None):
        """Bind ``model`` and its banded batches to ``plan`` over a 1-D mesh
        of ``devices`` (default: ``device_pool`` of the batches' device),
        truncated to the plan's rank count."""
        self.model = model
        self.graphs = list(graphs)
        self.plan = plan
        self.geometry = _build_geometry(self.graphs)
        if devices is None:
            devices = device_pool(self.graphs[0].src_gather.device)
        self.mesh: Mesh = make_mesh_for(list(devices)[: plan.num_devices], (_AXIS,))
        if self.mesh.devices.size != plan.num_devices:
            raise ValueError(f"plan expects {plan.num_devices} devices, mesh has "
                             f"{self.mesh.devices.size}")
        self.ranks: List[torch.device] = self.mesh.ranks
        self.lead = self.ranks[0]
        self._streams: Optional[List[Optional[_RankStream]]] = None
        self._index: Optional[List[Dict[str, torch.Tensor]]] = None
        self._traces = 0
        self._lock = threading.Lock()

    @property
    def traces(self) -> int:
        """How many times the per-rank streams were built (1 once built)."""
        return self._traces

    def streams(self) -> List[Optional[_RankStream]]:
        """Each rank's merged stream on its device (``None`` for a rank the
        plan gives nothing), built and uploaded once."""
        if self._streams is None:
            with self._lock:
                if self._streams is None:
                    self._build()
        return self._streams

    def _build(self) -> None:
        geom = self.geometry
        sb, td = geom.src_band, geom.dst_tile_rows
        streams: List[Optional[_RankStream]] = []
        for rank, dev in enumerate(self.ranks):
            packed, relation = merged_stream(self.graphs, self.plan, geom, rank)
            if packed is None:
                streams.append(None)
                continue
            packed.device_blocked(dev)  # the row view, its work list, uploaded

            def up(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            src_id = packed.band.astype(np.int64)[:, None] * sb + packed.src_local
            dst_id = packed.dst_tile.astype(np.int64)[:, None] * td + packed.dst_local
            streams.append(_RankStream(rank, dev, packed, up(src_id), up(dst_id),
                                       up(packed.valid_mask() > 0), up(relation)))
        self._index = [{k: getattr(g, k).to(self.lead)
                        for k in ("src_gather", "dst_gather", "dst_scatter", "deg")}
                       for g in self.graphs]
        self._streams = streams
        self._traces += 1

    def forward(self, params: Dict, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Logits for every target vertex, on the lead device, under
        ``torch.inference_mode()``.  Equal to ``HGNN.execute(...,
        na_executor="banded")`` on one device (bit for bit where the NA
        kernels' per-row sums are, see the module docstring)."""
        streams = self.streams()
        if params["head"]["w"].device != self.lead:
            params = _tree_to(params, self.lead)
        features = {t: x.to(self.lead) for t, x in features.items()}
        model, graphs, index = self.model, self.graphs, self._index
        with torch.inference_mode():
            h = model.input_states(features, self.lead)
            for lp in params["layers"]:
                hp = model.project(lp, h)
                z_all = self._na_layer(lp, hp, streams)
                h = model.fuse(lp, hp, self._na_outputs(z_all))
            return model.head(params, h)

    # ------------------------------------------------------------ layers --
    def _segments(self, lp: Dict, hp: Dict[str, torch.Tensor]):
        """The merged feature matrix ``h_cat`` (every relation's banded rows,
        padded to its bands) and, for attention, the per-row logit terms
        ``e_s``, ``e_d`` over the shared space and each relation's bias."""
        geom, cfg = self.geometry, self.model.cfg
        sb, td = geom.src_band, geom.dst_tile_rows
        feats, e_src, e_dst, bias = [], [], [], []
        for r, (g, ix) in enumerate(zip(self.graphs, self._index)):
            na_p = lp["na"][g.metapath]
            hb = (hp[g.src_type] @ na_p["w_rel"])[ix["src_gather"]]
            pad = geom.seg_bands[r] * sb - hb.shape[0]
            feats.append(torch.nn.functional.pad(hb, (0, 0, 0, pad)))
            if cfg.model == "rgcn":
                continue
            e_src.append(torch.nn.functional.pad(hb @ na_p["a_src"], (0, pad)))
            e_d = hp[g.dst_type][ix["dst_gather"]] @ na_p["a_dst"]
            e_dst.append(torch.nn.functional.pad(e_d, (0, geom.seg_tiles[r] * td - e_d.shape[0])))
            if cfg.model == "shgn":
                bias.append(lp["edge_emb"][g.edge_type_id] @ lp["a_edge"])
        if cfg.model == "rgcn":
            return (torch.cat(feats),)
        out = (torch.cat(feats), torch.cat(e_src), torch.cat(e_dst))
        return out + ((torch.stack(bias),) if bias else ())

    def _na_layer(self, lp: Dict, hp: Dict[str, torch.Tensor],
                  streams: List[Optional[_RankStream]]) -> torch.Tensor:
        """Every rank's NA over its merged stream, summed in rank order on
        the lead device: ``(total_tiles * dst_tile_rows, D)``.

        K1 (and its plain version) writes zeros to every row no edge of a
        stream reaches, so rows of tiles a rank does not own are already
        exact zeros: the reference's mask of untouched tiles is implied.
        """
        segs = self._segments(lp, hp)
        copies = {self.lead: segs}
        z_all: Optional[torch.Tensor] = None
        for st in streams:  # ascending rank order
            if st is None:
                continue
            if st.device not in copies:
                copies[st.device] = tuple(x.to(st.device) for x in segs)
            out = self._rank_na(st, *copies[st.device]).to(self.lead)
            z_all = out if z_all is None else z_all + out
        if z_all is None:
            geom = self.geometry
            z_all = segs[0].new_zeros((geom.total_tiles * geom.dst_tile_rows,
                                       segs[0].shape[1]))
        return z_all

    def _rank_na(self, st: _RankStream, h_cat: torch.Tensor,
                 e_s: Optional[torch.Tensor] = None, e_d: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One rank's NA: the packing weights (rgcn), or blocked logits, K2's
        ``(m, s)`` over the merged stream and alpha as K1's block weights."""
        pk = st.packed
        if e_s is None:
            return seg_sum_na(pk, h_cat)
        logits = e_s[st.src_id] + e_d[st.dst_id]
        if bias is not None:
            # added after the sum, as the single-device forward adds it
            logits = logits + bias[st.relation][:, None]
        logits = torch.nn.functional.leaky_relu(logits, 0.2)
        logits = torch.where(st.valid, logits, torch.full_like(logits, NEG))
        m, s = edge_softmax_stats(pk, logits)
        alpha = torch.exp(logits - m[st.dst_id]) / torch.clamp(s[st.dst_id], min=1e-9)
        return seg_sum_na(pk, h_cat, torch.where(st.valid, alpha, torch.zeros_like(alpha)))

    def _na_outputs(self, z_all: torch.Tensor) -> Dict[str, List[torch.Tensor]]:
        """Each relation's NA output rows, degree-normalized for rgcn and
        scattered back to global order, grouped by destination type."""
        td = self.geometry.dst_tile_rows
        z_by_dst: Dict[str, List[torch.Tensor]] = {}
        for r, (g, ix) in enumerate(zip(self.graphs, self._index)):
            lo = self.geometry.tile_offsets[r] * td
            zb = z_all[lo: lo + g.num_dst]
            if self.model.cfg.model == "rgcn":
                zb = zb / torch.clamp(ix["deg"], min=1.0)[:, None]
            z_by_dst.setdefault(g.dst_type, []).append(zb[ix["dst_scatter"]])
        return z_by_dst


def _tree_to(tree, device):
    """A nested dict/list of tensors moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)
