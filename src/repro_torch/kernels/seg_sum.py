"""Banded NA aggregation: the packed edge-block format and kernel K1.

The Graph Restructurer makes sparse aggregation banded: after restructuring,
each edge block's sources fall in one ``SRC_BAND``-row band of the feature
matrix and its destinations in one ``DST_TILE``-row output tile.
``pack_edge_blocks`` cuts the scheduled edge stream into such blocks
(host numpy, bitwise-equal to the JAX package's packer;
``splice_pack_edge_blocks`` repacks an edited stream around an old
packing's unchanged blocks), and ``seg_sum_na``
computes, for every block ``b`` in schedule order,

    out[dst_tile[b]*128 + dst_local[b,k]] += w[b,k] * h[band[b]*512 + src_local[b,k]]

over the block's ``count[b]`` valid slots.

On a CUDA tensor ``seg_sum_na`` launches the hand-written Hopper kernel in
``csrc/na_kernels.cu`` (``na_seg_sum_f32``), which replaces the TPU kernel
``repro/kernels/seg_sum.py::_na_kernel``.  The TPU grid runs the blocks in
order and zeroes a tile on its first touch ever; CTAs on an H100 run
concurrently, so the port reads a row-major view of the packing
(``PackedEdges.row_edges``): every destination row's valid slots, in
schedule order, and a work list that balances edges across warps.  A warp
owns a run of whole rows, or one slice of a heavy row whose slices the
warps of one CTA combine in a fixed order.  That needs no atomics, repeats
bit for bit, and writes zeros to rows no edge reaches.  On a CPU tensor it
runs the plain version, ``seg_sum_plain``, which walks the per-tile edge
lists with a one-hot product per tile.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.kernels.cuda_build import check, load_library, ptr

EDGE_BLOCK = 256  # edges per block (EB)
SRC_BAND = 512  # feature rows per band; also the band alignment
DST_TILE = 128  # output rows per tile
ROW_BUDGET = 64  # edges of a light work item; K2 holds them in 2 registers a lane
ROWS_PER_ITEM = 32  # rows of a light work item: one per lane of its warp
ITEMS_PER_CTA = 8  # work items (warps) per CTA of the row kernels


class RowEdges(NamedTuple):
    """Row-major view of a packing, the input of the row kernels K1, K2.

    ``row_src[row_ptr[r]:row_ptr[r + 1]]`` are the global sources of row
    ``r``'s valid in-edges in schedule order, and ``row_slot`` the flat
    ``blk * edge_block + slot`` index of each into the ``(nb, EB)`` blocked
    weight or logit tensor.  ``items`` is the work list, ``(n, 4)`` int32
    rows ``(row, kind, edge_begin, edge_end)`` with ``n`` a multiple of
    ``ITEMS_PER_CTA``; item ``i`` is run by warp ``i % 8`` of CTA ``i // 8``:

    - ``kind > 0``: the ``kind`` whole rows from ``row`` (their edges are
      ``[edge_begin, edge_end)``);
    - ``kind == 0``: idle padding;
    - ``kind < 0``: one slice ``[edge_begin, edge_end)`` of heavy row
      ``row``; the first slice carries ``-k`` for the row's ``k`` slices,
      which follow it in the same CTA, and the others carry ``-1``.
    """

    row_ptr: np.ndarray  # (num_dst + 1,) int32
    row_src: np.ndarray  # (E,) int32
    row_slot: np.ndarray  # (E,) int32
    items: np.ndarray  # (n, 4) int32


def work_list(row_ptr: np.ndarray, budget: int = ROW_BUDGET) -> np.ndarray:
    """Cut ``num_dst`` rows into work items that balance edges.

    A light item is a run of at most ``ROWS_PER_ITEM`` consecutive whole
    rows with at most ``budget`` edges; rows without edges join the runs,
    so every row is written.  A row with more than ``budget`` edges is
    heavy: it splits into ``min(ITEMS_PER_CTA, ceil(deg / budget))``
    slices of near-equal size, placed contiguously in one CTA (the CTA's
    warps combine them).  Heavy groups go first, each CTA's remaining
    slots are filled with light items, and the list is padded with idle
    items to a whole number of CTAs.  Returns ``(n, 4)`` int32 (see
    ``RowEdges``).  The kernels take ``budget <= ROW_BUDGET``; a smaller
    one makes heavy rows at small sizes.
    """
    row_ptr = np.asarray(row_ptr, np.int64)
    n_rows = row_ptr.size - 1
    light: List[Tuple[int, int, int, int]] = []
    heavy: List[List[Tuple[int, int, int, int]]] = []
    r = 0
    while r < n_rows:
        e = int(row_ptr[r])
        deg = int(row_ptr[r + 1]) - e
        if deg > budget:
            k = min(ITEMS_PER_CTA, -(-deg // budget))
            cuts = [e + deg * i // k for i in range(k + 1)]
            heavy.append([(r, -k if i == 0 else -1, cuts[i], cuts[i + 1])
                          for i in range(k)])
            r += 1
            continue
        end = int(np.searchsorted(row_ptr, e + budget, side="right")) - 1
        end = min(end, r + ROWS_PER_ITEM, n_rows)
        light.append((r, end - r, e, int(row_ptr[end])))
        r = end
    items: List[Tuple[int, int, int, int]] = []
    li = 0
    for group in heavy:
        if len(items) % ITEMS_PER_CTA + len(group) > ITEMS_PER_CTA:
            while len(items) % ITEMS_PER_CTA:
                items.append(light[li] if li < len(light) else (0, 0, 0, 0))
                li += 1
        items.extend(group)
    items.extend(light[li:])
    items.extend([(0, 0, 0, 0)] * (-len(items) % ITEMS_PER_CTA))
    return np.asarray(items, np.int32).reshape(-1, 4)


@dataclasses.dataclass
class PackedEdges:
    """Banded edge-block format consumed by the NA kernels (host-built).

    Block arrays are numpy; ``device_blocked(device)`` uploads them once per
    device and caches the copies on the instance.
    """

    src_local: np.ndarray  # (nb, EB) int16: src - band*SRC_BAND (pad: 0)
    dst_local: np.ndarray  # (nb, EB) int16: dst - dst_tile*DST_TILE
    # (nb, EB) float32 edge weights, 0 for padding; None = unweighted (the
    # ones-over-valid-slots mask, built lazily by ``valid_weight()``)
    weight: Optional[np.ndarray]
    band: np.ndarray  # (nb,) int32 band index
    dst_tile: np.ndarray  # (nb,) int32
    first_in_tile: np.ndarray  # (nb,) int32: 1 = first touch EVER of dst tile
    count: np.ndarray  # (nb,) int32 valid edges in block (rest is padding)
    num_src: int
    num_dst: int
    edge_block: int = EDGE_BLOCK
    src_band: int = SRC_BAND
    dst_tile_rows: int = DST_TILE
    # edge p of the flat scheduled stream lives at
    # [edge_block_id[p], edge_slot[p]] of the blocked arrays
    edge_block_id: Optional[np.ndarray] = None  # (E,) int32
    edge_slot: Optional[np.ndarray] = None  # (E,) int32

    @property
    def num_blocks(self) -> int:
        """Number of edge blocks."""
        return int(self.band.shape[0])

    @property
    def num_edges(self) -> int:
        """Number of valid edges (padding excluded)."""
        return int(self.count.sum())

    @property
    def num_dst_tiles(self) -> int:
        """Number of destination tiles covering ``num_dst`` rows (at least 1)."""
        return max(1, -(-self.num_dst // self.dst_tile_rows))

    def hbm_feature_bytes(self, d: int, elem_bytes: int = 4) -> int:
        """Feature bytes of the GFP accounting: one ``(src_band, d)`` tile
        per block.  ``elem_bytes`` defaults to 4 (fp32, what the NA kernels
        gather and accumulate in); pass 2 for bf16 feature tiles."""
        return self.num_blocks * self.src_band * d * elem_bytes

    def edge_map(self) -> Tuple[np.ndarray, np.ndarray]:
        """(edge_block_id, edge_slot) for the flat scheduled stream."""
        if self.edge_block_id is None or self.edge_slot is None:
            cnt = self.count.astype(np.int64)
            blk = np.repeat(np.arange(self.num_blocks, dtype=np.int64), cnt)
            starts = np.concatenate(([0], np.cumsum(cnt)[:-1]))
            slot = np.arange(int(cnt.sum()), dtype=np.int64) - np.repeat(starts, cnt)
            self.edge_block_id = blk.astype(np.int32)
            self.edge_slot = slot.astype(np.int32)
        return self.edge_block_id, self.edge_slot

    def valid_mask(self) -> np.ndarray:
        """(nb, EB) float32: 1 on valid slots, 0 on padding (memoized).

        Count-derived, not the edge weights: a weighted packing may carry
        zero weights on valid slots, and those edges stay valid.
        """
        vm = getattr(self, "_valid_mask", None)
        if vm is None:
            eb = self.src_local.shape[1]
            vm = (
                np.arange(eb, dtype=np.int32)[None, :] < self.count[:, None]
            ).astype(np.float32)
            self._valid_mask = vm
        return vm

    def valid_weight(self) -> np.ndarray:
        """(nb, EB) float32 weights; an unweighted packing resolves to the
        ones-over-valid-slots mask (built lazily, cached)."""
        if self.weight is None:
            self.weight = self.valid_mask()
        return self.weight

    def with_weights(self, flat_weights: np.ndarray) -> "PackedEdges":
        """Same blocking, new per-edge weights given in scheduled order."""
        blk, slot = self.edge_map()
        if flat_weights.shape[0] != blk.shape[0]:
            raise ValueError("one weight per scheduled edge expected")
        nb, eb = self.src_local.shape
        ww = np.zeros((nb, eb), np.float32)
        ww[blk, slot] = np.asarray(flat_weights, np.float32)
        return dataclasses.replace(
            self, weight=ww, edge_block_id=self.edge_block_id,
            edge_slot=self.edge_slot)

    def flat_global_edges(self) -> Tuple[np.ndarray, np.ndarray]:
        """(src, dst) ids of the flat scheduled stream, recovered from the
        blocked layout (memoized)."""
        fe = getattr(self, "_flat_edges", None)
        if fe is None:
            blk, slot = self.edge_map()
            src = (
                self.src_local[blk, slot].astype(np.int64)
                + self.band[blk].astype(np.int64) * self.src_band
            )
            dst = (
                self.dst_local[blk, slot].astype(np.int64)
                + self.dst_tile[blk].astype(np.int64) * self.dst_tile_rows
            )
            fe = (src.astype(np.int32), dst.astype(np.int32))
            self._flat_edges = fe
        return fe

    def tile_blocks(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-destination-tile block lists, the schedule the tile-owner
        kernels walk (memoized).

        Returns ``(tile_ptr, tile_blocks)``: ``tile_ptr`` has shape
        ``(num_dst_tiles + 1,)`` and the blocks of tile ``t`` are
        ``tile_blocks[tile_ptr[t]:tile_ptr[t + 1]]``, in ascending schedule
        order (a stable argsort of ``dst_tile``).
        """
        tb = getattr(self, "_tile_blocks", None)
        if tb is None:
            order = np.argsort(self.dst_tile, kind="stable").astype(np.int32)
            per_tile = np.bincount(self.dst_tile, minlength=self.num_dst_tiles)
            tptr = np.zeros(self.num_dst_tiles + 1, np.int32)
            np.cumsum(per_tile, out=tptr[1:])
            tb = (tptr, order)
            self._tile_blocks = tb
        return tb

    def tile_edges(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Valid slots in tile-walk order, for the plain versions (memoized).

        Returns ``(edge_ptr, blk, slot)``: the valid slots of tile ``t`` are
        ``(blk, slot)[edge_ptr[t]:edge_ptr[t + 1]]``, blocks in the order of
        ``tile_blocks()`` and slots ascending within each block.
        """
        te = getattr(self, "_tile_edges", None)
        if te is None:
            tptr, order = self.tile_blocks()
            cnt = self.count[order].astype(np.int64)
            blk = np.repeat(order.astype(np.int64), cnt)
            starts = np.concatenate(([0], np.cumsum(cnt)[:-1]))
            slot = np.arange(int(cnt.sum()), dtype=np.int64) - np.repeat(starts, cnt)
            block_edge_start = np.concatenate(([0], np.cumsum(cnt)))
            te = (block_edge_start[tptr], blk, slot)
            self._tile_edges = te
        return te

    def row_edges(self) -> RowEdges:
        """Row-major view of the valid slots and its work list (memoized).

        A stable sort of the tile-walk stream (``tile_edges()``) by global
        destination, so each row keeps its edges in schedule order; only
        valid slots appear, so zero-weight edges stay in K2's softmax.
        The work list is ``work_list(row_ptr)``.
        """
        re_ = getattr(self, "_row_edges", None)
        if re_ is None:
            _, blk, slot = self.tile_edges()
            dst = (self.dst_tile[blk].astype(np.int64) * self.dst_tile_rows
                   + self.dst_local[blk, slot])
            if dst.size and int(dst.max()) >= self.num_dst:
                raise ValueError(f"an edge reaches row {int(dst.max())} of "
                                 f"{self.num_dst} destinations")
            order = np.argsort(dst, kind="stable")
            blk, slot = blk[order], slot[order]
            row_ptr = np.zeros(self.num_dst + 1, np.int64)
            np.cumsum(np.bincount(dst, minlength=self.num_dst), out=row_ptr[1:])
            src = (self.band[blk].astype(np.int64) * self.src_band
                   + self.src_local[blk, slot])
            flat = blk * self.edge_block + slot
            if flat.size and int(flat.max()) >= 2 ** 31:
                raise ValueError("the row kernels index at most 2**31 slots")
            re_ = RowEdges(row_ptr.astype(np.int32), src.astype(np.int32),
                           flat.astype(np.int32), work_list(row_ptr))
            self._row_edges = re_
        return re_

    def src_edges(self) -> RowEdges:
        """Source-major view of the valid slots and its work list
        (memoized): the transpose K1 runs in the backward.

        Rows are source ids ``0 .. num_src - 1``; ``row_src`` holds each
        edge's global destination and ``row_slot`` the same flat
        ``blk * edge_block + slot`` index as ``row_edges()``.  A stable sort
        of the flat scheduled stream (``edge_map()``) by source, so each
        source keeps its edges in schedule order.  The work list is
        ``work_list(row_ptr)``.
        """
        se = getattr(self, "_src_edges", None)
        if se is None:
            blk, slot = self.edge_map()
            src, dst = self.flat_global_edges()
            if src.size and int(src.max()) >= self.num_src:
                raise ValueError(f"an edge leaves row {int(src.max())} of "
                                 f"{self.num_src} sources")
            order = np.argsort(src, kind="stable")
            row_ptr = np.zeros(self.num_src + 1, np.int64)
            np.cumsum(np.bincount(src, minlength=self.num_src), out=row_ptr[1:])
            flat = blk.astype(np.int64) * self.edge_block + slot
            if flat.size and int(flat.max()) >= 2 ** 31:
                raise ValueError("the row kernels index at most 2**31 slots")
            se = RowEdges(row_ptr.astype(np.int32), dst[order].astype(np.int32),
                          flat[order].astype(np.int32), work_list(row_ptr))
            self._src_edges = se
        return se

    def device_src_edges(self, device) -> Dict[str, torch.Tensor]:
        """Device copies of ``src_edges()`` (keys ``row_ptr``, ``row_src``,
        ``row_slot``, ``items``; int32), uploaded once per device."""
        device = torch.device(device)
        cache = getattr(self, "_device_src", None)
        if cache is None:
            cache = {}
            self._device_src = cache
        key = str(device)
        ds = cache.get(key)
        if ds is None:
            rows = self.src_edges()
            ds = {name: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
                  for name, a in rows._asdict().items()}
            cache[key] = ds
        return ds

    def device_blocked(self, device) -> Dict[str, torch.Tensor]:
        """Device copies of the arrays the NA kernels and their plain
        versions read, uploaded once per device and cached on the instance.

        Keys: ``row_ptr``, ``row_src``, ``row_slot``, ``items`` (int32, the
        ``row_edges()`` view the kernels read), ``weight`` (the
        ``valid_weight()`` mask, float32), ``edge_blk``, ``edge_slot``,
        ``edge_src``, ``edge_dst`` (int64, the flat scheduled stream) and
        ``tile_blk``, ``tile_slot``, ``tile_src``, ``tile_dst_local``
        (int64, the valid slots in tile-walk order, for the plain versions).
        """
        device = torch.device(device)
        cache = getattr(self, "_device", None)
        if cache is None:
            cache = {}
            self._device = cache
        key = str(device)
        db = cache.get(key)
        if db is None:
            rows = self.row_edges()
            blk, slot = self.edge_map()
            src, dst = self.flat_global_edges()
            _, tblk, tslot = self.tile_edges()
            tsrc = (self.src_local[tblk, tslot].astype(np.int64)
                    + self.band[tblk].astype(np.int64) * self.src_band)

            def up(a, dtype):
                return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

            db = {
                "row_ptr": up(rows.row_ptr, np.int32),
                "row_src": up(rows.row_src, np.int32),
                "row_slot": up(rows.row_slot, np.int32),
                "items": up(rows.items, np.int32),
                "weight": up(self.valid_weight(), np.float32),
                "edge_blk": up(blk, np.int64),
                "edge_slot": up(slot, np.int64),
                "edge_src": up(src, np.int64),
                "edge_dst": up(dst, np.int64),
                "tile_blk": up(tblk, np.int64),
                "tile_slot": up(tslot, np.int64),
                "tile_src": up(tsrc, np.int64),
                "tile_dst_local": up(self.dst_local[tblk, tslot], np.int64),
            }
            cache[key] = db
        return db

    def scatter_blocks(self, flat: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
        """Scatter per-edge values (scheduled order) into the (nb, EB)
        blocked layout on ``flat``'s device; padding slots get ``fill``."""
        nb, eb = self.src_local.shape
        db = self.device_blocked(flat.device)
        out = torch.full((nb, eb), fill, dtype=torch.float32, device=flat.device)
        out.index_put_((db["edge_blk"], db["edge_slot"]), flat.to(torch.float32))
        return out


def _first_touch_flags(dt: np.ndarray) -> np.ndarray:
    """1 for the first block EVER targeting each dst tile, else 0."""
    ft = np.zeros(dt.shape[0], np.int32)
    if dt.shape[0]:
        _, first_idx = np.unique(dt, return_index=True)
        ft[first_idx] = 1
    return ft


def shard_blocked(packed: PackedEdges, block_ids: np.ndarray) -> dict:
    """Host-side slice of a packing's block stream for one shard.

    ``block_ids`` selects blocks (strictly ascending, so the shard keeps
    the schedule's within-tile accumulation order).  ``first`` is
    recomputed over the slice: a shard plan that keeps every block of a
    dst tile on one rank (``repro_torch.distributed.hgnn``) makes
    first-touch-in-shard coincide with first-touch-ever.  The arrays equal
    the JAX package's ``shard_blocked`` bit for bit.
    """
    ids = np.asarray(block_ids, np.int64)
    if ids.size and not (np.diff(ids) > 0).all():
        raise ValueError("block_ids must be strictly ascending (schedule order)")
    dt = packed.dst_tile[ids]
    return {
        "band": packed.band[ids].astype(np.int32),
        "dst_tile": dt.astype(np.int32),
        "first": _first_touch_flags(dt),
        "src_local": packed.src_local[ids],
        "dst_local": packed.dst_local[ids],
        "weight": packed.valid_weight()[ids],
        "count": packed.count[ids].astype(np.int32),
    }


def pack_edge_blocks(
    src: np.ndarray,
    dst: np.ndarray,
    num_src: int,
    num_dst: int,
    weight: Optional[np.ndarray] = None,
    edge_block: int = EDGE_BLOCK,
    src_band: int = SRC_BAND,
    dst_tile: int = DST_TILE,
) -> PackedEdges:
    """Cut the (already scheduled) edge stream into banded blocks.

    A block closes when it reaches ``edge_block`` edges, its destination
    tile changes, or its sources leave the current ``src_band``-aligned
    band.  Vectorized run-boundary arithmetic, bitwise-equal to
    ``pack_edge_blocks_reference`` and to the JAX package's packer.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    n_edges = src.size
    if n_edges == 0:
        z2 = np.zeros((0, edge_block), np.int16)
        return PackedEdges(
            z2, z2.copy(), np.zeros((0, edge_block), np.float32),
            np.zeros(0, np.int32), np.zeros(0, np.int32),
            np.zeros(0, np.int32), np.zeros(0, np.int32), num_src, num_dst,
            edge_block=edge_block, src_band=src_band, dst_tile_rows=dst_tile,
            edge_block_id=np.zeros(0, np.int32), edge_slot=np.zeros(0, np.int32),
        )

    dtile = dst // dst_tile
    band = src // src_band
    # run = maximal stretch of constant (dst tile, band); block = run chunk
    newrun = np.empty(n_edges, bool)
    newrun[0] = True
    np.logical_or(dtile[1:] != dtile[:-1], band[1:] != band[:-1], out=newrun[1:])
    run_starts = np.flatnonzero(newrun)
    run_len = np.diff(np.append(run_starts, n_edges))
    blocks_per_run = -(-run_len // edge_block)
    nb = int(blocks_per_run.sum())
    run_of_blk = np.repeat(np.arange(run_starts.size), blocks_per_run)
    blk_cum = np.concatenate(([0], np.cumsum(blocks_per_run)[:-1]))
    chunk = np.arange(nb) - blk_cum[run_of_blk]
    starts = run_starts[run_of_blk] + chunk * edge_block
    cnt = np.diff(np.append(starts, n_edges)).astype(np.int32)
    blk = np.repeat(np.arange(nb), cnt)
    slot = np.arange(n_edges) - np.repeat(starts, cnt)

    bandv = band[starts].astype(np.int32)
    dt = dtile[starts].astype(np.int32)
    ft = _first_touch_flags(dt)

    sl = np.zeros((nb, edge_block), np.int16)
    dl = np.zeros((nb, edge_block), np.int16)
    sl[blk, slot] = src - band * src_band
    dl[blk, slot] = dst - dtile * dst_tile
    if weight is None:
        ww = None
    else:
        ww = np.zeros((nb, edge_block), np.float32)
        ww[blk, slot] = np.asarray(weight, np.float32)
    return PackedEdges(
        sl, dl, ww, bandv, dt, ft, cnt, num_src, num_dst,
        edge_block=edge_block, src_band=src_band, dst_tile_rows=dst_tile,
        edge_block_id=blk.astype(np.int32), edge_slot=slot.astype(np.int32),
    )


def pack_edge_blocks_reference(
    src: np.ndarray,
    dst: np.ndarray,
    num_src: int,
    num_dst: int,
    weight: Optional[np.ndarray] = None,
    edge_block: int = EDGE_BLOCK,
    src_band: int = SRC_BAND,
    dst_tile: int = DST_TILE,
) -> PackedEdges:
    """The Python-loop packer, kept as the equivalence oracle."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.ones(src.shape, np.float32) if weight is None else np.asarray(weight, np.float32)
    n_edges = src.size
    bounds = []
    i = 0
    while i < n_edges:
        dtile = dst[i] // dst_tile
        band = src[i] // src_band
        j = i
        while (
            j < n_edges
            and j - i < edge_block
            and dst[j] // dst_tile == dtile
            and src[j] // src_band == band
        ):
            j += 1
        bounds.append((i, j, int(band), int(dtile)))
        i = j

    nb = len(bounds)
    sl = np.zeros((nb, edge_block), np.int32)
    dl = np.zeros((nb, edge_block), np.int32)
    ww = np.zeros((nb, edge_block), np.float32)
    bandv = np.zeros((nb,), np.int32)
    dt = np.zeros((nb,), np.int32)
    cnt = np.zeros((nb,), np.int32)
    for k, (a, b, band, tile) in enumerate(bounds):
        n = b - a
        sl[k, :n] = src[a:b] - band * src_band
        dl[k, :n] = dst[a:b] - tile * dst_tile
        ww[k, :n] = w[a:b]
        bandv[k] = band
        dt[k] = tile
        cnt[k] = n
    return PackedEdges(
        sl, dl, ww, bandv, dt, _first_touch_flags(dt), cnt, num_src, num_dst,
        edge_block=edge_block, src_band=src_band, dst_tile_rows=dst_tile,
    )


def splice_pack_edge_blocks(
    src: np.ndarray,
    dst: np.ndarray,
    old_src: np.ndarray,
    old_dst: np.ndarray,
    old: PackedEdges,
    num_src: int,
    num_dst: int,
    edge_block: int = EDGE_BLOCK,
    src_band: int = SRC_BAND,
    dst_tile: int = DST_TILE,
) -> Optional[Tuple[PackedEdges, int, int]]:
    """Repack an edited edge stream by splicing the unchanged blocks of
    an existing packing around a freshly packed edit window.

    ``pack_edge_blocks`` is deterministic on the scheduled stream: blocks
    are ``edge_block`` chunks of maximal constant (dst-tile, band) *runs*,
    with chunk offsets measured from each run's start.  Hence any prefix
    of the stream that (a) is unchanged and (b) ends on a run boundary
    packs into exactly the same block rows, and likewise for a suffix that
    *starts* on a run boundary — only the window between them needs the
    packer.  This function finds the longest common prefix/suffix of the
    old and new streams, snaps the window edges outward to run boundaries
    (a run boundary inside the common region is a boundary of both
    streams, because the flag at position ``i`` only reads positions
    ``i-1`` and ``i``), packs the window, and concatenates.  The result is
    bitwise-equal to ``pack_edge_blocks`` over the full new stream:
    per-block arrays are reused verbatim, while the global products —
    ``first_in_tile`` (first-touch-EVER semantics) and the edge->(block,
    slot) map — are recomputed over the spliced block sequence, which is
    O(nb)/O(E) arithmetic, not a repack.

    Only unweighted packings are spliced (``old`` must have been built
    with ``weight=None``; a lazily materialized ones-mask on it is fine —
    it is ignored and the spliced packing starts lazy again).  Returns
    ``(packed, reused_blocks, total_blocks)``, or ``None`` when the old
    packing is not splice-compatible (different geometry, reference-packer
    dtype, or an empty stream) — callers fall back to a full repack.

    The result is a new ``PackedEdges`` built from new arrays: nothing of
    ``old`` is written (a predecessor still serving reads it), and none of
    its memos (the row and source-major views, their work lists, the valid
    mask, the device copies) carries over, so the row kernels rebuild
    their views from the spliced blocks on first use.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    old_src = np.asarray(old_src, np.int64)
    old_dst = np.asarray(old_dst, np.int64)
    En, Eo = src.size, old_src.size
    if En == 0 or Eo == 0:
        return None
    if (old.edge_block != edge_block or old.src_band != src_band
            or old.dst_tile_rows != dst_tile
            or old.src_local.dtype != np.int16):
        return None

    # longest common prefix / suffix (clamped so they never overlap)
    m = min(En, Eo)
    eq = (src[:m] == old_src[:m]) & (dst[:m] == old_dst[:m])
    p = m if eq.all() else int(np.argmin(eq))
    eqs = (src[En - m:] == old_src[Eo - m:]) & (dst[En - m:] == old_dst[Eo - m:])
    rev = eqs[::-1]
    q = m if rev.all() else int(np.argmin(rev))
    if p + q > m:
        q = m - p

    # run-start flags of the NEW stream; window edges snap to run starts
    # strictly inside the common prefix (index <= p-1) / suffix
    # (index >= En-q+1), where old and new agree on the flag
    dtile = dst // dst_tile
    band = src // src_band
    newrun = np.empty(En, bool)
    newrun[0] = True
    np.logical_or(dtile[1:] != dtile[:-1], band[1:] != band[:-1],
                  out=newrun[1:])
    rs = np.flatnonzero(newrun)
    lo = int(rs[rs <= p - 1].max()) if p > 0 else 0
    hi_cand = rs[rs >= En - q + 1]
    hi = int(hi_cand.min()) if hi_cand.size else En
    hi_o = hi - En + Eo

    cnt_o = old.count.astype(np.int64)
    starts_o = np.concatenate(([0], np.cumsum(cnt_o)[:-1]))
    n_pre = int(np.searchsorted(starts_o, lo))
    n_suf = int(np.searchsorted(starts_o, hi_o))
    # run boundaries are block boundaries; anything else means the old
    # packing did not come from pack_edge_blocks on this stream
    if n_pre < starts_o.size and starts_o[n_pre] != lo:
        return None
    if n_suf < starts_o.size and starts_o[n_suf] != hi_o:
        return None

    mid = pack_edge_blocks(
        src[lo:hi], dst[lo:hi], num_src, num_dst, weight=None,
        edge_block=edge_block, src_band=src_band, dst_tile=dst_tile)

    srcl = np.concatenate(
        [old.src_local[:n_pre], mid.src_local, old.src_local[n_suf:]])
    dstl = np.concatenate(
        [old.dst_local[:n_pre], mid.dst_local, old.dst_local[n_suf:]])
    bandv = np.concatenate([old.band[:n_pre], mid.band, old.band[n_suf:]])
    dt = np.concatenate(
        [old.dst_tile[:n_pre], mid.dst_tile, old.dst_tile[n_suf:]])
    cnt = np.concatenate([old.count[:n_pre], mid.count, old.count[n_suf:]])
    nb = int(cnt.shape[0])
    cnt64 = cnt.astype(np.int64)
    starts = np.concatenate(([0], np.cumsum(cnt64)[:-1]))
    blk = np.repeat(np.arange(nb), cnt64)
    slot = np.arange(En) - np.repeat(starts, cnt64)
    packed = PackedEdges(
        srcl, dstl, None, bandv, dt, _first_touch_flags(dt), cnt,
        num_src, num_dst,
        edge_block=edge_block, src_band=src_band, dst_tile_rows=dst_tile,
        edge_block_id=blk.astype(np.int32), edge_slot=slot.astype(np.int32),
    )
    reused = n_pre + (old.num_blocks - n_suf)
    return packed, reused, nb


# ----------------------------------------------------------- plain versions --
def seg_sum_na_ref(
    src: torch.Tensor,
    dst: torch.Tensor,
    h: torch.Tensor,
    num_dst: int,
    weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Weighted gather + segment-sum over a flat edge list (the NA oracle).

    ``out[d] = sum_{e: dst_e = d} w_e h[src_e]``, written as one dense
    one-hot product: meant for test-sized inputs.
    """
    src = torch.as_tensor(src, device=h.device).long()
    dst = torch.as_tensor(dst, device=h.device).long()
    msg = h[src]
    if weight is not None:
        msg = msg * torch.as_tensor(weight, device=h.device).to(h.dtype)[:, None]
    onehot = (torch.arange(num_dst, device=h.device)[:, None] == dst[None, :]).to(h.dtype)
    return onehot @ msg


def seg_sum_plain(packed: PackedEdges, h: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K1, written independently of the kernel's
    row view.

    For each destination tile, the valid slots of its blocks (in schedule
    order) are gathered and summed into the tile's 128 rows by one one-hot
    product.  Tiles no block touches stay zero.  Returns ``(num_dst, D)``.
    """
    db = packed.device_blocked(h.device)
    w = db["weight"] if weights is None else weights
    td = packed.dst_tile_rows
    edge_ptr, _, _ = packed.tile_edges()
    w_e = w[db["tile_blk"], db["tile_slot"]].to(h.dtype)
    msg_src, dst_local = db["tile_src"], db["tile_dst_local"]
    rows = torch.arange(td, device=h.device)
    out = h.new_zeros((packed.num_dst_tiles * td, h.shape[1]))
    for t in range(packed.num_dst_tiles):
        a, b = int(edge_ptr[t]), int(edge_ptr[t + 1])
        if a == b:
            continue
        onehot = (rows[:, None] == dst_local[None, a:b]).to(h.dtype)
        out[t * td:(t + 1) * td] = onehot @ (h[msg_src[a:b]] * w_e[a:b, None])
    return out[: packed.num_dst]


def seg_sum_transposed_plain(packed: PackedEdges, g: torch.Tensor,
                             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K1 over the source-major view:
    ``out[s] = sum_{e: src_e = s} w_e g[dst_e]`` by ``index_add_`` over the
    flat scheduled stream, the reference's VJP formula
    (``repro/kernels/seg_sum.py::_build_banded_matvec``).  Returns
    ``(num_src, D)``."""
    db = packed.device_blocked(g.device)
    w = db["weight"] if weights is None else weights
    w_e = w[db["edge_blk"], db["edge_slot"]].to(g.dtype)
    out = g.new_zeros((packed.num_src, g.shape[1]))
    return out.index_add_(0, db["edge_src"], w_e[:, None] * g[db["edge_dst"]])


# ------------------------------------------------------------------ kernel --
def _check_cuda_operands(packed: PackedEdges, h: torch.Tensor,
                         w: torch.Tensor, rows: int) -> None:
    """K1's operands: float32, contiguous, one device, ``h`` with at least
    ``rows`` rows (the view's gather range) and ``w`` in the blocked
    layout."""
    if h.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"seg_sum_na kernel takes float32, got {h.dtype}/{w.dtype}")
    if h.dim() != 2 or h.shape[0] < rows:
        raise ValueError(f"h must be (>= {rows}, D), got {tuple(h.shape)}")
    if w.shape != packed.src_local.shape:
        raise ValueError(
            f"weights must be {packed.src_local.shape}, got {tuple(w.shape)}")
    if w.device != h.device:
        raise ValueError("h and weights must lie on one device")
    if not (h.is_contiguous() and w.is_contiguous()):
        raise ValueError("seg_sum_na kernel takes contiguous tensors")


def _launch_k1(view: Dict[str, torch.Tensor], w: torch.Tensor, h: torch.Tensor,
               num_rows: int) -> torch.Tensor:
    """One launch of K1 (``na_seg_sum_f32``) over a row view on ``h``'s
    CUDA device; ``(num_rows, D)``, every row written."""
    d = int(h.shape[1])
    out = torch.empty((num_rows, d), dtype=torch.float32, device=h.device)
    items = view["items"]
    if d == 0 or items.shape[0] == 0:
        return out.zero_()
    lib = load_library("na_kernels")
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.na_seg_sum_f32(
            ptr(items), ptr(view["row_ptr"]), ptr(view["row_src"]),
            ptr(view["row_slot"]), ptr(w), ptr(h), ptr(out),
            int(items.shape[0]), d, ctypes.c_void_p(stream))
    check(rc, "na_seg_sum_f32")
    seg_sum_na.launches += 1
    return out


def seg_sum_cuda(packed: PackedEdges, h: torch.Tensor,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K1 over the destination row view on ``h``'s CUDA device;
    ``(num_dst, D)``."""
    db = packed.device_blocked(h.device)
    w = db["weight"] if weights is None else weights
    _check_cuda_operands(packed, h, w, packed.num_src)
    return _launch_k1(db, w, h, packed.num_dst)


def seg_sum_transposed_cuda(packed: PackedEdges, g: torch.Tensor,
                            weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K1 over the source-major view (``src_edges()``) on ``g``'s
    CUDA device: ``out[s] = sum_{e: src_e = s} w_e g[dst_e]``,
    ``(num_src, D)``.  One owner a source row, no atomics, bitwise
    repeatable."""
    w = packed.device_blocked(g.device)["weight"] if weights is None else weights
    _check_cuda_operands(packed, g, w, packed.num_dst)
    return _launch_k1(packed.device_src_edges(g.device), w, g, packed.num_src)


def _on_device(cuda_fn, plain_fn, packed: PackedEdges, x: torch.Tensor,
               weights: Optional[torch.Tensor]) -> torch.Tensor:
    if x.device.type == "cuda":
        return cuda_fn(packed, x, weights)
    if x.device.type != "cpu":
        raise ValueError(f"seg_sum_na runs on cuda or cpu, got {x.device}")
    return plain_fn(packed, x, weights)


def seg_sum_forward(packed: PackedEdges, h: torch.Tensor,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1 on a CUDA ``h``, ``seg_sum_plain`` on a CPU one; no autograd."""
    return _on_device(seg_sum_cuda, seg_sum_plain, packed, h, weights)


def seg_sum_transposed(packed: PackedEdges, g: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       num_rows: int = 0) -> torch.Tensor:
    """The transpose of :func:`seg_sum_forward`: K1 over the source-major
    view on a CUDA ``g``, ``seg_sum_transposed_plain`` on a CPU one; no
    autograd.  ``(max(num_src, num_rows), D)``: rows past ``num_src`` (a
    forward ``h`` may have more) are zero.  ``g`` is made contiguous here."""
    out = _on_device(seg_sum_transposed_cuda, seg_sum_transposed_plain,
                     packed, g.contiguous(), weights)
    if num_rows > out.shape[0]:
        out = torch.cat([out, out.new_zeros((num_rows - out.shape[0], out.shape[1]))])
    return out


def edge_dots(packed: PackedEdges, h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``h[src_e] . g[dst_e]`` per edge of the flat scheduled stream,
    ``(E,)``: gathers and a row sum, no atomics."""
    db = packed.device_blocked(h.device)
    return (h[db["edge_src"]] * g[db["edge_dst"]]).sum(dim=1)


def needs_grad(*xs: Optional[torch.Tensor]) -> bool:
    """Whether autograd would record an operation on ``xs``."""
    return torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in xs)


class BandedMatvec(torch.autograd.Function):
    """``seg_sum_na`` with the reference's VJP
    (``repro/kernels/seg_sum.py::_build_banded_matvec``), on both devices.

    With ``w_e = w[blk, slot]`` and ``g`` the output cotangent:

        grad_h[s]         = sum_{e: src_e = s} w_e g[dst_e]   (K1, transposed)
        grad_w[blk, slot] = h[src_e] . g[dst_e]               (weight_grad only)

    Padding slots get a zero weight cotangent.
    """

    @staticmethod
    def forward(ctx, packed: PackedEdges, h: torch.Tensor, w: torch.Tensor,
                weight_grad: bool) -> torch.Tensor:
        ctx.packed, ctx.weight_grad = packed, weight_grad
        ctx.save_for_backward(h, w)
        return seg_sum_forward(packed, h, w)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        with tracing.span("hgnn.na.backward", op="matvec"):
            h, w = ctx.saved_tensors
            packed = ctx.packed
            grad_h = grad_w = None
            if ctx.needs_input_grad[1]:
                grad_h = seg_sum_transposed(packed, g, w, num_rows=h.shape[0])
            if ctx.weight_grad and ctx.needs_input_grad[2]:
                db = packed.device_blocked(g.device)
                grad_w = torch.zeros_like(w)
                grad_w[db["edge_blk"], db["edge_slot"]] = edge_dots(packed, h, g)
        return None, grad_h, grad_w, None


def seg_sum_na(
    packed: PackedEdges,
    h: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Weighted banded NA aggregation; returns ``(num_dst, D)``.
    Differentiable in ``h`` and, when given, ``weights`` (``BandedMatvec``).

    ``weights`` optionally overrides the packing's weights with an
    ``(nb, EB)`` blocked tensor on ``h``'s device.  Only the ``count[b]``
    valid slots of a block are read: padding slots carry weight 0 in every
    packing and blocked weight the reference builds, and here they are
    skipped.  A CUDA ``h`` launches kernel K1 (and counts the launch in
    ``seg_sum_na.launches``, as does the transposed launch of the
    backward); a CPU ``h`` runs ``seg_sum_plain``.  A call that needs no
    gradient skips the autograd Function (about 20 us of host time a call
    on the card).
    """
    if h.device.type not in ("cuda", "cpu"):
        raise ValueError(f"seg_sum_na runs on cuda or cpu, got {h.device}")
    weight_grad = weights is not None
    w = packed.device_blocked(h.device)["weight"] if weights is None else weights
    if needs_grad(h, weights):
        return BandedMatvec.apply(packed, h, w, weight_grad)
    return seg_sum_forward(packed, h, w)


seg_sum_na.launches = 0
