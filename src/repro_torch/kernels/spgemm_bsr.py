"""Block-sparse boolean SpGEMM: the SGB composition primitive, kernel K3.

Adjacency is held as a tile-padded dense 0/1 matrix (sides multiples of
``TILE``) plus a flattened int32 tile-occupancy bitmap.  The product
multiplies only the ``(mi, ki) x (ki, ni)`` tile pairs whose occupancy bits
are both set and saturates the sum to 0/1.  Semantic graphs built from
sparse relations leave part of the tile pairs dead, and the pruning stats
(``tile_pairs_live`` against ``tile_pairs_total``) count what that saves.

On a CUDA tensor ``spgemm_bsr`` launches the hand-written Hopper kernel in
``csrc/spgemm_kernels.cu`` (``spgemm_bool_u8``), which replaces the TPU
kernel ``repro/kernels/spgemm_bsr.py::_spgemm_kernel``: one CTA per output
tile loops over ``ki`` (the TPU grid's sequential k axis), skips dead pairs
after two bitmap reads, accumulates 0/1 bytes in int32 (exact) and writes
the saturated tile together with its occupancy bit.  It takes uint8
operands, a quarter of the bytes of the reference's float32.  On a CPU
tensor it runs ``spgemm_plain``: masked tiles, one float32 product, ``> 0``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.cuda_build import check, load_library, ptr

TILE = 128


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def pad_to_tiles(dense, tile: int = TILE):
    """Zero-pad a matrix (numpy array or tensor) to multiples of ``tile``."""
    r, c = dense.shape
    rp, cp = -(-r // tile) * tile, -(-c // tile) * tile
    if isinstance(dense, torch.Tensor):
        out = dense.new_zeros((rp, cp))
    else:
        out = np.zeros((rp, cp), dense.dtype)
    out[:r, :c] = dense
    return out


def tile_occupancy(dense, tile: int = TILE):
    """Flattened ``(rows_t * cols_t,)`` int32 occupancy bitmap of a 0/1
    matrix: numpy in, numpy out; a tensor gives a tensor on its device."""
    r, c = dense.shape
    rt, ct = r // tile, c // tile
    if isinstance(dense, torch.Tensor):
        occ = (dense.reshape(rt, tile, ct, tile) != 0).any(dim=3).any(dim=1)
        return occ.reshape(-1).to(torch.int32)
    occ = dense.reshape(rt, tile, ct, tile).sum(axis=(1, 3)) > 0
    return occ.reshape(-1).astype(np.int32)


# ----------------------------------------------------------------- oracles --
def spgemm_ref(a_dense, b_dense) -> torch.Tensor:
    """Boolean matrix product oracle: ``(A @ B) > 0`` as float 0/1."""
    a, b = _as_tensor(a_dense), _as_tensor(b_dense)
    return (a.to(torch.float32) @ b.to(torch.float32) > 0).to(torch.float32)


def spgemm_macs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``spgemm_macs_ref`` as a 0-d int64 tensor on the operands' device
    (no host sync)."""
    col_a = (a != 0).sum(dim=0, dtype=torch.int64)
    row_b = (b != 0).sum(dim=1, dtype=torch.int64)
    k = min(col_a.shape[0], row_b.shape[0])  # operands may be tile-padded
    return (col_a[:k] * row_b[:k]).sum()


def spgemm_macs_ref(a_dense, b_dense) -> int:
    """Exact join-pair count of the boolean product ``A @ B``.

    For every middle vertex k the join emits ``colsum_A[k] * rowsum_B[k]``
    output pairs (before dedup) — the MAC counter of the host sorted-merge
    join, so the device composer's costs equal the host executor's.
    Padding rows and columns are zero and add nothing.
    """
    return int(spgemm_macs(_as_tensor(a_dense), _as_tensor(b_dense)))


# -------------------------------------------------------------------- plain --
def _tiles(a: torch.Tensor, b: torch.Tensor) -> Tuple[int, int, int]:
    return a.shape[0] // TILE, a.shape[1] // TILE, b.shape[1] // TILE


def spgemm_plain(a: torch.Tensor, b: torch.Tensor, a_occ: torch.Tensor,
                 b_occ: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3; ``(out, out_occ)`` in ``a``'s dtype.

    Zeroes the A tiles whose bit is 0 and the B tiles whose bit is 0, takes
    one float32 product and saturates with ``> 0``: what the kernel
    computes, a stale bitmap included (a pair counts only when both of its
    masked tiles survive).  Sums are at most K < 2**24, so float32 is exact.
    """
    mt, kt, nt = _tiles(a, b)
    am = a.to(torch.float32).reshape(mt, TILE, kt, TILE) * (
        a_occ.reshape(mt, 1, kt, 1) > 0)
    bm = b.to(torch.float32).reshape(kt, TILE, nt, TILE) * (
        b_occ.reshape(kt, 1, nt, 1) > 0)
    prod = am.reshape(mt * TILE, kt * TILE) @ bm.reshape(kt * TILE, nt * TILE)
    out = (prod > 0).to(a.dtype)
    return out, tile_occupancy(out)


# ------------------------------------------------------------------- kernel --
def _check_cuda_operands(a, b, a_occ, b_occ) -> None:
    for name, t in (("a", a), ("b", b), ("a_occ", a_occ), ("b_occ", b_occ)):
        if t.device != a.device:
            raise ValueError(f"spgemm_bsr operands must lie on one device; "
                             f"{name} is on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"spgemm_bsr kernel takes contiguous tensors ({name})")
    if a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise TypeError(f"spgemm_bsr kernel takes uint8 0/1 operands, got "
                        f"{a.dtype}/{b.dtype}")
    if a_occ.dtype != torch.int32 or b_occ.dtype != torch.int32:
        raise TypeError(f"spgemm_bsr kernel takes int32 bitmaps, got "
                        f"{a_occ.dtype}/{b_occ.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"spgemm_bsr needs (M, K) x (K, N), got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if any(s % TILE for s in (*a.shape, b.shape[1])):
        raise ValueError(f"spgemm_bsr sides must be multiples of {TILE}, got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    mt, kt, nt = _tiles(a, b)
    if a_occ.shape != (mt * kt,) or b_occ.shape != (kt * nt,):
        raise ValueError(f"bitmaps must be ({mt * kt},) and ({kt * nt},), got "
                         f"{tuple(a_occ.shape)} and {tuple(b_occ.shape)}")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("spgemm_bsr kernel takes 16-byte aligned operands")


def spgemm_cuda(a: torch.Tensor, b: torch.Tensor, a_occ: torch.Tensor,
                b_occ: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 (``spgemm_bool_u8``) on ``a``'s CUDA device;
    ``(out, out_occ)``, the bitmap written by the kernel itself."""
    _check_cuda_operands(a, b, a_occ, b_occ)
    mt, kt, nt = _tiles(a, b)
    out = torch.empty((mt * TILE, nt * TILE), dtype=torch.uint8, device=a.device)
    out_occ = torch.empty((mt * nt,), dtype=torch.int32, device=a.device)
    if mt == 0 or nt == 0:
        return out, out_occ
    lib = load_library("spgemm_kernels")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.spgemm_bool_u8(
            ptr(a), ptr(b), ptr(a_occ), ptr(b_occ), ptr(out), ptr(out_occ),
            mt, nt, kt, ctypes.c_void_p(stream))
    check(rc, "spgemm_bool_u8")
    spgemm_bsr.launches += 1
    return out, out_occ


def spgemm_bsr(a: torch.Tensor, b: torch.Tensor, a_occ: torch.Tensor,
               b_occ: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Boolean block-sparse product of tile-padded 0/1 matrices;
    ``(out, out_occ)``.

    ``a`` is ``(M, K)``, ``b`` is ``(K, N)``, sides multiples of ``TILE``;
    ``a_occ`` / ``b_occ`` are their ``(Mt*Kt,)`` / ``(Kt*Nt,)`` int32
    bitmaps.  A CUDA ``a`` launches kernel K3 (uint8 operands; counted in
    ``spgemm_bsr.launches``); a CPU ``a`` runs ``spgemm_plain``.
    """
    if a.device.type == "cuda":
        return spgemm_cuda(a, b, a_occ, b_occ)
    if a.device.type != "cpu":
        raise ValueError(f"spgemm_bsr runs on cuda or cpu, got {a.device}")
    return spgemm_plain(a, b, a_occ, b_occ)


spgemm_bsr.launches = 0


# ------------------------------------------------------------- composition --
def pair_stats(a_occ: torch.Tensor, b_occ: torch.Tensor, mt: int, kt: int,
               nt: int) -> dict:
    """Tile-pair pruning counters of one product, from the bitmaps."""
    live = int(((a_occ.reshape(mt, kt, 1) > 0)
                & (b_occ.reshape(1, kt, nt) > 0)).sum())
    return {
        "tile_pairs_total": int(mt * nt * kt),
        "tile_pairs_live": live,
        "macs_dense": int(mt * nt * kt) * TILE ** 3,
        "macs_live": live * TILE ** 3,
    }


def compose_padded_blocked(a, b, a_occ, b_occ
                           ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Compose pre-padded operands; ``(padded result, its occupancy,
    pruning stats)``.

    The device SGB composer's chain primitive: along ``(A@B)@C@...`` every
    intermediate stays tile-padded with its bitmap, so only the chain's
    inputs pay the densify and occupancy-scan cost.  Numpy inputs are taken
    as CPU tensors.
    """
    a, b = _as_tensor(a), _as_tensor(b)
    a_occ, b_occ = _as_tensor(a_occ), _as_tensor(b_occ)
    out, out_occ = spgemm_bsr(a, b, a_occ, b_occ)
    return out, out_occ, pair_stats(a_occ, b_occ, *_tiles(a, b))


def compose_dense_blocked(a_dense, b_dense) -> Tuple[torch.Tensor, dict]:
    """Boolean compose of unpadded 0/1 matrices; ``(result, pruning stats)``."""
    a_dense, b_dense = _as_tensor(a_dense), _as_tensor(b_dense)
    m0, n0 = a_dense.shape[0], b_dense.shape[1]
    a, b = pad_to_tiles(a_dense), pad_to_tiles(b_dense)
    out, _, stats = compose_padded_blocked(a, b, tile_occupancy(a),
                                           tile_occupancy(b))
    stats = {k: stats[k] for k in ("tile_pairs_total", "tile_pairs_live")}
    return out[:m0, :n0], stats
