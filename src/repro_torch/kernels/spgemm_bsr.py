"""Block-sparse boolean SpGEMM: the SGB composition primitive, kernel K3.

Adjacency is held as a tile-padded dense 0/1 matrix (sides multiples of
``TILE``) plus a flattened int32 tile-occupancy bitmap.  The product
multiplies only the ``(mi, ki) x (ki, ni)`` tile pairs whose occupancy bits
are both set and saturates the sum to 0/1.  Semantic graphs built from
sparse relations leave part of the tile pairs dead, and the pruning stats
(``tile_pairs_live`` against ``tile_pairs_total``) count what that saves.

On a CUDA tensor ``spgemm_bsr`` launches the hand-written Hopper kernels in
``csrc/spgemm_kernels.cu`` (``spgemm_bool_u8``), which replace the TPU
kernel ``repro/kernels/spgemm_bsr.py::_spgemm_kernel``.  A pre-pass writes
the transpose of every live B tile into an ``(N, K)`` scratch allocated
here (the int8 tensor cores read both operands K-major); then one CTA per
output tile walks the list of its live ``ki`` (the TPU grid's sequential k
axis), feeds the tile pairs by TMA to int8 ``wgmma`` with int32
accumulators (exact for 0/1) and writes the saturated tile together with
its occupancy bit.  A product with few output tiles splits each tile's k
range over several CTAs (``split_count``), which OR their partial tiles
into zero-filled outputs.  It takes uint8 operands, a quarter of the bytes
of the reference's float32.  On a CPU tensor it runs ``spgemm_plain``:
masked tiles, one float32 product, ``> 0``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

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


def _check_scratch(b: torch.Tensor, b_occ: torch.Tensor, bt: torch.Tensor) -> None:
    if b.dim() != 2 or any(s % TILE for s in b.shape):
        raise ValueError(f"B must be (K, N) with sides multiples of {TILE}, got "
                         f"{tuple(b.shape)}")
    if b.dtype != torch.uint8 or bt.dtype != torch.uint8:
        raise TypeError(f"the B^T pre-pass takes uint8 B and scratch, got "
                        f"{b.dtype}/{bt.dtype}")
    if b_occ.dtype != torch.int32 or b_occ.shape != (b.numel() // TILE ** 2,):
        raise ValueError(f"b_occ must be int32 ({b.numel() // TILE ** 2},), got "
                         f"{b_occ.dtype} {tuple(b_occ.shape)}")
    if bt.shape != (b.shape[1], b.shape[0]):
        raise ValueError(f"B^T scratch must be {(b.shape[1], b.shape[0])}, got "
                         f"{tuple(bt.shape)}")
    for name, t in (("b_occ", b_occ), ("bt", bt)):
        if t.device != b.device:
            raise ValueError(f"B^T scratch and operands must lie on one device; "
                             f"{name} is on {t.device}, b on {b.device}")
    if not (b.is_contiguous() and b_occ.is_contiguous() and bt.is_contiguous()):
        raise ValueError("the B^T pre-pass takes contiguous tensors")
    if b.data_ptr() % 16 or bt.data_ptr() % 16:
        raise ValueError("the B^T pre-pass takes 16-byte aligned B and scratch")


def transpose_tiles_plain(b: torch.Tensor, b_occ: torch.Tensor,
                          bt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3's pre-pass: tile ``(ni, ki)`` of ``bt``
    gets B's tile ``(ki, ni)`` transposed where its bit is set; the other
    tiles of ``bt`` keep what they held.  Returns ``bt``."""
    kt, nt = b.shape[0] // TILE, b.shape[1] // TILE
    ki, ni = torch.nonzero(b_occ.reshape(kt, nt) > 0, as_tuple=True)
    dst = bt.view(nt, TILE, kt, TILE).permute(0, 2, 1, 3)  # [ni, ki, n, k]
    src = b.view(kt, TILE, nt, TILE).permute(2, 0, 3, 1)   # [ni, ki, n, k]
    dst[ni, ki] = src[ni, ki]
    return bt


def transpose_tiles(b: torch.Tensor, b_occ: torch.Tensor,
                    bt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3's Bᵀ pre-pass alone, into ``bt`` (``(N, K)`` uint8; allocated
    uninitialised when ``None``): the transpose of every B tile whose bit
    is set, other tiles left as they were.  ``spgemm_bsr`` runs it itself;
    this entry serves its tests and timings.  A CUDA ``b`` launches the
    pre-pass kernel, a CPU ``b`` runs ``transpose_tiles_plain``."""
    if bt is None:
        bt = torch.empty((b.shape[1], b.shape[0]), dtype=b.dtype, device=b.device)
    _check_scratch(b, b_occ, bt)
    if b.device.type == "cpu":
        return transpose_tiles_plain(b, b_occ, bt)
    if b.device.type != "cuda":
        raise ValueError(f"transpose_tiles runs on cuda or cpu, got {b.device}")
    kt, nt = b.shape[0] // TILE, b.shape[1] // TILE
    if kt == 0 or nt == 0:
        return bt
    lib = load_library("spgemm_kernels")
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        rc = lib.spgemm_transpose_u8(ptr(b), ptr(b_occ), ptr(bt), kt, nt,
                                     ctypes.c_void_p(stream))
    check(rc, "spgemm_transpose_u8")
    return bt


def split_count(mt: int, nt: int, kt: int) -> int:
    """How many slices K3 cuts each output tile's k range into for a
    product of ``mt x nt`` output tiles over ``kt`` k tiles, as the loaded
    kernel decides it from the shapes alone (``csrc/spgemm_kernels.cu``)."""
    return int(load_library("spgemm_kernels").spgemm_split_count(mt, nt, kt))


def kernel_info() -> dict:
    """What K3's loaded main kernel takes per CTA, as the CUDA runtime
    reports it: registers a thread, dynamic shared memory bytes, local
    (stack and spill) bytes a thread, threads, ring stages and the CTAs
    an SM holds."""
    info = (ctypes.c_int * 6)()
    check(load_library("spgemm_kernels").spgemm_info(info), "spgemm_info")
    return {"registers": info[0], "shared_bytes": info[1], "local_bytes": info[2],
            "threads": info[3], "stages": info[4], "ctas_per_sm": info[5]}


def spgemm_cuda(a: torch.Tensor, b: torch.Tensor, a_occ: torch.Tensor,
                b_occ: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 (``spgemm_bool_u8``: the Bᵀ pre-pass, then the product) on
    ``a``'s CUDA device; ``(out, out_occ)``, the bitmap written by the
    kernel itself."""
    _check_cuda_operands(a, b, a_occ, b_occ)
    mt, kt, nt = _tiles(a, b)
    if mt == 0 or nt == 0 or kt == 0:  # nothing to multiply: all zeros
        return (torch.zeros((mt * TILE, nt * TILE), dtype=torch.uint8, device=a.device),
                torch.zeros((mt * nt,), dtype=torch.int32, device=a.device))
    lib = load_library("spgemm_kernels")
    splits = split_count(mt, nt, kt)
    # split k ORs partial tiles into zeros; one split stores every byte
    alloc = torch.zeros if splits > 1 else torch.empty
    out = alloc((mt * TILE, nt * TILE), dtype=torch.uint8, device=a.device)
    out_occ = alloc((mt * nt,), dtype=torch.int32, device=a.device)
    bt = torch.empty((nt * TILE, kt * TILE), dtype=torch.uint8, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.spgemm_bool_u8(
            ptr(a), ptr(b), ptr(a_occ), ptr(b_occ), ptr(bt), ptr(out), ptr(out_occ),
            mt, nt, kt, splits, ctypes.c_void_p(stream))
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
