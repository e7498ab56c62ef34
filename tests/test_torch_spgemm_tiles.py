"""K3's work split on the CPU: a numpy mirror of what
``csrc/spgemm_kernels.cu`` does, CTA by CTA, against the plain version and
the JAX kernel (interpret mode).

The kernel first writes the transpose of every live B tile into a scratch
(4 x 4 byte blocks through ``__byte_perm``; tiles whose bit is clear keep
whatever the scratch held).  Then each CTA takes one output tile, in
groups of tile rows, and one slice of its k range where the product has
few output tiles; a producer warp tests the slice 32 ki at a time
(ballot), compacts the live ki in order into a list, and the consumers
accumulate ``A tile @ Bᵀ tileᵀ`` in int32, 32 bytes of k a step.  The tile
is saturated to 0/1 and stored, or, with split k, ORed into a zero-filled
output by 32-bit words.  The mirror repeats each of those steps, with the
tile size, ring depth, ballot width, raster group, split rule and byte
selectors read from the CUDA source, so a change to any of them shows here
before it reaches a card.  The scratch starts as garbage and the output
of an unsplit product too: a dead tile read, or a byte not written, shows.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# PyTorch's CPU build can get the first vectorized float op of a fresh
# process wrong (see test_torch_lm_kernels.py): a throwaway call first
torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))

import jax.numpy as jnp  # noqa: E402

from repro.kernels import spgemm_bsr as ref_spgemm  # noqa: E402
from repro_torch.kernels import spgemm_bsr as port  # noqa: E402

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
      / "spgemm_kernels.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


TILE = _const("kTile")
STAGES = _const("kStages")
K_STEP = _const("kKStep")
CHUNK = _const("kChunk")
GROUP_M = _const("kGroupM")
SPLIT_CTAS = _const("kSplitCtas")
MIN_SPLIT_K = _const("kMinSplitK")
OUT_PITCH = _const("kOutPitch")
# the six selectors of transpose4, in source order
SELECTORS = [int(s, 16) for s in re.findall(r"__byte_perm\([^;]*?, (0x[0-9a-fA-F]+)\);",
                                            CU[CU.index("void transpose4("):])][:6]
SMEM_PER_SM = 228 * 1024  # an H100 SM's shared memory
SMEM_RESERVED = 1024  # the runtime's reservation a CTA
GARBAGE = 0xAB

# (Mt, Kt, Nt) of the 13 SGB steps at scale 1.0 under the ctt planner:
# ACM (APA, PAP, PSP), IMDB (AMA, MAM, MKM), DBLP (APA, APT, APTP, APTPA,
# APV, APVP, APVPA); test_sgb_step_shapes_are_the_plans checks them
SGB_STEPS = [
    (47, 24, 47), (24, 47, 24), (24, 1, 24),
    (48, 39, 48), (39, 48, 39), (39, 63, 39),
    (32, 112, 32), (32, 112, 61), (32, 61, 112), (32, 112, 32),
    (32, 112, 1), (32, 1, 112), (32, 112, 32),
]
SGB_WORKLOADS = {"ACM": ["APA", "PAP", "PSP"], "IMDB": ["MAM", "AMA", "MKM"],
                 "DBLP": ["APA", "APTPA", "APVPA"]}


def split_count(mt: int, nt: int, kt: int) -> int:
    """The kernel's split rule (``split_count`` in the source)."""
    tiles = mt * nt
    if tiles <= 0 or tiles >= SPLIT_CTAS:
        return 1
    return max(1, min(-(-SPLIT_CTAS // tiles), kt // MIN_SPLIT_K))


def tile_of(cta: int, mt: int, nt: int):
    """The output tile of CTA ``cta`` (``tile_of`` in the source)."""
    per_group = GROUP_M * nt
    group = cta // per_group
    first = group * GROUP_M
    rows = min(mt - first, GROUP_M)
    r = cta - group * per_group
    return first + r % rows, r // rows


def byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's ``__byte_perm`` on uint32 arrays."""
    pool = [(x >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    pool += [(y >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= pool[(sel >> (4 * n)) & 7] << np.uint32(8 * n)
    return out


def transpose_pre_pass(b: np.ndarray, b_occ: np.ndarray) -> np.ndarray:
    """The Bᵀ scratch as the pre-pass leaves it: garbage, and the live
    tiles transposed in 4 x 4 byte blocks by the source's selectors."""
    kdim, ndim = b.shape
    kt, nt = kdim // TILE, ndim // TILE
    bt = np.full((ndim, kdim), GARBAGE, np.uint8)
    s0, s1, s2, s3, s4, s5 = SELECTORS
    for ki, ni in zip(*np.nonzero(b_occ.reshape(kt, nt) > 0)):
        tile = np.ascontiguousarray(b[ki * TILE:(ki + 1) * TILE, ni * TILE:(ni + 1) * TILE])
        words = tile.view(np.uint32).reshape(TILE // 4, 4, TILE // 4)  # [br, r, bc]
        x = [words[:, r, :] for r in range(4)]
        lo01, hi01 = byte_perm(x[0], x[1], s0), byte_perm(x[0], x[1], s1)
        lo23, hi23 = byte_perm(x[2], x[3], s2), byte_perm(x[2], x[3], s3)
        y = [byte_perm(lo01, lo23, s4), byte_perm(lo01, lo23, s5),
             byte_perm(hi01, hi23, s4), byte_perm(hi01, hi23, s5)]
        out = np.empty((TILE // 4, 4, TILE // 4), np.uint32)  # [bc, c, br]
        for c in range(4):
            out[:, c, :] = y[c].T
        bt[ni * TILE:(ni + 1) * TILE, ki * TILE:(ki + 1) * TILE] = \
            out.reshape(TILE, TILE // 4).view(np.uint8).reshape(TILE, TILE)
    return bt


def live_list(a_occ, b_occ, mi, ni, k_lo, k_hi, kt, nt):
    """The producer warp's list: ballots of CHUNK ki, compacted in order."""
    out = []
    for k0 in range(k_lo, k_hi, CHUNK):
        lanes = np.arange(k0, min(k0 + CHUNK, k_hi))
        live = (a_occ[mi * kt + lanes] > 0) & (b_occ[lanes * nt + ni] > 0)
        mask = int(np.sum(live.astype(np.int64) << np.arange(len(lanes), dtype=np.int64)))
        chunk = [0] * bin(mask).count("1")
        for lane, k in enumerate(lanes):
            if mask >> lane & 1:
                chunk[bin(mask & ((1 << lane) - 1)).count("1")] = int(k)
        out += chunk
    return out


def emulate(a, b, a_occ, b_occ):
    """K3 CTA by CTA: ``(out, out_occ, stats)``."""
    mt, kt, nt = a.shape[0] // TILE, a.shape[1] // TILE, b.shape[1] // TILE
    splits = split_count(mt, nt, kt)
    bt = transpose_pre_pass(b, b_occ)
    if splits == 1:
        out = np.full((mt * TILE, nt * TILE), GARBAGE, np.uint8)
        occ = np.full(mt * nt, -1, np.int32)
    else:
        out = np.zeros((mt * TILE, nt * TILE), np.uint8)
        occ = np.zeros(mt * nt, np.int32)
    words = out.view(np.uint32)
    seen = np.zeros((mt, nt, splits), np.int32)
    loads = 0
    for cta in range(mt * nt):
        mi, ni = tile_of(cta, mt, nt)
        for split in range(splits):
            seen[mi, ni, split] += 1
            k_lo, k_hi = kt * split // splits, kt * (split + 1) // splits
            count = int(np.sum((a_occ[mi * kt + np.arange(k_lo, k_hi)] > 0)
                               & (b_occ[np.arange(k_lo, k_hi) * nt + ni] > 0)))
            ks = live_list(a_occ, b_occ, mi, ni, k_lo, k_hi, kt, nt)
            assert len(ks) == count  # the consumers' loop count
            acc = np.zeros((TILE, TILE), np.int32)
            for ki in ks:
                a_t = a[mi * TILE:(mi + 1) * TILE, ki * TILE:(ki + 1) * TILE].astype(np.int32)
                bt_t = bt[ni * TILE:(ni + 1) * TILE, ki * TILE:(ki + 1) * TILE].astype(np.int32)
                for k in range(0, TILE, K_STEP):
                    acc += a_t[:, k:k + K_STEP] @ bt_t[:, k:k + K_STEP].T
                loads += 1
            bits = (acc > 0).astype(np.uint8)
            rows, cols = slice(mi * TILE, (mi + 1) * TILE), slice(ni * TILE, (ni + 1) * TILE)
            if splits == 1:
                out[rows, cols] = bits
                occ[mi * nt + ni] = int(bits.any())
            else:
                part = np.ascontiguousarray(bits).view(np.uint32)
                wcols = slice(ni * TILE // 4, (ni + 1) * TILE // 4)
                nz = part != 0  # zero words are skipped
                words[rows, wcols][nz] |= part[nz]
                if bits.any():
                    occ[mi * nt + ni] |= 1
    assert (seen == 1).all()  # every (tile, slice) once
    return out, occ, {"splits": splits, "loads": loads}


def plain(a, b, a_occ, b_occ):
    out, occ = port.spgemm_plain(torch.from_numpy(a), torch.from_numpy(b),
                                 torch.from_numpy(a_occ), torch.from_numpy(b_occ))
    return out.numpy(), occ.numpy()


def jax_kernel(a, b, a_occ, b_occ):
    return np.asarray(ref_spgemm.spgemm_bsr(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(a_occ), jnp.asarray(b_occ),
        interpret=True))


def _operands(rng, mt, kt, nt, density):
    a = (rng.random((mt * TILE, kt * TILE)) < density).astype(np.uint8)
    b = (rng.random((kt * TILE, nt * TILE)) < density).astype(np.uint8)
    return a, b, port.tile_occupancy(a), port.tile_occupancy(b)


def _check(a, b, a_occ, b_occ, against_jax=True):
    out, occ, stats = emulate(a, b, a_occ, b_occ)
    want, want_occ = plain(a, b, a_occ, b_occ)
    assert out.dtype == want.dtype and np.array_equal(out, want)
    assert np.array_equal(occ, want_occ)
    if against_jax:
        assert np.array_equal(out, jax_kernel(a, b, a_occ, b_occ).astype(np.uint8))
    return out, stats


def test_constants_read_from_the_source_are_the_design():
    assert TILE == port.TILE == ref_spgemm.TILE
    assert "m64n128k32.s32.u8.u8" in CU and "__dp4a" not in CU
    assert TILE % K_STEP == 0 and CHUNK == 32 and len(SELECTORS) == 6
    # two CTAs an SM: the ring, barriers, list and alignment slack
    smem = int(re.search(r"kSmemBytes = kAnyOffset \+ (\d+) \+ (\d+);", CU).group(1)) + 1024
    smem += STAGES * 2 * TILE * TILE + 16 * STAGES + 4 * CHUNK
    assert 2 * (smem + SMEM_RESERVED) <= SMEM_PER_SM
    assert TILE * OUT_PITCH <= 2 * TILE * TILE and OUT_PITCH % 16 == 0


@pytest.mark.parametrize("mt,nt", [(1, 1), (3, 5), (8, 7), (9, 3), (17, 4), (32, 112)])
def test_raster_covers_every_tile_once(mt, nt):
    tiles = [tile_of(c, mt, nt) for c in range(mt * nt)]
    assert sorted(tiles) == [(m, n) for m in range(mt) for n in range(nt)]
    # the CTAs of one group take at most GROUP_M tile rows
    assert len({m for m, _ in tiles[:GROUP_M * nt]}) == min(mt, GROUP_M)


def test_split_rule():
    assert [split_count(*s[::2], s[1]) for s in SGB_STEPS].count(1) == 12
    assert split_count(32, 1, 112) == 9  # DBLP's AP x PV: 32 output tiles
    assert split_count(1, 1, 112) == 14 and split_count(2, 1, 40) == 5
    assert split_count(1, 1, 1) == 1 and split_count(1, 1, 7) == 1
    for mt, nt, kt in [(1, 1, 1000), (3, 2, 70), (16, 16, 8), (1, 263, 64)]:
        s = split_count(mt, nt, kt)
        assert 1 <= s <= max(1, kt // MIN_SPLIT_K)
        assert mt * nt * s < SPLIT_CTAS + mt * nt


def test_pre_pass_matches_the_wrapper_plain_version():
    rng = np.random.default_rng(4)
    b = (rng.random((3 * TILE, 5 * TILE)) < 0.2).astype(np.uint8)
    b_occ = port.tile_occupancy(b)
    b_occ[7] = 0  # a live tile read as dead: left as garbage
    bt = transpose_pre_pass(b, b_occ)
    ref = port.transpose_tiles(torch.from_numpy(b), torch.from_numpy(b_occ),
                               torch.full(bt.shape, GARBAGE, dtype=torch.uint8))
    assert np.array_equal(bt, ref.numpy())
    assert int((bt == GARBAGE).sum()) == TILE * TILE


@pytest.mark.parametrize("mt,kt,nt,density", [
    (1, 1, 1, 0.02), (2, 3, 4, 0.01), (5, 7, 3, 0.3), (3, 2, 1, 0.0),
    (1, 40, 1, 0.01),   # split k, and a k range past one ballot
    (2, 70, 3, 0.003),  # split k over three ballots
    (3, 33, 2, 0.005),
])
def test_random_products_match_plain_and_jax(mt, kt, nt, density):
    rng = np.random.default_rng(mt * 1000 + kt * 10 + nt)
    _check(*_operands(rng, mt, kt, nt, density))


def test_stale_and_dead_bitmaps():
    rng = np.random.default_rng(7)
    a, b, ao, bo = _operands(rng, 2, 40, 1, 0.01)  # split k: 5 slices
    fresh, _ = _check(a, b, ao, bo)
    stale_a, stale_b = ao.copy(), bo.copy()
    stale_a[10] = 0  # inside the second slice of row 0
    stale_b[33] = 0  # inside the last slice
    out, stats = _check(a, b, stale_a, stale_b)
    assert stats["splits"] > 1 and not np.array_equal(out, fresh)
    # every pair dead: zeros and an empty bitmap, whatever the tiles hold
    for dead_a, dead_b in ((np.zeros_like(ao), bo), (ao, np.zeros_like(bo))):
        out, occ, stats = emulate(a, b, dead_a, dead_b)
        assert not out.any() and not occ.any() and stats["loads"] == 0
        assert np.array_equal(out, jax_kernel(a, b, dead_a, dead_b).astype(np.uint8))
    # one split, a stale bit and dead tiles left as garbage in the scratch
    a, b, ao, bo = _operands(rng, 4, 5, 6, 0.02)
    ao[3] = 0
    bo[[0, 7]] = 0
    _check(a, b, ao, bo)


def _sparse_step(rng, mt, kt, nt):
    """Operands of an SGB step's tile shape with a few live tiles: three
    tile rows, four k tiles (the last ones, past each ballot) and three
    tile columns, plus A and B tiles whose partners are dead."""
    rows = rng.choice(mt, size=min(3, mt), replace=False)
    ks = sorted({kt - 1, kt // 2, *rng.choice(kt, size=min(2, kt), replace=False)})
    cols = rng.choice(nt, size=min(3, nt), replace=False)
    a = np.zeros((mt * TILE, kt * TILE), np.uint8)
    b = np.zeros((kt * TILE, nt * TILE), np.uint8)
    for mi in rows:
        for ki in ks:
            if rng.random() < 0.7:
                a[mi * TILE:(mi + 1) * TILE, ki * TILE:(ki + 1) * TILE] = \
                    rng.random((TILE, TILE)) < 0.02
    for ki in ks:
        for ni in cols:
            if rng.random() < 0.7:
                b[ki * TILE:(ki + 1) * TILE, ni * TILE:(ni + 1) * TILE] = \
                    rng.random((TILE, TILE)) < 0.02
    lone = [k for k in range(kt) if k not in ks][:2]
    if lone:  # an A tile full of ones with no live B partner
        a[rows[0] * TILE:(rows[0] + 1) * TILE, lone[0] * TILE:(lone[0] + 1) * TILE] = 1
    if len(lone) > 1:  # and a B tile with no live A partner
        b[lone[1] * TILE:(lone[1] + 1) * TILE, cols[0] * TILE:(cols[0] + 1) * TILE] = 1
    return a, b, np.sort(rows), np.array(sorted(ks + lone)), np.sort(cols)


@pytest.mark.parametrize("step", range(len(SGB_STEPS)))
def test_sgb_step_shapes_match_plain_and_jax(step):
    """Each SGB step's tile grid, at small density.  The mirror runs the
    whole grid; the plain version and the JAX kernel run on the operands
    cut to the tile rows, k tiles and tile columns that hold a set bit (a
    dead pair contributes nothing), so that they stay fast on the CPU."""
    mt, kt, nt = SGB_STEPS[step]
    rng = np.random.default_rng(100 + step)
    a, b, rows, ks, cols = _sparse_step(rng, mt, kt, nt)
    ao, bo = port.tile_occupancy(a), port.tile_occupancy(b)
    out, occ, stats = emulate(a, b, ao, bo)
    assert stats["splits"] == split_count(mt, nt, kt)

    def cut(x, r, c):
        return np.ascontiguousarray(
            x.reshape(x.shape[0] // TILE, TILE, x.shape[1] // TILE, TILE)[r][:, :, c]
            .reshape(len(r) * TILE, len(c) * TILE))

    ac, bc = cut(a, rows, ks), cut(b, ks, cols)
    aoc = ao.reshape(mt, kt)[np.ix_(rows, ks)].reshape(-1)
    boc = bo.reshape(kt, nt)[np.ix_(ks, cols)].reshape(-1)
    want_c, _ = plain(ac, bc, aoc, boc)
    assert np.array_equal(want_c, jax_kernel(ac, bc, aoc, boc).astype(np.uint8))
    want = np.zeros_like(out)
    want.reshape(mt, TILE, nt, TILE)[np.ix_(rows, np.arange(TILE), cols, np.arange(TILE))] = \
        want_c.reshape(len(rows), TILE, len(cols), TILE)
    assert np.array_equal(out, want)
    assert np.array_equal(occ, port.tile_occupancy(want))
    assert want.any() and stats["loads"] > 0


def test_sgb_step_shapes_are_the_plans():
    from repro_torch.core import sgb
    from repro_torch.hetero import make_dataset

    shapes = []
    for name, targets in SGB_WORKLOADS.items():
        g = make_dataset(name, seed=0, scale=1.0)
        nv = g.num_vertices
        for st in sgb.make_plan(g, targets, planner="ctt").steps:
            shapes.append(tuple(-(-nv[t] // TILE) for t in (st.left[0], st.left[-1],
                                                            st.right[-1])))
    assert shapes == SGB_STEPS
