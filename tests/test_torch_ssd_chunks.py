"""K5's chunk-parallel order on the CPU: a float32 emulation of the passes
that ``csrc/ssd_scan.cu`` launches, in the kernel's order, against the
plain version and the JAX kernel (interpret mode).

The kernel computes each chunk's cumulative decay with a warp scan (each
lane sums a few steps in order, then a shuffle scan of the lane totals),
each chunk's own state contribution, C Bᵀ once per group, the states
entering each chunk in chunk order (the only sequential step), and the
outputs; its products run as 3xTF32 on the tensor cores (operands split
into a TF32 high part and a remainder read as TF32, three products a k
step).  The
emulation repeats that order and that split, with the tile sizes read from
the CUDA source, so a change to either shows here before it reaches a card.
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

from repro.kernels.ssd_scan import ssd_scan as ref_ssd  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_plain  # noqa: E402

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
      / "ssd_scan.cu").read_text()
MAX_L = int(re.search(r"constexpr int kMaxL = (\d+);", CU).group(1))
LANES = int(re.search(r"constexpr int kScanSteps = kMaxL / (\d+);", CU).group(1))
SCAN_STEPS = MAX_L // LANES  # steps a lane sums in order
TILE = int(re.search(r"return \(v \+ \d+\) / (\d+) \* \d+;", CU).group(1))  # pad32
K_STEP = int(re.search(r"mma\.sync\.aligned\.m16n8k(\d+)\.row\.col\.f32\.tf32", CU).group(1))
TOL = 3e-4  # test_ssd_sweep (tests/test_kernels.py) and chip_smoke.py's K5_TOL

# (b, s, h, g, p, n, chunk): test_ssd_sweep's three shapes, the LM kernel
# tests' mamba2 layout, mamba2-370m's head layout cut to 8 heads and S = 512,
# and extents that are multiples of 4 but not of the 32-wide tiles
CASES = [
    (2, 128, 4, 2, 32, 16, 32),
    (1, 256, 2, 1, 64, 64, 64),
    (1, 64, 8, 8, 16, 16, 16),
    (2, 128, 4, 1, 16, 16, 64),
    (1, 512, 8, 1, 64, 128, 128),
    (1, 48, 3, 1, 12, 20, 12),
    (2, 40, 4, 2, 4, 36, 20),
]


def pad(n: int) -> int:
    return -(-n // TILE) * TILE


def tf32(v: np.ndarray) -> np.ndarray:
    """float32 cut to TF32 (10 mantissa bits, the 13 low bits dropped), as
    the kernel's ``split_tf32`` cuts the high part and the tensor core reads
    the low part."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def mm3(a: np.ndarray, b: np.ndarray, acc=None, passes: int = 3) -> np.ndarray:
    """``acc + a @ b`` the way the kernel's warps take it: k steps of
    ``K_STEP`` in order, each adding lo·hi, hi·lo, then hi·hi (``passes=1``:
    hi·hi alone, plain TF32), float32 throughout."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    out = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32) if acc is None else acc
    for k in range(0, a.shape[-1], K_STEP):
        ks = slice(k, k + K_STEP)
        if passes == 3:
            out = out + al[..., ks] @ bh[..., ks, :]
            out = out + ah[..., ks] @ bl[..., ks, :]
        out = out + ah[..., ks] @ bh[..., ks, :]
    return out


def chunk_cumsum(a: np.ndarray) -> np.ndarray:
    """The chunk pass's warp scan over ``a (..., L)``."""
    lead, l = a.shape[:-1], a.shape[-1]
    steps = np.zeros(lead + (LANES * SCAN_STEPS,), np.float32)
    steps[..., :l] = a
    lanes = np.cumsum(steps.reshape(lead + (LANES, SCAN_STEPS)), axis=-1, dtype=np.float32)
    incl = lanes[..., -1].copy()
    d = 1
    while d < LANES:  # Hillis-Steele: every lane adds the pre-step value d lanes back
        incl[..., d:] = incl[..., d:] + incl[..., :-d].copy()
        d *= 2
    excl = np.concatenate([np.zeros(lead + (1,), np.float32), incl[..., :-1]], axis=-1)
    return (excl[..., None] + lanes).reshape(lead + (-1,))[..., :l]


def emulate_k5(x, a, bm, cm, chunk, passes=3):
    """float32 emulation of K5's four passes on ``(B, S, H, P)`` inputs
    (``passes``: products a k step, as in ``mm3``)."""
    bsz, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    nc, lp, rep = s // chunk, pad(chunk), h // g
    # chunked, padded operands: (B, H or G, nc, lp, .)
    def chunks(t, width):
        out = np.zeros((bsz, t.shape[2], nc, lp, pad(width)), np.float32)
        out[..., :chunk, :width] = t.transpose(0, 2, 1, 3).reshape(
            bsz, t.shape[2], nc, chunk, width)
        return out
    xc, bc, cc = chunks(x, p), chunks(bm, n), chunks(cm, n)
    # pass 1: cum, and the chunk's own state (x * w)^T B
    cum = chunk_cumsum(a.transpose(0, 2, 1).reshape(bsz, h, nc, chunk))
    # padded to lp with cum[L - 1], as the output pass reads it back
    cum = np.concatenate([cum, np.repeat(cum[..., -1:], lp - chunk, -1)], -1)
    live = np.arange(lp) < chunk
    w = np.where(live, np.exp(np.minimum(cum[..., chunk - 1:chunk] - cum, 0)), 0)
    bh_ = np.repeat(bc, rep, axis=1)  # a head reads its group's B
    xw = xc * w[..., None].astype(np.float32)
    s_c = mm3(np.swapaxes(xw, -1, -2), bh_, passes=passes)  # (B, H, nc, pad P, pad N)
    # pass 2: G = C B^T once per group
    gm = mm3(cc, np.swapaxes(bc, -1, -2), passes=passes)  # (B, G, nc, lp, lp)
    # pass 3: the states entering each chunk, fmaf(d, h, S_c) in chunk order
    dec = np.exp(cum[..., chunk - 1])  # (B, H, nc)
    hc = np.zeros_like(s_c)
    state = np.zeros(s_c.shape[:2] + s_c.shape[3:], np.float32)
    for c in range(nc):
        hc[:, :, c] = state
        state = (dec[:, :, c, None, None].astype(np.float64) * state
                 + s_c[:, :, c]).astype(np.float32)
    # pass 4: y = (G o decay) x + (exp(cum) o C) h_c^T
    tt, ss = np.arange(lp)[:, None], np.arange(lp)[None, :]
    decay = np.exp(np.minimum(cum[..., :, None] - cum[..., None, :], 0))
    gmh = np.repeat(gm, rep, axis=1)
    gdec = np.where((ss <= tt) & (tt < chunk), gmh * decay, 0).astype(np.float32)
    e = np.where(live, np.exp(cum), 0).astype(np.float32)
    y = mm3(gdec, xc, passes=passes)
    y = mm3(np.repeat(cc, rep, axis=1) * e[..., None], np.swapaxes(hc, -1, -2), acc=y,
            passes=passes)
    y = y[..., :chunk, :p].reshape(bsz, h, s, p)
    return y.transpose(0, 2, 1, 3)


def _inputs(case):
    b, s, h, g, p, n, chunk = case
    rng = np.random.default_rng(s + 10 * h + n)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a = (-np.abs(rng.standard_normal((b, s, h))) * 0.1).astype(np.float32)
    bc = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    cc = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    return x, a, bc, cc


def test_tile_sizes_read_from_the_source():
    assert (MAX_L, LANES, SCAN_STEPS, TILE, K_STEP) == (128, 32, 4, 32, 8)


@pytest.mark.parametrize("l", [4, 12, 16, 64, 100, 128])
def test_chunk_scan_is_the_cumsum_within_rounding(l):
    """The warp scan sums in another order than a running sum, within
    float32 rounding of it (so its cum need not fall step by step bit for
    bit: the kernel clamps every exp argument to <= 0)."""
    rng = np.random.default_rng(l)
    a = (-np.abs(rng.standard_normal((6, l))) * 0.1).astype(np.float32)
    cum = chunk_cumsum(a)
    assert cum.shape == (6, l) and cum.dtype == np.float32
    np.testing.assert_allclose(cum, np.cumsum(a.astype(np.float64), -1), rtol=1e-6,
                               atol=1e-6)
    assert (cum[:, 0] == a[:, 0]).all()
    if l <= SCAN_STEPS:  # one lane: a running sum
        assert np.array_equal(cum, np.cumsum(a, -1, dtype=np.float32))


@pytest.mark.parametrize("b,s,h,g,p,n,chunk", CASES)
def test_kernel_order_matches_plain_and_jax(b, s, h, g, p, n, chunk):
    x, a, bc, cc = _inputs((b, s, h, g, p, n, chunk))
    got = emulate_k5(x, a, bc, cc, chunk)
    plain = ssd_plain(*(torch.from_numpy(v) for v in (x, a, bc, cc)), chunk=chunk).numpy()
    jax_out = np.asarray(ref_ssd(*(jnp.asarray(v) for v in (x, a, bc, cc)), chunk=chunk,
                                 interpret=True))
    assert got.shape == (b, s, h, p) and got.dtype == np.float32
    np.testing.assert_allclose(got, plain, atol=TOL)
    np.testing.assert_allclose(got, jax_out, atol=TOL)


def test_one_tf32_pass_would_miss_the_tolerance():
    """Why three products a k step: at mamba2's head layout with |y| of tens,
    hi·hi alone (plain TF32, about three decimal digits) misses 3e-4, while
    the split keeps an error an order of magnitude below it."""
    x, a, bc, cc = _inputs(CASES[4])
    chunk = CASES[4][-1]
    plain = ssd_plain(*(torch.from_numpy(v) for v in (x, a, bc, cc)), chunk=chunk).numpy()
    err3 = np.abs(emulate_k5(x, a, bc, cc, chunk) - plain).max()
    err1 = np.abs(emulate_k5(x, a, bc, cc, chunk, passes=1) - plain).max()
    assert np.abs(plain).max() > 10
    assert err1 > 10 * TOL and TOL > 10 * err3, (err1, err3)
