"""K4's tile plan on the CPU: a Python mirror of the bf16 kernel's loop
bounds and tile classification (``csrc/flash_attention.cu``,
``fa_forward_wgmma_kernel``), and a float32 emulation of its summation
order against the plain version and the JAX kernel.

The kernel gives each CTA 128 query rows, split between two warpgroups of
64, and walks keys in tiles of 128 (of 64 at head dim 256).  The loop bounds skip the key tiles
that no row of the CTA can see; inside the loop a warpgroup applies the
element mask (causal, window, ``kpos < T``) only to the tiles it flagged.
The mirror below must say the same: no live (q, k) pair in a skipped
tile, no masked pair in a tile run without the mask.  The tile sizes are
read from the CUDA source, so the mirror follows the kernel.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
      / "flash_attention.cu").read_text()
BLOCK_Q = int(re.search(r"constexpr int kBlockQ = (\d+);", CU).group(1))
# keys per tile by head dim: ``kBlockK<DH>`` picks one of two constants
_BK_CONST = {m.group(1): int(m.group(2))
             for m in re.finditer(r"constexpr int (kBlockK\w+) = (\d+);", CU)}
_BK_PICK = re.search(r"constexpr int kBlockK = DH == (\d+) \? (\w+) : (\w+);", CU)
HEAD_DIMS_CU = tuple(int(d) for d in re.findall(r"if \(dh == (\d+)\) \{\n    return launch<",
                                                CU))


def block_k(dh: int) -> int:
    """Keys per K/V tile of the bf16 kernel at head dim ``dh``."""
    pick, yes, no = _BK_PICK.groups()
    return _BK_CONST[yes if dh == int(pick) else no]


BLOCK_K = block_k(64)  # head dim 64 and 128
WG_ROWS = 64  # rows of one consumer warpgroup: wgmma's M
LOG2E = 1.4426950408889634
NEG = -1e30

# (S, T, causal, window): the sweep grid of test_flash_attention_sweep,
# the card tests' tile edges, smollm-135m's prefill shapes, windows whose
# edges cross key tiles, S < T, and S > T (leading rows with no live key)
PLAN_CASES = [
    (128, 128, True, None), (100, 100, True, None), (96, 224, True, None),
    (128, 128, True, 64), (64, 64, False, None), (300, 300, True, None),
    (70, 333, True, 100), (129, 129, True, None), (255, 255, True, None),
    (1000, 1000, True, None), (200, 700, True, 100), (300, 650, False, 190),
    (2048, 2048, True, None), (4096, 4096, True, None), (1, 4096, True, None),
    (512, 512, True, 127), (512, 512, True, 128), (512, 512, True, 129),
    (400, 1000, False, 300), (1000, 257, True, None), (8, 4, True, 1),
    (300, 300, False, None), (777, 1500, True, 500),
    # a warpgroup's first row one key short of a tile's last key (T - S =
    # 126, and 62 + 64), a window whose first live key ends a tile, one
    # whose edge cuts a warpgroup's last row off a tile's first key, and T
    # one short of a tile
    (130, 256, True, None), (66, 128, True, None), (256, 256, True, 2),
    (200, 300, False, 37), (512, 512, False, 63), (100, 255, False, None),
]

# (B, Hq, Hkv, S, T, Dh, causal, window, softcap) for the emulation:
# test_flash_attention_sweep's grid, smollm-135m's (9 / 3, Dh 64) and
# minitron-4b's (24 / 8, Dh 128) head layouts, and the tile-edge cases
EMU_CASES = [
    (2, 4, 2, 128, 128, 64, True, None, None),
    (1, 8, 2, 100, 100, 64, True, None, 50.0),
    (1, 4, 4, 96, 224, 64, True, None, None),
    (2, 4, 2, 128, 128, 64, True, 64, None),
    (1, 2, 1, 64, 64, 128, False, None, None),
    (2, 9, 3, 300, 300, 64, True, None, None),
    (1, 9, 3, 70, 333, 64, True, 100, 30.0),
    (1, 24, 8, 200, 200, 128, True, None, None),
    (1, 2, 1, 255, 255, 128, True, None, None),
    (1, 4, 2, 200, 700, 64, True, 100, None),
    (1, 4, 2, 300, 650, 64, False, 190, 20.0),
    # head dim 256 (64-key tiles): gemma2-2b's head layout (8 / 4) with its
    # softcap on a window and causal, S < T, and a ragged non-causal case
    (1, 8, 4, 300, 300, 256, True, 100, 50.0),
    (1, 8, 4, 200, 200, 256, True, None, 50.0),
    (1, 2, 1, 96, 224, 256, True, None, None),
    (1, 2, 2, 130, 190, 256, False, 70, None),
]


def tile_plan(s, t, causal, window, bk=BLOCK_K):
    """The kernel's plan, per 128-row query tile: ``(q0, rows, kt_begin,
    kt_end, masked)`` with ``masked[c][kt - kt_begin]`` true where
    warpgroup ``c`` runs the element mask on key tile ``kt`` (of ``bk``
    keys)."""
    plan = []
    for qt in range(math.ceil(s / BLOCK_Q)):
        q0 = qt * BLOCK_Q
        rows = min(BLOCK_Q, s - q0)
        q_lo = q0 + t - s
        q_hi = q_lo + rows - 1
        kt_end = math.ceil(t / bk)
        if causal:
            kt_end = min(kt_end, 0 if q_hi < 0 else q_hi // bk + 1)
        kt_begin = 0
        if window is not None and q_lo - window + 1 > 0:
            kt_begin = (q_lo - window + 1) // bk
        masked = []
        for c in range(BLOCK_Q // WG_ROWS):
            wg_lo = q_lo + WG_ROWS * c
            flags = []
            for kt in range(kt_begin, kt_end):
                k0 = kt * bk
                full = (k0 + bk <= t and (not causal or k0 + bk - 1 <= wg_lo)
                        and (window is None or k0 > wg_lo + WG_ROWS - 1 - window))
                flags.append(not full)
            masked.append(flags)
        plan.append((q0, rows, kt_begin, kt_end, masked))
    return plan


def live_pairs(s, t, causal, window):
    """(S, T) bool: query row i (key position i + T - S) may see key j."""
    qpos = np.arange(s)[:, None] + (t - s)
    kpos = np.arange(t)[None, :]
    live = np.ones((s, t), bool)
    if causal:
        live &= kpos <= qpos
    if window is not None:
        live &= kpos > qpos - window
    return live


def check_plan(s, t, causal, window, bk):
    """No live (q, k) pair in a skipped key tile, none masked in a tile run
    without the element mask, and tight loop bounds."""
    live = live_pairs(s, t, causal, window)
    n_kt = math.ceil(t / bk)
    seen = np.zeros_like(live)
    for q0, rows, kt_begin, kt_end, masked in tile_plan(s, t, causal, window, bk):
        assert 0 <= kt_begin and kt_end <= n_kt
        tile = live[q0:q0 + rows]
        # the loop bounds are tight: the first and last visited key tiles
        # hold a live pair of this query tile
        if kt_begin < kt_end:
            assert tile[:, kt_begin * bk:(kt_begin + 1) * bk].any()
            assert tile[:, (kt_end - 1) * bk:kt_end * bk].any()
        seen[q0:q0 + rows, kt_begin * bk:kt_end * bk] = True
        for c, flags in enumerate(masked):
            wg = tile[WG_ROWS * c:WG_ROWS * (c + 1)]
            for kt, flag in zip(range(kt_begin, kt_end), flags):
                if not flag:  # run without the element mask: every pair live, inside T
                    assert (kt + 1) * bk <= t
                    assert wg[:, kt * bk:(kt + 1) * bk].all()
    assert not (live & ~seen).any(), "a live pair lies in a skipped key tile"


@pytest.mark.parametrize("s,t,causal,window", PLAN_CASES)
def test_tile_plan_skips_no_live_pair_and_masks_every_dead_one(s, t, causal, window):
    pytest.importorskip("torch")
    check_plan(s, t, causal, window, BLOCK_K)


# head dim 256 (key tiles of 64): the same grid, gemma2-2b's local layers
# (window 4096) at its prefill length and at 8192, where the window cuts
# the early keys off, and window edges one key either side of a tile
PLAN_CASES_DH256 = PLAN_CASES + [
    (2048, 2048, True, 4096), (8192, 8192, True, 4096), (8192, 8192, True, None),
    (4160, 4160, True, 4096), (512, 512, True, 63), (512, 512, True, 65),
    (1000, 4200, True, 4096), (65, 65, True, None),
]


@pytest.mark.parametrize("s,t,causal,window", PLAN_CASES_DH256)
def test_tile_plan_at_head_dim_256_skips_no_live_pair_and_masks_every_dead_one(
        s, t, causal, window):
    pytest.importorskip("torch")
    assert block_k(256) == 64 and block_k(128) == block_k(64) == 128
    check_plan(s, t, causal, window, block_k(256))


def test_tile_plan_at_head_dim_256_masks_three_tiles_a_causal_query_tile():
    """With 64-key tiles a 128-row query tile ends on two key tiles: the
    first warpgroup masks both (the second lies wholly above its rows), the
    second only the last; every other tile runs unmasked."""
    pytest.importorskip("torch")
    s, bk = 2048, block_k(256)
    plan = tile_plan(s, s, True, None, bk)
    visited = sum(kt_end - kt_begin for _, _, kt_begin, kt_end, _ in plan)
    masked = sum(sum(f) for *_, m in plan for f in m)
    assert visited == sum((q0 + BLOCK_Q) // bk for q0, *_ in plan)
    assert masked == 3 * len(plan)
    # gemma2-2b's local layer at S = 8192: a query tile visits the 64 + 2
    # key tiles its window and its diagonal reach, no more
    plan = tile_plan(8192, 8192, True, 4096, bk)
    assert max(kt_end - kt_begin for _, _, kt_begin, kt_end, _ in plan) == 4096 // bk + 2


def test_every_config_the_port_runs_has_a_head_dim_k4_takes():
    """Each LM config whose mixers the port runs (``LM`` does not raise
    NotImplementedError) and that has attention has a head dim that K4's
    wrapper and its CUDA dispatch both take: gemma2-2b's 256 was once
    refused on the card though the config ran on the CPU."""
    pytest.importorskip("torch")
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    from repro_torch.models import LM

    assert tuple(sorted(HEAD_DIMS)) == tuple(sorted(HEAD_DIMS_CU))
    runs = []
    for name, cfg in sorted(ARCHS.items()):
        try:
            LM(cfg, device="cpu")
        except NotImplementedError:
            continue
        if any(mixer in ("attn", "local") for mixer, _ in cfg.block_pattern):
            assert cfg.head_dim in HEAD_DIMS, (name, cfg.head_dim)
            runs.append(name)
    assert {"smollm-135m", "gemma2-2b", "minitron-4b"} <= set(runs)


def test_tile_plan_runs_most_causal_tiles_unmasked():
    """At smollm-135m's prefill length only the diagonal tiles need the
    element mask: 2 of a query tile's key tiles, one per warpgroup."""
    pytest.importorskip("torch")
    s = 2048
    plan = tile_plan(s, s, True, None)
    visited = sum(kt_end - kt_begin for _, _, kt_begin, kt_end, _ in plan)
    masked = sum(sum(f) for *_, m in plan for f in m)
    assert visited == (s // BLOCK_K) * (s // BLOCK_K + 1) // 2
    assert masked == len(plan) * (BLOCK_Q // WG_ROWS)


def emulate_kernel(q, k, v, causal, window, softcap, scale):
    """float32 emulation of the bf16 kernel's order on (B, H, S, Dh)
    tensors: per warpgroup of 64 rows and per visited key tile, S = Q Kᵀ
    in float32, the element mask only on flagged tiles, the base-2 online
    softmax (row max on the unscaled scores, then ``p = 2^(s * scale *
    log2(e) - m)``; with softcap on the capped base-2 logits), P rounded to
    bf16 before P V, keys past T read as zeros (TMA's fill), output ``acc /
    max(l, 1e-20)``."""
    import torch

    b, hq, s, dh = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    bk = block_k(dh)
    t_pad = math.ceil(t / bk) * bk
    kf = torch.zeros((b, hkv, t_pad, dh))
    vf = torch.zeros((b, hkv, t_pad, dh))
    kf[:, :, :t], vf[:, :, :t] = k.float(), v.float()
    kf, vf = kf.repeat_interleave(g, dim=1), vf.repeat_interleave(g, dim=1)
    qf = q.float()
    live = torch.from_numpy(live_pairs(s, t, causal, window))
    out = torch.zeros((b, hq, s, dh))
    for q0, rows, kt_begin, kt_end, masked in tile_plan(s, t, causal, window, bk):
        for c, flags in enumerate(masked):
            r0, r1 = q0 + WG_ROWS * c, min(q0 + WG_ROWS * (c + 1), q0 + rows)
            if r0 >= r1:
                continue
            qw = qf[:, :, r0:r1]
            m = torch.full((b, hq, r1 - r0, 1), NEG)
            l = torch.zeros((b, hq, r1 - r0, 1))
            acc = torch.zeros((b, hq, r1 - r0, dh))
            for kt, flag in zip(range(kt_begin, kt_end), flags):
                k0 = kt * bk
                x = qw @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
                mul = scale * LOG2E  # raw scores to base-2 logits
                if softcap is not None:
                    x, mul = torch.tanh(x * (scale / softcap)) * (softcap * LOG2E), 1.0
                if flag:
                    tile_live = torch.zeros((r1 - r0, bk), dtype=torch.bool)
                    width = min(bk, t - k0)
                    tile_live[:, :width] = live[r0:r1, k0:k0 + width]
                    x = torch.where(tile_live, x, torch.tensor(NEG))
                mx = x.amax(-1, keepdim=True)  # the row max of the unscaled scores
                m_new = torch.maximum(m, torch.where(mx > NEG / 2, mx * mul, torch.tensor(NEG)))
                alpha = torch.where(m > NEG / 2, torch.exp2(m - m_new), torch.zeros(()))
                p = torch.exp2(x * mul - m_new)
                if flag:
                    p = torch.where(x > NEG / 2, p, torch.zeros(()))
                l = l * alpha + p.sum(-1, keepdim=True)
                pb = p.to(torch.bfloat16).float()
                acc = acc * alpha + pb @ vf[:, :, k0:k0 + bk]
                m = m_new
            out[:, :, r0:r1] = acc / torch.clamp(l, min=1e-20)
    return out.to(q.dtype)


@pytest.mark.parametrize("b,hq,hkv,s,t,dh,causal,window,cap", EMU_CASES)
def test_kernel_order_emulation_matches_plain_and_jax(b, hq, hkv, s, t, dh, causal,
                                                      window, cap):
    torch = pytest.importorskip("torch")
    # PyTorch's CPU build can get the first vectorized float op of a fresh
    # process wrong (see test_torch_lm_kernels.py): a throwaway call first
    torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))
    import jax.numpy as jnp

    from repro.kernels.flash_attention import flash_attention as ref_flash
    from repro_torch.kernels.flash_attention import attention_plain

    rng = np.random.default_rng(s * 1000 + t + hq)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, hq, s, dh), (b, hkv, t, dh), (b, hkv, t, dh))]
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    got = emulate_kernel(q, k, v, causal, window, cap, dh ** -0.5)
    plain = attention_plain(q, k, v, causal=causal, window=window, softcap=cap)
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    jax_out = ref_flash(qj, kj, vj, causal=causal, window=window, softcap=cap,
                        interpret=True)
    assert got.dtype == torch.bfloat16 and got.shape == (b, hq, s, dh)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), atol=3e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jax_out, np.float32),
                               atol=3e-2)
