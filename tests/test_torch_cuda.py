"""The hand-written CUDA kernels K1-K5 against their plain PyTorch
versions, on a CUDA card.

Every test here needs the card (marker ``cuda``) and skips without one; on
the card run ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.  The
file imports no JAX, so it runs where only PyTorch is installed.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.edge_softmax import (edge_softmax_stats,  # noqa: E402
                                              softmax_stats_plain)
from repro_torch.kernels.seg_sum import (pack_edge_blocks, seg_sum_na,  # noqa: E402
                                         seg_sum_plain)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import (NATIVE_PAIRS,  # noqa: E402
                                                 attention_plain, flash_attention,
                                                 kernel_info)
from repro_torch.kernels.spgemm_bsr import (TILE,  # noqa: E402
                                            compose_padded_blocked,
                                            split_count, spgemm_bsr,
                                            spgemm_plain,
                                            tile_occupancy, transpose_tiles,
                                            transpose_tiles_plain)
from repro_torch.kernels.spgemm_bsr import \
    kernel_info as spgemm_kernel_info  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_plain, ssd_scan  # noqa: E402

SHAPES = [(64, 64, 200, 32), (300, 200, 1500, 64), (17, 5, 40, 16)]


def _edges(rng, ns, nd, ne):
    src = rng.integers(0, ns, ne)
    dst = rng.integers(0, nd, ne)
    o = np.lexsort((src, dst))
    return src[o], dst[o]


def _revisit():
    """Tile 0 -> tile 1 -> tile 0 again: dst 0 receives from both visits."""
    return np.array([0, 1, 700, 2]), np.array([0, 3, 130, 0]), 1024, 256


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ns,nd,ne,d", SHAPES + [(3000, 2000, 60000, 64)])
def test_seg_sum_kernel_matches_plain(cuda_device, ns, nd, ne, d):
    rng = np.random.default_rng(ne)
    src, dst = _edges(rng, ns, nd, ne)
    pk = pack_edge_blocks(src, dst, ns, nd)
    h = torch.from_numpy(rng.standard_normal((ns, d)).astype(np.float32)).to(cuda_device)
    w = torch.from_numpy(rng.random(pk.src_local.shape).astype(np.float32)).to(cuda_device)
    for weights in (None, w):
        before = seg_sum_na.launches
        got = seg_sum_na(pk, h, weights)
        again = seg_sum_na(pk, h, weights)
        torch.cuda.synchronize()
        assert seg_sum_na.launches == before + 2
        want = seg_sum_plain(pk, h, weights)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)
        assert torch.equal(got, again)


@pytest.mark.cuda
def test_kernels_survive_nonconsecutive_revisit(cuda_device):
    src, dst, ns, nd = _revisit()
    pk = pack_edge_blocks(src, dst, ns, nd)
    h = torch.randn(ns, 40, device=cuda_device)
    np.testing.assert_allclose(seg_sum_na(pk, h).cpu().numpy(),
                               seg_sum_plain(pk, h).cpu().numpy(), atol=1e-6)
    lb = torch.randn(pk.src_local.shape, device=cuda_device)
    m, s = edge_softmax_stats(pk, lb)
    m_p, s_p = softmax_stats_plain(pk, lb)
    np.testing.assert_allclose(m.cpu().numpy(), m_p.cpu().numpy(), rtol=1e-6)
    np.testing.assert_allclose(s.cpu().numpy(), s_p.cpu().numpy(), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("ns,nd,ne", [(300, 200, 1500), (50, 600, 900), (3000, 2000, 60000)])
def test_softmax_stats_kernel_matches_plain(cuda_device, ns, nd, ne):
    rng = np.random.default_rng(ne)
    src, dst = _edges(rng, ns, nd, ne)
    pk = pack_edge_blocks(src, dst, ns, nd)
    lb = torch.from_numpy((rng.standard_normal(pk.src_local.shape) * 3)
                          .astype(np.float32)).to(cuda_device)
    before = edge_softmax_stats.launches
    m, s = edge_softmax_stats(pk, lb)
    m2, s2 = edge_softmax_stats(pk, lb)
    torch.cuda.synchronize()
    assert edge_softmax_stats.launches == before + 2
    m_p, s_p = softmax_stats_plain(pk, lb)
    np.testing.assert_allclose(m.cpu().numpy(), m_p.cpu().numpy(), rtol=1e-6)
    np.testing.assert_allclose(s.cpu().numpy(), s_p.cpu().numpy(), atol=1e-5, rtol=1e-5)
    assert torch.equal(m, m2) and torch.equal(s, s2)


def _na_case(case):
    """(packing, rows without edges) of a skewed or sparse stream."""
    rng = np.random.default_rng(len(case))
    if case == "hub":  # row 7 takes 6,000 in-edges from every band
        src, dst = _edges(rng, 3000, 900, 4000)
        src = np.concatenate([src, rng.integers(0, 3000, 6000)])
        dst = np.concatenate([dst, np.full(6000, 7)])
        o = np.lexsort((src, dst))
        src, dst, ns, nd, w = src[o], dst[o], 3000, 900, None
    else:  # rows 0-39 and 600-639 only: tiles 1-3 and row 640.. get nothing
        src, dst = _edges(rng, 800, 80, 3000)
        dst = np.where(dst < 40, dst, dst + 560)
        ns, nd = 800, 700
        w = None
        if case == "zero_weight":  # a third of the edges weigh 0 but stay edges
            w = rng.random(src.size).astype(np.float32)
            w[::3] = 0.0
    pk = pack_edge_blocks(src, dst, ns, nd, weight=w)
    return pk, np.bincount(dst, minlength=nd) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 33, 64, 128])
@pytest.mark.parametrize("case", ["hub", "empty", "zero_weight"])
def test_seg_sum_kernel_skew_empty_rows_and_widths(cuda_device, case, d):
    pk, empty = _na_case(case)
    rng = np.random.default_rng(d)
    # features over sqrt(max in-degree): the hub's sum stays of unit size
    scale = 1.0 / np.sqrt(np.diff(pk.row_edges().row_ptr).max())
    h = torch.from_numpy((rng.standard_normal((pk.num_src, d)) * scale)
                         .astype(np.float32)).to(cuda_device)
    w = torch.from_numpy((rng.random(pk.src_local.shape) * pk.valid_mask())
                         .astype(np.float32)).to(cuda_device)
    for weights in (None, w):
        got = seg_sum_na(pk, h, weights)
        again = seg_sum_na(pk, h, weights)
        torch.cuda.synchronize()
        assert got.shape == (pk.num_dst, d)
        assert torch.equal(got, again)
        want = seg_sum_plain(pk, h, weights)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)
        assert (got[torch.from_numpy(empty).to(cuda_device)] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hub", "empty", "zero_weight"])
def test_softmax_stats_kernel_skew_empty_rows_zero_weights(cuda_device, case):
    pk, empty = _na_case(case)
    rng = np.random.default_rng(3)
    logits = torch.from_numpy((rng.standard_normal(pk.num_edges) * 3)
                              .astype(np.float32)).to(cuda_device)
    lb = pk.scatter_blocks(logits, fill=-1e30)
    m, s = edge_softmax_stats(pk, lb)
    m2, s2 = edge_softmax_stats(pk, lb)
    torch.cuda.synchronize()
    assert torch.equal(m, m2) and torch.equal(s, s2)
    m_p, s_p = softmax_stats_plain(pk, lb)
    assert torch.equal(m, m_p)  # a max is exact
    assert ((s - s_p).abs() / s_p.abs().clamp(min=1.0)).max().item() <= 1e-5
    e = torch.from_numpy(empty).to(cuda_device)
    assert (m[e] == -1e30).all() and (s[e] == 0).all()
    assert (s[~e] >= 1).all()  # the max edge contributes exp(0)
    if case == "zero_weight":  # validity comes from count, not the weights
        bare = dataclasses.replace(pk, weight=None)
        m_b, s_b = edge_softmax_stats(bare, lb)
        assert torch.equal(m, m_b) and torch.equal(s, s_b)


@pytest.mark.cuda
def test_kernel_wrappers_check_operands(cuda_device):
    src, dst, ns, nd = _revisit()
    pk = pack_edge_blocks(src, dst, ns, nd)
    h = torch.zeros(ns, 4, device=cuda_device)
    w = torch.zeros(pk.src_local.shape, device=cuda_device)
    with pytest.raises(TypeError):
        seg_sum_na(pk, torch.zeros(ns, 4, dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError):
        seg_sum_na(pk, torch.zeros(ns - 1, 4, device=cuda_device))
    with pytest.raises(ValueError):
        edge_softmax_stats(pk, torch.zeros(1, 256, device=cuda_device))
    with pytest.raises(TypeError):
        seg_sum_na(pk, h, w.double())
    with pytest.raises(ValueError, match="weights must be"):
        seg_sum_na(pk, h, torch.zeros(1, 256, device=cuda_device))
    with pytest.raises(ValueError, match="one device"):
        seg_sum_na(pk, h, w.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        seg_sum_na(pk, torch.zeros(4, ns, device=cuda_device).t(), w)
    with pytest.raises(ValueError, match="contiguous"):
        seg_sum_na(pk, h, torch.zeros(w.shape[::-1], device=cuda_device).t())
    with pytest.raises(TypeError):
        edge_softmax_stats(pk, w.double())
    with pytest.raises(ValueError, match="contiguous"):
        edge_softmax_stats(pk, torch.zeros(w.shape[::-1], device=cuda_device).t())


def _bool_matrix(rng, rows, cols, density, device):
    return torch.from_numpy((rng.random((rows, cols)) < density)
                            .astype(np.uint8)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("mt,kt,nt,density", [
    (1, 1, 1, 0.01), (2, 3, 4, 0.002), (3, 2, 1, 0.0), (5, 7, 3, 0.3),
    (8, 24, 16, 0.0003),
    # split k: one output tile over 112 k tiles (AP x PV's shape), two over 40
    (1, 112, 1, 0.01), (2, 40, 1, 0.01),
    # one k tile under a wide B; k lists longer than one 32-wide ballot
    (3, 1, 200, 0.02), (3, 70, 100, 0.003)])
def test_spgemm_kernel_matches_plain(cuda_device, mt, kt, nt, density):
    rng = np.random.default_rng(mt * 100 + kt * 10 + nt)
    a = _bool_matrix(rng, mt * TILE, kt * TILE, density, cuda_device)
    b = _bool_matrix(rng, kt * TILE, nt * TILE, density, cuda_device)
    ao, bo = tile_occupancy(a), tile_occupancy(b)
    before = spgemm_bsr.launches
    out, occ = spgemm_bsr(a, b, ao, bo)
    again, occ2 = spgemm_bsr(a, b, ao, bo)
    torch.cuda.synchronize()
    assert spgemm_bsr.launches == before + 2
    want, want_occ = spgemm_plain(a, b, ao, bo)
    assert out.dtype == torch.uint8 and torch.equal(out, want)
    assert torch.equal(occ, want_occ)
    assert torch.equal(out, again) and torch.equal(occ, occ2)


@pytest.mark.cuda
def test_spgemm_kernel_stale_and_dead_bitmaps(cuda_device):
    rng = np.random.default_rng(5)
    a = _bool_matrix(rng, 3 * TILE, 3 * TILE, 0.01, cuda_device)
    b = _bool_matrix(rng, 3 * TILE, 2 * TILE, 0.01, cuda_device)
    ao, bo = tile_occupancy(a), tile_occupancy(b)
    stale_a, stale_b = ao.clone(), bo.clone()
    stale_a[1] = 0  # a nonzero tile of A read as empty
    stale_b[2] = 0
    out, _ = spgemm_bsr(a, b, stale_a, stale_b)
    want, _ = spgemm_plain(a, b, stale_a, stale_b)
    assert torch.equal(out, want)
    assert not torch.equal(out, spgemm_plain(a, b, ao, bo)[0])
    # every pair dead: zeros and an empty bitmap, whatever the operands hold
    dead, dead_occ = spgemm_bsr(a, b, torch.zeros_like(ao), bo)
    torch.cuda.synchronize()
    assert int(dead.sum()) == 0 and int(dead_occ.sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mt,kt,nt", [(1, 112, 1), (2, 40, 1)])
def test_spgemm_kernel_splits_narrow_products(cuda_device, mt, kt, nt):
    """Few output tiles: each tile's k range is split over CTAs, whose
    partial tiles meet by an atomic OR; the bits repeat whatever the
    order."""
    assert split_count(mt, nt, kt) > 1
    assert split_count(32, 32, 112) == 1  # DBLP's APA: enough tiles
    rng = np.random.default_rng(kt)
    a = _bool_matrix(rng, mt * TILE, kt * TILE, 0.01, cuda_device)
    b = _bool_matrix(rng, kt * TILE, nt * TILE, 0.01, cuda_device)
    ao, bo = tile_occupancy(a), tile_occupancy(b)
    want, want_occ = spgemm_plain(a, b, ao, bo)
    for _ in range(3):
        out, occ = spgemm_bsr(a, b, ao, bo)
        torch.cuda.synchronize()
        assert torch.equal(out, want) and torch.equal(occ, want_occ)


@pytest.mark.cuda
def test_spgemm_kernel_stale_bit_inside_a_split_slice(cuda_device):
    mt, kt, nt = 1, 112, 1
    splits = split_count(mt, nt, kt)
    assert splits > 1
    rng = np.random.default_rng(11)
    a = _bool_matrix(rng, mt * TILE, kt * TILE, 0.01, cuda_device)
    b = _bool_matrix(rng, kt * TILE, nt * TILE, 0.01, cuda_device)
    ao, bo = tile_occupancy(a), tile_occupancy(b)
    stale_a, stale_b = ao.clone(), bo.clone()
    stale_a[kt // splits + 1] = 0  # inside the second slice
    stale_b[kt - 2] = 0  # inside the last
    out, occ = spgemm_bsr(a, b, stale_a, stale_b)
    want, want_occ = spgemm_plain(a, b, stale_a, stale_b)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(occ, want_occ)
    assert not torch.equal(out, spgemm_plain(a, b, ao, bo)[0])
    # every bit of one slice cleared: the other slices' pairs alone
    cut = ao.clone()
    cut[: kt // splits] = 0
    out, _ = spgemm_bsr(a, b, cut, bo)
    assert torch.equal(out, spgemm_plain(a, b, cut, bo)[0])


@pytest.mark.cuda
def test_spgemm_transpose_pre_pass_and_its_scratch_checks(cuda_device):
    rng = np.random.default_rng(2)
    b = _bool_matrix(rng, 3 * TILE, 5 * TILE, 0.05, cuda_device)
    bo = tile_occupancy(b)
    bo[4] = 0  # a tile that holds ones, read as dead: its scratch stays as it was
    bt = torch.full((5 * TILE, 3 * TILE), 0xAB, dtype=torch.uint8, device=cuda_device)
    want = transpose_tiles_plain(b.cpu(), bo.cpu(), bt.cpu())
    got = transpose_tiles(b, bo, bt)
    torch.cuda.synchronize()
    assert got.data_ptr() == bt.data_ptr() and torch.equal(got.cpu(), want)
    assert int((want == 0xAB).sum()) == TILE * TILE
    with pytest.raises(ValueError, match="scratch must be"):
        transpose_tiles(b, bo, bt[:, :TILE].contiguous())
    with pytest.raises(TypeError):
        transpose_tiles(b, bo, bt.to(torch.int8))
    with pytest.raises(ValueError, match="contiguous"):
        transpose_tiles(b, bo, torch.empty((3 * TILE, 5 * TILE), dtype=torch.uint8,
                                           device=cuda_device).t())
    with pytest.raises(ValueError, match="one device"):
        transpose_tiles(b, bo, bt.cpu())
    with pytest.raises(ValueError, match="b_occ"):
        transpose_tiles(b, bo[:3], bt)
    info = spgemm_kernel_info()
    assert info["local_bytes"] == 0 and info["ctas_per_sm"] >= 1


@pytest.mark.cuda
def test_compose_padded_occupancy_is_the_outputs(cuda_device):
    rng = np.random.default_rng(9)
    a = _bool_matrix(rng, 4 * TILE, 6 * TILE, 0.0005, cuda_device)
    b = _bool_matrix(rng, 6 * TILE, 5 * TILE, 0.0005, cuda_device)
    out, occ, stats = compose_padded_blocked(a, b, tile_occupancy(a), tile_occupancy(b))
    assert torch.equal(occ, tile_occupancy(out))
    assert 0 < int(occ.sum()) < occ.numel()
    assert stats["tile_pairs_total"] == 4 * 6 * 5


@pytest.mark.cuda
def test_spgemm_wrapper_checks_operands(cuda_device):
    a = torch.zeros((TILE, 2 * TILE), dtype=torch.uint8, device=cuda_device)
    b = torch.zeros((2 * TILE, TILE), dtype=torch.uint8, device=cuda_device)
    ao = torch.ones((2,), dtype=torch.int32, device=cuda_device)
    bo = torch.ones((2,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="one device"):
        spgemm_bsr(a, b.cpu(), ao, bo)
    with pytest.raises(TypeError):
        spgemm_bsr(a.float(), b.float(), ao, bo)
    with pytest.raises(TypeError):
        spgemm_bsr(a, b, ao.long(), bo)
    with pytest.raises(ValueError, match="multiples"):
        spgemm_bsr(a[:, :200].contiguous(), b[:200], ao, bo)
    with pytest.raises(ValueError, match="contiguous"):
        spgemm_bsr(a, b.t().contiguous().t(), ao, bo)
    with pytest.raises(ValueError, match="bitmaps"):
        spgemm_bsr(a, b, ao[:1], bo)
    with pytest.raises(ValueError):
        spgemm_bsr(a, a, ao, bo)  # (128, 256) x (128, 256)


@pytest.mark.cuda
def test_device_sgb_on_the_card_matches_host(cuda_device):
    from repro_torch.core import sgb
    from repro_torch.hetero import make_dataset

    g = make_dataset("DBLP", scale=0.1)
    plan = sgb.make_plan(g, ["APA", "APTPA", "APVPA"])
    before = spgemm_bsr.launches
    dev = sgb.execute_plan(g, plan, backend="device", device=cuda_device)
    assert spgemm_bsr.launches == before + len(plan.steps)
    host = sgb.execute_plan(g, plan)
    assert dev.cost == host.cost and [c for _, c in dev.per_step] == [
        c for _, c in host.per_step]
    for t in ("APA", "APTPA", "APVPA"):
        assert np.array_equal(dev.graphs[t].src, host.graphs[t].src)
        assert np.array_equal(dev.graphs[t].dst, host.graphs[t].dst)


# ----------------------------------------------------------------- K4 -----
# the grid of test_flash_attention_sweep (tests/test_kernels.py), plus
# smollm-135m's head layout with ragged S and T
FA_CASES = [
    (2, 4, 2, 128, 128, 64, True, None, None),
    (1, 8, 2, 100, 100, 64, True, None, 50.0),
    (1, 4, 4, 96, 224, 64, True, None, None),
    (2, 4, 2, 128, 128, 64, True, 64, None),
    (1, 2, 1, 64, 64, 128, False, None, None),
    (2, 9, 3, 300, 300, 64, True, None, None),
    (1, 9, 3, 70, 333, 64, True, 100, 30.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,t,dh,causal,window,cap", FA_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda_device, b, hq, hkv, s, t, dh,
                                              causal, window, cap, dtype):
    rng = np.random.default_rng(s * 1000 + t)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            cuda_device, dtype)

    q, k, v = rand(b, hq, s, dh), rand(b, hkv, t, dh), rand(b, hkv, t, dh)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
    again = flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    want = attention_plain(q, k, v, causal=causal, window=window, softcap=cap)
    assert got.dtype == dtype and got.shape == q.shape
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=tol)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_flash_attention_wrapper_checks_operands(cuda_device):
    q = torch.zeros((1, 4, 8, 64), device=cuda_device)
    k = torch.zeros((1, 2, 8, 64), device=cuda_device)
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), k)
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError, match="one device"):
        flash_attention(q, k.cpu(), k)
    with pytest.raises(ValueError, match="head dims"):  # above the padded route's 256
        wide = torch.zeros((1, 2, 8, 288), device=cuda_device)
        flash_attention(torch.zeros((1, 4, 8, 288), device=cuda_device), wide, wide)
    with pytest.raises(ValueError, match="k's B, Hkv and T"):
        flash_attention(q, k, torch.zeros((1, 2, 9, 64), device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3), k)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(torch.zeros((1, 3, 8, 64), device=cuda_device), k, k)


# the bf16 kernel's 128-row query tiles and 128-key tiles: S = T one past a
# tile, one short of two and ragged at 1000, at both head dims; S < T with
# windows whose edge falls mid-tile; and B * Hq large enough for several
# waves of CTAs on 132 SMs
FA_TILE_CASES = [
    (1, 2, 1, 129, 129, 64, True, None, None),
    (1, 2, 1, 129, 129, 128, True, None, None),
    (1, 2, 1, 255, 255, 64, True, None, None),
    (1, 2, 1, 255, 255, 128, True, None, None),
    (1, 3, 1, 1000, 1000, 64, True, None, None),
    (1, 3, 1, 1000, 1000, 128, True, None, None),
    (1, 4, 2, 200, 700, 64, True, 100, None),
    (1, 4, 2, 200, 700, 128, True, 100, None),
    (1, 4, 2, 300, 650, 64, False, 190, 20.0),
    (8, 32, 8, 512, 512, 64, True, None, None),
    (4, 24, 8, 1024, 1024, 128, True, None, None),
]


def _rand_cuda(rng, shape, device, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,t,dh,causal,window,cap", FA_TILE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_tile_edges(cuda_device, b, hq, hkv, s, t, dh, causal,
                                           window, cap, dtype):
    rng = np.random.default_rng(b * 100000 + s * 10 + dh)
    q = _rand_cuda(rng, (b, hq, s, dh), cuda_device, dtype)
    k = _rand_cuda(rng, (b, hkv, t, dh), cuda_device, dtype)
    v = _rand_cuda(rng, (b, hkv, t, dh), cuda_device, dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
    again = flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    want = attention_plain(q, k, v, causal=causal, window=window, softcap=cap)
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=tol)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_reads_strided_views(cuda_device, dh, dtype):
    """q, k, v as (B, S, H, Dh) tensors seen as (B, H, S, Dh), as the LM's
    attention makes them: the kernel reads them as they are, gives the
    output q's layout, and matches the contiguous copies bit for bit."""
    rng = np.random.default_rng(dh)
    b, hq, hkv, s = 2, 6, 2, 300
    q = _rand_cuda(rng, (b, s, hq, dh), cuda_device, dtype).transpose(1, 2)
    k = _rand_cuda(rng, (b, s, hkv, dh), cuda_device, dtype).transpose(1, 2)
    v = _rand_cuda(rng, (b, s, hkv, dh), cuda_device, dtype).transpose(1, 2)
    assert not q.is_contiguous()
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert got.stride() == q.stride()
    assert torch.equal(got, want)


# head dim 256 (gemma2-2b; 64-key tiles in the bf16 kernel): causal, window,
# softcap, both together, S < T, ragged S and T, a window edge one key past
# a tile, non-causal, and gemma2's head layout over several waves of CTAs
FA_DH256_CASES = [
    (1, 2, 1, 128, 128, 256, True, None, None),
    (1, 8, 4, 300, 300, 256, True, 100, None),
    (1, 8, 4, 200, 200, 256, True, None, 50.0),
    (1, 8, 4, 333, 333, 256, True, 65, 50.0),
    (1, 4, 2, 96, 224, 256, True, None, None),
    (1, 2, 1, 70, 333, 256, True, 100, 30.0),
    (1, 3, 1, 129, 129, 256, True, None, None),
    (1, 2, 2, 130, 190, 256, False, 70, None),
    (2, 8, 4, 1024, 1024, 256, True, 512, 50.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,t,dh,causal,window,cap", FA_DH256_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_head_dim_256(cuda_device, b, hq, hkv, s, t, dh, causal,
                                             window, cap, dtype):
    rng = np.random.default_rng(b * 100000 + s * 10 + t)
    q = _rand_cuda(rng, (b, hq, s, dh), cuda_device, dtype)
    k = _rand_cuda(rng, (b, hkv, t, dh), cuda_device, dtype)
    v = _rand_cuda(rng, (b, hkv, t, dh), cuda_device, dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
    again = flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    want = attention_plain(q, k, v, causal=causal, window=window, softcap=cap)
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=tol)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128, 256])
def test_flash_attention_kernel_info(cuda_device, dh):
    """The bf16 kernel launches at 168 registers a thread (384 threads;
    setmaxnreg then moves them to the consumers), with Q and two K/V stages
    in dynamic shared memory under the 227 KB a block may take, and the key
    tile that the tile-plan mirror reads from the source."""
    info = kernel_info(dh)
    bk = 64 if dh == 256 else 128
    assert info["block_k"] == bk
    assert info["threads"] == 384
    assert info["registers"] <= 168
    assert info["shared_bytes"] >= 2 * dh * (128 + 4 * bk)
    assert info["shared_bytes"] <= 232448
    print(f"K4 bf16 head dim {dh}: {info}")


@pytest.mark.cuda
def test_flash_attention_wrapper_checks_layout_and_scale(cuda_device):
    """The bf16 kernel's tensor maps need 16-byte strides and addresses, and
    its softmax a positive scale."""
    base = torch.zeros((1, 2, 16, 72), device=cuda_device, dtype=torch.bfloat16)
    k = torch.zeros((1, 1, 16, 64), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention(base[..., 1:65], k, k)  # 2-byte offset
    odd = torch.zeros((1, 2, 16 * 68), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16 bytes"):  # rows 68 elements apart
        flash_attention(odd.view(1, 2, 16, 68)[..., :64], k, k)
    with pytest.raises(ValueError, match="positive scale"):
        flash_attention(base[..., :64], k, k, scale=-0.125)
    # float32 reads any stride
    qf = torch.zeros((1, 2, 16, 65), device=cuda_device)[..., 1:]
    out = flash_attention(qf, k.float(), k.float())
    assert out.shape == (1, 2, 16, 64)


# Head-dim pairs the kernel does not take in their dtype, so the padded
# route: in float32 hubert-xlarge's 80 (non-causal and causal) and MLA's q/k
# at 96 with v at 64 (minicpm3-4b), at head dim 128 (bf16 runs them natively:
# FA_NATIVE_CASES); in bf16 a reduced config's 16 (to 64), 112 (to 128), a
# DeepSeek-V2-sized MLA pair (192, 128) (to 256) and 32 (to 64); in both a
# reduced MLA's (48, 32) (to 64)
FA_PADDED_CASES = [
    (torch.float32, 2, 4, 4, 200, 200, 80, 80, False),
    (torch.float32, 1, 3, 3, 129, 129, 80, 80, True),
    (torch.float32, 2, 4, 4, 200, 200, 96, 64, True),
    (torch.float32, 1, 5, 5, 70, 333, 96, 64, True),
    (torch.float32, 1, 2, 1, 100, 100, 48, 32, False),
    (torch.bfloat16, 2, 4, 4, 200, 200, 16, 16, False),
    (torch.bfloat16, 1, 3, 3, 129, 129, 112, 112, True),
    (torch.bfloat16, 2, 4, 4, 200, 200, 192, 128, True),
    (torch.bfloat16, 1, 5, 5, 70, 333, 32, 32, True),
    (torch.bfloat16, 1, 2, 1, 100, 100, 48, 32, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,hq,hkv,s,t,dqk,dv,causal", FA_PADDED_CASES)
def test_flash_attention_kernel_padded_head_dims(cuda_device, b, hq, hkv, s, t, dqk, dv,
                                                 causal, dtype):
    """One K4 launch a call, at the padded head dim (the pair is not one the
    kernel takes in this dtype), at the true scale, the output at v's head
    dim; against the unpadded float32 plain version."""
    assert fa.kernel_pair(dqk, dv, dtype) != (dqk, dv)
    rng = np.random.default_rng(s * 7 + dqk)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            cuda_device, dtype)

    q, k, v = rand(b, hq, s, dqk), rand(b, hkv, t, dqk), rand(b, hkv, t, dv)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert got.shape == (b, hq, s, dv) and got.dtype == dtype
    want = attention_plain(q.float(), k.float(), v.float(), causal=causal)
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(got.float().cpu().numpy(), want.cpu().numpy(), atol=tol)
    assert torch.equal(got, again)


# K4's native (Dqk, Dv) pairs beyond 64, 128 and 256: hubert-xlarge's 80
# non-causal and causal, MLA's q/k 96 with v 64 causal and not; with GQA,
# ragged S and T (S < T, S > T) and a query tile cut short
FA_NATIVE_CASES = [
    (2, 4, 4, 200, 200, 80, 80, False),
    (1, 3, 3, 129, 129, 80, 80, True),
    (1, 8, 2, 300, 300, 80, 80, True),
    (1, 4, 2, 70, 333, 80, 80, True),
    (1, 4, 4, 300, 190, 80, 80, False),
    (2, 4, 4, 200, 200, 96, 64, True),
    (1, 5, 5, 70, 333, 96, 64, True),
    (1, 8, 2, 257, 257, 96, 64, True),
    (1, 4, 4, 300, 190, 96, 64, False),
    (4, 16, 16, 1024, 1024, 80, 80, False),
    (2, 40, 40, 1024, 1024, 96, 64, True),
]


def _no_padding(monkeypatch) -> list:
    """A spy on ``pad_head_dims``: the list of its calls."""
    calls = []
    pad = fa.pad_head_dims

    def spy(*args):
        calls.append(args)
        return pad(*args)

    monkeypatch.setattr(fa, "pad_head_dims", spy)
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,t,dqk,dv,causal", FA_NATIVE_CASES)
def test_flash_attention_kernel_native_head_dims(cuda_device, monkeypatch, b, hq, hkv, s, t,
                                                 dqk, dv, causal):
    """bf16 K4 at a native (Dqk, Dv) pair: one launch a call and no padding
    copy, within 3e-2 of the float32 plain version, bitwise repeatable."""
    rng = np.random.default_rng(s * 11 + t + dqk)
    q = _rand_cuda(rng, (b, hq, s, dqk), cuda_device, torch.bfloat16)
    k = _rand_cuda(rng, (b, hkv, t, dqk), cuda_device, torch.bfloat16)
    v = _rand_cuda(rng, (b, hkv, t, dv), cuda_device, torch.bfloat16)
    pads = _no_padding(monkeypatch)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2 and not pads
    assert got.shape == (b, hq, s, dv) and got.dtype == torch.bfloat16
    want = attention_plain(q.float(), k.float(), v.float(), causal=causal)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.cpu().numpy(), atol=3e-2)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dqk,dv", [(80, 80), (96, 64)])
def test_flash_attention_native_head_dims_read_only_the_true_columns(cuda_device, monkeypatch,
                                                                     dqk, dv):
    """q, k and v as the first Dqk / Dv columns of 128-wide buffers whose
    other columns hold noise: one launch, no copy, and the output bitwise
    that of the call on contiguous copies (the kernel's tensor maps stop at
    the true head dims)."""
    rng = np.random.default_rng(dqk + dv)
    b, hq, hkv, s = 2, 6, 2, 300
    qw = _rand_cuda(rng, (b, hq, s, 128), cuda_device, torch.bfloat16)
    kw = _rand_cuda(rng, (b, hkv, s, 128), cuda_device, torch.bfloat16)
    vw = _rand_cuda(rng, (b, hkv, s, 128), cuda_device, torch.bfloat16)
    q, k, v = qw[..., :dqk], kw[..., :dqk], vw[..., :dv]
    pads = _no_padding(monkeypatch)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2 and not pads
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dqk,dv", NATIVE_PAIRS)
def test_flash_attention_kernel_info_every_pair(cuda_device, dqk, dv):
    """Every bf16 instantiation launches at 168 registers a thread or fewer
    and fits its shared memory in a block's 227 KB; the pairs beyond (d, d)
    spill nothing (the square pairs keep what they had: 16 local bytes a
    thread at (128, 128), none at 64 and 256)."""
    info = kernel_info(dqk, dv)
    assert info["threads"] == 384 and info["registers"] <= 168
    if (dqk, dv) not in ((64, 64), (128, 128), (256, 256)):
        assert info["local_bytes"] == 0
    assert info["block_k"] == (64 if dqk == 256 else 128)
    assert info["shared_bytes"] <= 232448
    print(f"K4 bf16 (q/k {dqk}, v {dv}): {info}")


@pytest.mark.cuda
def test_moe_layer_on_the_card_matches_its_plain_version(cuda_device):
    """olmoe-1b-7b's routing (64 experts, top 8, groups of 512) at a narrow
    width: the bf16 einsum dispatch on the card against the float32
    per-token plain version, and the routing equal to the CPU's."""
    from repro_torch.models import layers

    rng = np.random.default_rng(40)
    d, e, k, f, t = 128, 64, 8, 64, 2048

    def rand(shape, scale, dtype=torch.bfloat16):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(
            cuda_device, dtype)

    p = {"w_router": rand((d, e), 0.5, torch.float32), "w_gate": rand((e, d, f), 0.1),
         "w_up": rand((e, d, f), 0.1), "w_down": rand((e, f, d), 0.1)}
    x = rand((2, t // 2, d), 1.0)
    got, terms = layers.moe_ffn(p, x, num_experts=e, top_k=k, group_size=512)
    aux = layers.moe_aux(*terms)
    route = layers.moe_route(p, x.reshape(-1, 512, d), num_experts=e, top_k=k)
    plain = layers.moe_plain(p, x, route)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), plain.cpu().numpy(), atol=3e-2)
    assert float(aux) > 0
    cpu = layers.moe_route({kk: vv.cpu() for kk, vv in p.items()}, x.cpu().reshape(-1, 512, d),
                           num_experts=e, top_k=k)
    assert (route["idx"].cpu() == cpu["idx"]).float().mean() > 0.99


# ----------------------------------------------------------------- K5 -----
SSD_CASES = [  # b, s, h, g, p, n, chunk
    (2, 128, 4, 2, 32, 16, 32),
    (1, 256, 2, 1, 64, 64, 64),
    (1, 64, 8, 8, 16, 16, 16),
    (2, 128, 4, 1, 16, 16, 64),
    (1, 512, 4, 1, 64, 128, 128),
    # extents that are multiples of 4 but not of the 32-wide tiles, the
    # smallest of each, and mamba2-370m's layout at B = 2, S = 1024
    (1, 48, 3, 1, 12, 20, 12),
    (2, 40, 4, 2, 4, 36, 20),
    (1, 16, 2, 2, 4, 4, 4),
    (1, 384, 6, 3, 60, 124, 96),
    (2, 1024, 32, 1, 64, 128, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,g,p,n,chunk", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda_device, b, s, h, g, p, n, chunk):
    rng = np.random.default_rng(s + h * 10 + n)

    def dev(a):
        return torch.from_numpy(a.astype(np.float32)).to(cuda_device)

    x = dev(rng.standard_normal((b, s, h, p)))
    a = dev(-np.abs(rng.standard_normal((b, s, h))) * 0.1)
    bc = dev(rng.standard_normal((b, s, g, n)) * 0.3)
    cc = dev(rng.standard_normal((b, s, g, n)) * 0.3)
    before = ssd_scan.launches
    got = ssd_scan(x, a, bc, cc, chunk=chunk)
    again = ssd_scan(x, a, bc, cc, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 2
    want = ssd_plain(x, a, bc, cc, chunk=chunk)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=3e-4)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_ssd_wrapper_checks_operands(cuda_device):
    x = torch.zeros((1, 64, 4, 16), device=cuda_device)
    a = torch.zeros((1, 64, 4), device=cuda_device)
    bc = torch.zeros((1, 64, 1, 16), device=cuda_device)
    with pytest.raises(TypeError):
        ssd_scan(x.bfloat16(), a, bc, bc, chunk=32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan(x, a, bc, bc, chunk=48)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(x, a, bc, bc, chunk=64 + 64 + 64)
    with pytest.raises(ValueError, match="one device"):
        ssd_scan(x, a.cpu(), bc, bc, chunk=32)
    with pytest.raises(ValueError):
        ssd_scan(x, a, torch.zeros((1, 64, 3, 16), device=cuda_device),
                 torch.zeros((1, 64, 3, 16), device=cuda_device), chunk=32)


def _to_card(tree, device):
    if isinstance(tree, dict):
        return {k: _to_card(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_card(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
def test_reduced_gemma2_prefill_at_head_dim_256_on_the_card(cuda_device):
    """gemma2-2b cut in depth and width but at its own head dim (256), 8 / 4
    heads, window, softcaps and q scale: the card forward launches K4 once a
    layer and matches the CPU forward."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import LM

    full = get_config("gemma2-2b")
    cfg = dataclasses.replace(reduced(full), head_dim=full.head_dim,
                              num_heads=full.num_heads, num_kv_heads=full.num_kv_heads,
                              d_model=256, sliding_window=96)
    assert cfg.head_dim == 256 and cfg.attn_softcap and cfg.q_scale
    cpu = LM(cfg, device="cpu")
    params = cpu.init(0)
    card = LM(cfg, device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 200)))
    k4 = flash_attention.launches
    got, _, _ = card.forward(_to_card(params, cuda_device), toks.to(cuda_device))
    torch.cuda.synchronize()
    assert flash_attention.launches - k4 == cfg.num_layers
    want, _, _ = cpu.forward(params, toks)
    v = cfg.vocab_size
    np.testing.assert_allclose(got.cpu().float().numpy()[..., :v],
                               want.float().numpy()[..., :v], atol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,s", [("smollm-135m", 64), ("mamba2-370m", 128)])
def test_reduced_lm_prefill_on_the_card(cuda_device, arch, s):
    """Reduced depth and width, but K4's head dim (64): the card forward
    launches K4 or K5 once per layer and matches the CPU forward."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import LM

    cfg = dataclasses.replace(reduced(get_config(arch)), head_dim=64)
    cpu = LM(cfg, device="cpu")
    params = cpu.init(0)
    card = LM(cfg, device=cuda_device)
    params_card = _to_card(params, cuda_device)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, s)))
    k4, k5 = flash_attention.launches, ssd_scan.launches
    got, _, _ = card.forward(params_card, toks.to(cuda_device))
    torch.cuda.synchronize()
    if arch == "smollm-135m":
        assert flash_attention.launches - k4 == cfg.num_layers
    else:
        assert ssd_scan.launches - k5 == cfg.num_layers
    want, _, _ = cpu.forward(params, toks)
    v = cfg.vocab_size
    np.testing.assert_allclose(got.cpu().numpy()[..., :v], want.numpy()[..., :v], atol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "minicpm3-4b"])
def test_reduced_moe_and_mla_prefill_on_the_card(cuda_device, arch):
    """Reduced olmoe-1b-7b (MoE; head dim 16, K4's padded route) and
    minicpm3-4b at its own MLA head dims (q/k 96, v 64): the card forward
    launches K4 once a layer and matches the CPU forward within 5e-2, its
    aux within 2e-3 relative."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import LM

    cfg = reduced(get_config(arch))
    if cfg.mla_kv_rank:
        cfg = dataclasses.replace(cfg, head_dim=96, mla_rope_dim=32)
    cpu = LM(cfg, device="cpu")
    params = cpu.init(0)
    card = LM(cfg, device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 128)))
    k4 = flash_attention.launches
    got, _, aux = card.forward(_to_card(params, cuda_device), toks.to(cuda_device))
    torch.cuda.synchronize()
    assert flash_attention.launches - k4 == cfg.num_layers
    want, _, aux_cpu = cpu.forward(params, toks)
    v = cfg.vocab_size
    np.testing.assert_allclose(got.cpu().numpy()[..., :v], want.numpy()[..., :v], atol=5e-2)
    if cfg.num_experts:
        assert abs(float(aux) - float(aux_cpu)) <= 2e-3 * float(aux_cpu)


# ------------------------------------------- NA backward (K1 transposed) --
def _grad_case(rng, ns, nd, ne, d, device):
    src, dst = _edges(rng, ns, nd, ne)
    pk = pack_edge_blocks(src, dst, ns, nd)
    h = rng.standard_normal((ns, d)).astype(np.float32)
    r = rng.standard_normal((nd, d)).astype(np.float32)
    w = np.zeros(pk.src_local.shape, np.float32)
    blk, slot = pk.edge_map()
    w[blk, slot] = rng.random(blk.size).astype(np.float32)
    logits = (rng.standard_normal(ne) * 2).astype(np.float32)
    ra = rng.standard_normal(ne).astype(np.float32)
    return pk, {k: torch.from_numpy(v) for k, v in
                dict(h=h, r=r, w=w, logits=logits, ra=ra).items()}


def _na_grads(pk, x, device):
    """Grads of both NA Functions on ``device``: seg_sum_na wrt (h, w),
    na_attention_packed wrt (logits, h) with an alpha cotangent."""
    from repro_torch.kernels.ops import na_attention_packed

    t = {k: v.to(device) for k, v in x.items()}
    h = t["h"].clone().requires_grad_(True)
    w = t["w"].clone().requires_grad_(True)
    (seg_sum_na(pk, h, w) * t["r"]).sum().backward()
    lg = t["logits"].clone().requires_grad_(True)
    h2 = t["h"].clone().requires_grad_(True)
    out, alpha = na_attention_packed(pk, lg, h2)
    ((out * t["r"]).sum() + (alpha * t["ra"]).sum()).backward()
    return [g.grad.cpu() for g in (h, w, lg, h2)]


@pytest.mark.cuda
@pytest.mark.parametrize("ns,nd,ne,d", SHAPES + [(3000, 2000, 60000, 64)])
def test_na_backward_on_the_card_matches_the_cpu_backward(cuda_device, ns, nd, ne, d):
    """Both Functions' card backward (K1 over the source-major view, K1 at
    width 1 for the softmax's row sums) against their CPU backward, and two
    card backward passes bit for bit."""
    pk, x = _grad_case(np.random.default_rng(ne + 1), ns, nd, ne, d, cuda_device)
    before = seg_sum_na.launches
    card = _na_grads(pk, x, cuda_device)
    torch.cuda.synchronize()
    # forward + transposed for seg_sum_na; forward, width-1 row sums and
    # transposed for the attention
    assert seg_sum_na.launches == before + 5
    again = _na_grads(pk, x, cuda_device)
    cpu = _na_grads(pk, x, "cpu")
    for a, b, c in zip(card, again, cpu):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-4, rtol=1e-4)
    assert float(card[0].abs().max()) > 0 and float(card[2].abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["skew", "revisit"])
def test_k1_over_the_src_view_matches_plain_scatter(cuda_device, case):
    """K1 launched over the source-major view against ``index_add_``'s
    plain scatter in float64 on seeded inputs, with a hub source of 5,000 out-edges (heavy row
    slices) and empty source rows."""
    from repro_torch.kernels.seg_sum import (seg_sum_transposed,
                                             seg_sum_transposed_plain)

    rng = np.random.default_rng(3)
    if case == "skew":
        s, d = _edges(rng, 2000, 900, 4000)
        s = np.concatenate([s, np.full(5000, 7)])
        d = np.concatenate([d, rng.integers(0, 900, 5000)])
        o = np.lexsort((s, d))
        src, dst, ns, nd = s[o], d[o], 2600, 900
    else:
        src, dst, ns, nd = _revisit()
    pk = pack_edge_blocks(src, dst, ns, nd)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    g = torch.randn(nd, 48, device=cuda_device, generator=gen)
    w = torch.rand(pk.src_local.shape, device=cuda_device, generator=gen)
    before = seg_sum_na.launches
    got = seg_sum_transposed(pk, g, w)
    again = seg_sum_transposed(pk, g, w)
    assert seg_sum_na.launches == before + 2
    # the oracle sums in float64: index_add_ adds with float atomics on the
    # card, so a float32 oracle's own rounding varies from run to run
    want = seg_sum_transposed_plain(pk, g.double(), w.double())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4, rtol=1e-4)
    assert torch.equal(got, again)
    empty = torch.from_numpy(np.diff(pk.src_edges().row_ptr) == 0).to(cuda_device)
    assert (got[empty] == 0).all()
    with pytest.raises(ValueError, match=">= "):
        seg_sum_transposed(pk, g[:-1], w)


@pytest.mark.cuda
def test_reduced_fit_on_the_card(cuda_device):
    """A reduced ``fit`` on the card (ACM at scale 0.15, rgat, hidden 16,
    2 layers): finite losses that fall, with K1 and K2 launched."""
    from repro_torch.api import ExecutorSpec, Session, device_features
    from repro_torch.core.hgnn import HGNNConfig
    from repro_torch.hetero import make_dataset
    from repro_torch.train import propagated_feature_labels, semi_supervised_masks

    g = make_dataset("ACM", scale=0.15)
    targets = ["APA", "PAP", "PSP"]
    c = Session(ExecutorSpec(na_executor="banded")).compile(
        g, targets, HGNNConfig(model="rgat", hidden=16, num_layers=2))
    n = c.num_target
    labels = propagated_feature_labels(c.frontend.semantic, targets, g.features, n)
    masks = semi_supervised_masks(n, seed=0)
    feats = device_features(g, "cuda")
    k1, k2 = seg_sum_na.launches, edge_softmax_stats.launches
    out = c.fit(feats, labels, masks, epochs=12, lr=1e-2)
    assert seg_sum_na.launches > k1 and edge_softmax_stats.launches > k2
    assert np.isfinite(out["losses"]).all() and out["losses"][-1] < out["losses"][0]


# ------------------------------------------------------- subset forwards ---
def _dep_pair(cuda_device, ds, targets, target_type, model, executor="banded"):
    from repro_torch.api import ExecutorSpec, Session, device_features
    from repro_torch.core.hgnn import HGNNConfig
    from repro_torch.hetero import make_dataset

    g = make_dataset(ds, scale=0.3)
    cfg = HGNNConfig(model=model, hidden=32, num_layers=2, target_type=target_type)
    card = Session(ExecutorSpec(na_executor=executor)).compile(g, targets, cfg)
    cpu = Session(ExecutorSpec(na_executor=executor, device="cpu")).compile(g, targets, cfg)
    return (card, cpu, card.init(0), cpu.init(0), device_features(g, cuda_device),
            device_features(g, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("ds,targets,tt", [("ACM", ["APA", "PAP", "PSP"], "P"),
                                           ("IMDB", ["AMA", "MAM", "MDM"], "M")])
def test_seg_sum_kernel_over_a_dependency_slice(cuda_device, ds, targets, tt):
    """K1 over each semantic graph's sliced packing of one extraction,
    unit and random weights, against ``seg_sum_plain`` on the same slice;
    one launch a call, rows no slice block reaches written as zeros."""
    card, *_ = _dep_pair(cuda_device, ds, targets, tt, "rgcn")
    rng = np.random.default_rng(5)
    ids = np.unique(rng.integers(0, card.num_target, size=13))
    sub = card.dependency_subset(ids)
    for dg in sub.arrays["graphs"]:
        pk = dg["packed"]
        h = torch.from_numpy(rng.standard_normal((pk.num_src, 64)).astype(np.float32)).to(
            cuda_device)
        w = torch.from_numpy(rng.random(pk.src_local.shape).astype(np.float32)).to(cuda_device)
        for weights in (None, w):
            before = seg_sum_na.launches
            got = seg_sum_na(pk, h, weights)
            torch.cuda.synchronize()
            assert seg_sum_na.launches == before + 1
            want = seg_sum_plain(pk, h, weights)
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       atol=1e-4, rtol=1e-4)
        empty = torch.from_numpy(np.diff(pk.row_edges().row_ptr) == 0).to(cuda_device)
        assert (got[empty] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("executor", ["banded", "jnp"])
@pytest.mark.parametrize("model", ["rgcn", "rgat", "shgn"])
def test_subset_forwards_on_the_card(cuda_device, executor, model):
    """Dependency rows on the card within 1e-4 of the CPU's and of the
    card's full forward; head rows bitwise equal to the card's forward
    rows on both executors (each repeats bit for bit on the card: the
    segment-sum executor's ``segment_sum`` adds each segment in a fixed
    order); a banded dependency forward launches K1 once per layer and
    semantic graph."""
    card, cpu, p_card, p_cpu, f_card, f_cpu = _dep_pair(
        cuda_device, "IMDB", ["AMA", "MAM", "MDM"], "M", model, executor)
    full = card.forward(p_card, f_card)
    ids = np.unique(np.random.default_rng(2).integers(0, card.num_target, size=13))
    card.dependency_subset(ids)  # extraction and upload outside the count
    card._fusion_betas(p_card, f_card)
    before = seg_sum_na.launches
    dep = card.forward_subset(p_card, f_card, ids, mode="dependency")
    torch.cuda.synchronize()
    launched = seg_sum_na.launches - before
    assert launched == (card.cfg.num_layers * len(card.graphs) if executor == "banded" else 0)
    want = cpu.forward_subset(p_cpu, f_cpu, ids, mode="dependency")
    np.testing.assert_allclose(dep.cpu().numpy(), want.numpy(), atol=1e-4)
    np.testing.assert_allclose(dep.cpu().numpy(), full[torch.from_numpy(ids).to(cuda_device)]
                               .cpu().numpy(), atol=1e-4)
    head = card.forward_subset(p_card, f_card, ids)
    rows = full[torch.from_numpy(ids).to(cuda_device)]
    assert torch.equal(head, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["rgcn", "rgat"])
def test_jnp_executor_repeats_bitwise_on_the_card(cuda_device, model):
    """The segment-sum executor (``na_executor="jnp"``) on full-width ACM:
    two forwards, and two ``loss`` gradients (every parameter and feature
    leaf), bitwise equal on the card; the logits within 1e-4 of the CPU's."""
    from repro_torch.api import ExecutorSpec, Session, device_features
    from repro_torch.core.hgnn import HGNNConfig
    from repro_torch.hetero import make_dataset
    from repro_torch.train import semi_supervised_masks, tree_leaves, value_and_grad

    graph = make_dataset("ACM", seed=0, scale=1.0)
    cfg = HGNNConfig(model=model, hidden=64, num_layers=3, sf_att_dim=64, target_type="P")
    targets = ["APA", "PAP", "PSP"]
    card = Session(ExecutorSpec(na_executor="jnp")).compile(graph, targets, cfg)
    params, feats = card.init(0), device_features(graph, cuda_device)
    a, b = card.forward(params, feats), card.forward(params, feats)
    assert torch.equal(a, b)
    cpu = Session(ExecutorSpec(na_executor="jnp", device="cpu")).compile(graph, targets, cfg)
    want = cpu.forward(cpu.init(0), device_features(graph, "cpu"))
    np.testing.assert_allclose(a.cpu().numpy(), want.numpy(), atol=1e-4)
    n = card.num_target
    labels = torch.from_numpy(np.random.default_rng(0).integers(0, 3, n)).to(cuda_device)
    mask = semi_supervised_masks(n, seed=0, device=cuda_device)["train"]
    runs = [value_and_grad(lambda p, f: card.loss(p, f, labels, mask), params, feats)
            for _ in range(2)]
    (l1, g1), (l2, g2) = runs
    assert torch.equal(l1, l2)
    leaves = list(zip(tree_leaves(g1), tree_leaves(g2)))
    assert leaves and all(torch.equal(x, y) for x, y in leaves)


# ----------------------------------------------------------- graph deltas ---
def _spliced_case(rng, kind):
    """A scheduled stream packed on the card (its views built and uploaded
    first), an edited stream, and the splice of the two: ``(old, spliced,
    fresh)``, ``fresh`` a cold packing of the edited stream."""
    from repro_torch.kernels.seg_sum import splice_pack_edge_blocks

    ns, nd, ne = 3000, 2000, 60000
    src, dst = _edges(rng, ns, nd, ne)
    old = pack_edge_blocks(src, dst, ns, nd)
    old.device_blocked("cuda"), old.device_src_edges("cuda")
    i = int(rng.integers(0, ne // 2))
    j = i if kind == "insert" else i + 500
    k = 0 if kind == "remove" else 400
    ns2, nd2 = (ns + 300, nd + 200) if kind == "grow" else (ns, nd)
    new_src = np.concatenate([src[:i], rng.integers(0, ns2, k), src[j:]])
    new_dst = np.concatenate([dst[:i], rng.integers(0, nd2, k), dst[j:]])
    spliced, _, _ = splice_pack_edge_blocks(new_src, new_dst, src, dst, old, ns2, nd2)
    return old, spliced, pack_edge_blocks(new_src, new_dst, ns2, nd2)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["insert", "remove", "grow"])
def test_na_kernels_over_a_spliced_packing(cuda_device, kind):
    """K1 and K2 over a spliced packing (the old packing's views already on
    the card) against their plain versions, and bitwise equal to the same
    kernels over a cold packing of the edited stream."""
    rng = np.random.default_rng(17)
    old, spliced, fresh = _spliced_case(rng, kind)
    assert "_device" not in vars(spliced)
    h = torch.from_numpy(rng.standard_normal((spliced.num_src, 64)).astype(np.float32)).to(
        cuda_device)
    w = torch.from_numpy(rng.random(spliced.src_local.shape).astype(np.float32)).to(
        cuda_device)
    for weights in (None, w):
        got = seg_sum_na(spliced, h, weights)
        want = seg_sum_plain(spliced, h, weights)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)
        assert got.shape == (spliced.num_dst, 64)
        assert torch.equal(got, seg_sum_na(fresh, h, weights))
    lb = torch.from_numpy((rng.standard_normal(spliced.src_local.shape) * 3)
                          .astype(np.float32)).to(cuda_device)
    m, s = edge_softmax_stats(spliced, lb)
    m_p, s_p = softmax_stats_plain(spliced, lb)
    np.testing.assert_allclose(m.cpu().numpy(), m_p.cpu().numpy(), rtol=1e-6)
    np.testing.assert_allclose(s.cpu().numpy(), s_p.cpu().numpy(), atol=1e-5, rtol=1e-5)
    m_f, s_f = edge_softmax_stats(fresh, lb)
    assert torch.equal(m, m_f) and torch.equal(s, s_f)


def _delta_sessions(cuda_device, model, kind):
    """A card session compiled on ACM (scale 0.3), warmed by one forward,
    then moved by ``compile_delta`` to a seeded delta; and a cold card
    compile of the mutated graph."""
    from repro_torch.api import ExecutorSpec, Session, device_features
    from repro_torch.core.hgnn import HGNNConfig
    from repro_torch.hetero import GraphDelta, make_dataset

    g = make_dataset("ACM", scale=0.3)
    rng = np.random.default_rng(4)
    if kind == "insert":
        ps = g.relations["PS"]
        delta = GraphDelta.insert("PS", rng.integers(0, ps.num_src, 16),
                                  rng.integers(0, ps.num_dst, 16))
    else:  # vertex growth
        n_p = g.num_vertices["P"]
        delta = GraphDelta(add_edges={"PA": (np.repeat(np.arange(n_p, n_p + 8), 3),
                                             rng.integers(0, g.num_vertices["A"], 24))},
                           add_vertices={"P": 8})
    targets = ["APA", "PAP", "PSP"]
    cfg = HGNNConfig(model=model, hidden=32, num_layers=2, target_type="P")
    sess = Session(ExecutorSpec(na_executor="banded"))
    c1 = sess.compile(g, targets, cfg)
    params = c1.init(0)
    c1.forward(params, device_features(g, cuda_device))
    c2, g2, dres = sess.compile_delta(c1, g, delta)
    cold = Session(ExecutorSpec(na_executor="banded")).compile(g2, targets, cfg)
    return c1, c2, cold, g2, params, dres


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["rgcn", "rgat"])
@pytest.mark.parametrize("kind", ["insert", "grow"])
def test_compile_delta_forward_on_the_card_is_bitwise_a_cold_compile(cuda_device, model, kind):
    """The successor's forward on the card, over spliced packings whose
    predecessors' views were uploaded, is bitwise a cold compile's and
    launches K1 and K2 as often; untouched packings are the same objects."""
    from repro_torch.api import device_features
    from repro_torch.kernels.edge_softmax import edge_softmax_stats as k2

    c1, c2, cold, g2, params, dres = _delta_sessions(cuda_device, model, kind)
    assert dres.spliced
    for a, b, old in zip(c2.graphs, cold.graphs, c1.graphs):
        for f in ("src_local", "dst_local", "band", "dst_tile", "count"):
            np.testing.assert_array_equal(getattr(a.packed, f), getattr(b.packed, f))
        assert (a.packed is old.packed) == (a.metapath not in dres.touched)
    feats = device_features(g2, cuda_device)
    counts = []
    for c in (c2, cold):
        k1_0, k2_0 = seg_sum_na.launches, k2.launches
        out = c.forward(params, feats)
        torch.cuda.synchronize()
        counts.append((seg_sum_na.launches - k1_0, k2.launches - k2_0))
        if c is c2:
            got = out
    assert counts[0] == counts[1] == (6, 0 if model == "rgcn" else 6)
    assert torch.equal(got, out)
    assert got.shape == (g2.num_vertices["P"], 3) and bool(torch.isfinite(got).all())


@pytest.mark.cuda
def test_swap_graph_with_vertex_growth_serves_on_the_card(cuda_device):
    """A tenant served on the card takes a delta that grows P: features are
    re-uploaded to the card, the new vertices' rows are served, and rows
    are bitwise a cold card compile's."""
    from repro_torch.api import ExecutorSpec, Session, device_features
    from repro_torch.core.hgnn import HGNNConfig
    from repro_torch.hetero import GraphDelta, make_dataset
    from repro_torch.serve import HGNNRequest, HGNNServeEngine

    g = make_dataset("ACM", scale=0.3)
    targets = ["APA", "PAP", "PSP"]
    cfg = HGNNConfig(model="rgat", hidden=32, num_layers=2, target_type="P")
    eng = HGNNServeEngine(spec=ExecutorSpec(na_executor="banded"))
    acm = eng.register("acm", g, targets, cfg, seed=0)
    n_p = g.num_vertices["P"]
    rng = np.random.default_rng(9)
    delta = GraphDelta(add_edges={"PA": (np.repeat(np.arange(n_p, n_p + 8), 3),
                                         rng.integers(0, g.num_vertices["A"], 24))},
                       add_vertices={"P": 8})
    ids = np.array([0, n_p + 7, n_p + 1])
    eng.run()
    try:
        before = acm.submit(HGNNRequest(0, nodes=np.array([0, 1])))
        assert acm.swap_graph(delta, warm=True) == 2
        after = acm.submit(HGNNRequest(1, nodes=ids))
        whole = acm.submit(HGNNRequest(2))
        rows = after.result(timeout=120)
        full = whole.result(timeout=120)
        assert before.result(timeout=120).params_version == 1
    finally:
        eng.stop()
    assert rows.params_version == full.params_version == 2
    feats = eng._registered["acm"].features
    assert feats["P"].device.type == "cuda" and feats["P"].shape[0] == n_p + 8
    g2 = g.apply_delta(delta)
    cold = Session(ExecutorSpec(na_executor="banded")).compile(g2, targets, cfg)
    want = cold.forward(eng._registered["acm"].params,
                        device_features(g2, cuda_device)).cpu().numpy()
    np.testing.assert_array_equal(full.logits, want)
    np.testing.assert_array_equal(rows.logits, want[ids])


# ------------------------------------------------------- sharded execution ---
def _merged_streams(g, targets, target_type, mode, ranks=4):
    """Each non-empty rank's merged stream of a ``ranks``-rank plan over
    ``g``'s banded batches (their views not yet built)."""
    from repro_torch.api import ExecutorSpec, Session
    from repro_torch.core.hgnn import HGNNConfig
    from repro_torch.distributed import build_shard_plan
    from repro_torch.distributed.hgnn import _build_geometry, merged_stream

    cfg = HGNNConfig(model="rgcn", hidden=32, num_layers=2, target_type=target_type)
    graphs = Session(ExecutorSpec(na_executor="banded")).compile(g, targets, cfg).graphs
    plan = build_shard_plan(graphs, ranks, mode)
    geom = _build_geometry(graphs)
    return [pk for pk, _ in (merged_stream(graphs, plan, geom, r) for r in range(ranks))
            if pk is not None]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["relation", "edge_block"])
def test_na_kernels_over_a_merged_rank_stream(cuda_device, mode):
    """K1 (unit and random weights) and K2 over each rank's merged stream
    of a 4-rank plan on ACM against their plain versions, bitwise
    repeatable."""
    from repro_torch.hetero import make_dataset

    streams = _merged_streams(make_dataset("ACM", scale=0.3), ["APA", "PAP", "PSP"], "P",
                              mode)
    rng = np.random.default_rng(21)
    for pk in streams:
        h = torch.from_numpy(rng.standard_normal((pk.num_src, 64)).astype(np.float32)).to(
            cuda_device)
        w = torch.from_numpy(rng.random(pk.src_local.shape).astype(np.float32)).to(cuda_device)
        for weights in (None, w):
            got, again = seg_sum_na(pk, h, weights), seg_sum_na(pk, h, weights)
            want = seg_sum_plain(pk, h, weights)
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       atol=1e-4, rtol=1e-4)
            assert torch.equal(got, again)
        logits = torch.from_numpy(3 * rng.standard_normal(pk.src_local.shape)
                                  .astype(np.float32)).to(cuda_device)
        (m, s), (m2, s2) = edge_softmax_stats(pk, logits), edge_softmax_stats(pk, logits)
        mr, sr = softmax_stats_plain(pk, logits)
        assert torch.equal(m, mr) and torch.equal(m, m2) and torch.equal(s, s2)
        np.testing.assert_allclose(s.cpu().numpy(), sr.cpu().numpy(), rtol=1e-5)


@pytest.mark.cuda
def test_k2_over_a_dependency_slice(cuda_device):
    """K2 over each semantic graph's sliced packing of one extraction
    against ``softmax_stats_plain``: ``m`` bitwise, ``s`` within 1e-5."""
    card, *_ = _dep_pair(cuda_device, "IMDB", ["AMA", "MAM", "MDM"], "M", "rgat")
    rng = np.random.default_rng(6)
    sub = card.dependency_subset(np.unique(rng.integers(0, card.num_target, size=13)))
    for dg in sub.arrays["graphs"]:
        pk = dg["packed"]
        logits = torch.from_numpy(3 * rng.standard_normal(pk.src_local.shape)
                                  .astype(np.float32)).to(cuda_device)
        before = edge_softmax_stats.launches
        m, s = edge_softmax_stats(pk, logits)
        torch.cuda.synchronize()
        assert edge_softmax_stats.launches == before + 1
        mr, sr = softmax_stats_plain(pk, logits)
        assert torch.equal(m, mr)
        np.testing.assert_allclose(s.cpu().numpy(), sr.cpu().numpy(), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["rgat", "shgn"])
def test_dependency_rows_repeat_bitwise_on_the_card(cuda_device, model):
    """Two dependency forwards on the card are bitwise equal (K2 and K1,
    no float atomics), launching K2 and K1 once per layer and semantic
    graph, within 1e-4 of the CPU's rows; the same check fires on a copy
    of the second with one entry nudged by one ulp."""
    card, cpu, p_card, p_cpu, f_card, f_cpu = _dep_pair(
        cuda_device, "IMDB", ["AMA", "MAM", "MDM"], "M", model)
    ids = np.unique(np.random.default_rng(3).integers(0, card.num_target, size=13))
    card.dependency_subset(ids)
    card._fusion_betas(p_card, f_card)
    k1, k2 = seg_sum_na.launches, edge_softmax_stats.launches
    first = card.forward_subset(p_card, f_card, ids, mode="dependency")
    torch.cuda.synchronize()
    per = card.cfg.num_layers * len(card.graphs)
    assert (seg_sum_na.launches - k1, edge_softmax_stats.launches - k2) == (per, per)
    second = card.forward_subset(p_card, f_card, ids, mode="dependency")
    assert torch.equal(first, second)
    nudged = second.clone()
    nudged[0, 0] = torch.nextafter(nudged[0, 0], torch.tensor(np.inf, device=cuda_device))
    assert not torch.equal(first, nudged)
    want = cpu.forward_subset(p_cpu, f_cpu, ids, mode="dependency")
    np.testing.assert_allclose(first.cpu().numpy(), want.numpy(), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["relation", "edge_block"])
@pytest.mark.parametrize("model", ["rgcn", "rgat", "shgn"])
def test_sharded_forward_on_the_card(cuda_device, monkeypatch, mode, model):
    """A 4-rank sharded forward with every rank on the one card: bitwise
    the single-device card forward, within 1e-4 of the CPU sharded run,
    repeatable, K1 (and K2 for attention) launched once per non-empty rank
    and layer, ``shard_traces`` 1."""
    from repro_torch.api import ExecutorSpec, Session, device_features
    from repro_torch.core.hgnn import HGNNConfig
    from repro_torch.hetero import make_dataset

    monkeypatch.setenv("REPRO_TORCH_VIRTUAL_DEVICES", "4")
    g = make_dataset("ACM", scale=0.3)
    targets = ["APA", "PAP", "PSP"]
    cfg = HGNNConfig(model=model, hidden=32, num_layers=2, target_type="P")
    single = Session(ExecutorSpec(na_executor="banded")).compile(g, targets, cfg)
    sharded = Session(ExecutorSpec(na_executor="banded", shard=mode)).compile(
        g, targets, cfg)
    cpu = Session(ExecutorSpec(na_executor="banded", shard=mode, device="cpu")).compile(
        g, targets, cfg)
    params, feats = sharded.init(0), device_features(g, cuda_device)
    want = single.forward(params, feats)
    sharded.forward(params, feats)
    k1, k2 = seg_sum_na.launches, edge_softmax_stats.launches
    got = sharded.forward(params, feats)
    torch.cuda.synchronize()
    busy = int((sharded.shard_plan.device_block_counts() > 0).sum())
    per = busy * cfg.num_layers
    assert (seg_sum_na.launches - k1, edge_softmax_stats.launches - k2) == (
        per, 0 if model == "rgcn" else per)
    assert torch.equal(got, want) and torch.equal(got, sharded.forward(params, feats))
    assert sharded.shard_traces == 1
    ref = cpu.forward(cpu.init(0), device_features(g, "cpu"))
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=1e-4)


# ------------------------------------------------------------ LM training --
def _attention_grads_f32(q, k, v, g, **kw):
    qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    out = attention_plain(qf, kf, vf, **kw)
    return torch.autograd.grad(out, (qf, kf, vf), g.float())


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(b=2, hq=6, hkv=2, s=384, dh=64, dv=64, causal=True),
    dict(b=1, hq=4, hkv=4, s=300, dh=128, dv=128, causal=True, window=100, softcap=30.0),
    dict(b=1, hq=4, hkv=2, s=256, dh=256, dv=256, causal=True, window=64),
    dict(b=2, hq=4, hkv=4, s=256, dh=80, dv=80, causal=False),
    dict(b=2, hq=4, hkv=4, s=256, dh=96, dv=64, causal=True),
])
def test_flash_attention_function_gradients_on_the_card(cuda_device, case, monkeypatch):
    """K4's autograd Function on the card: one K4 launch forward, and dq,
    dk, dv (bf16, float32 autograd of the plain version recomputed, query
    tiled here) within 4e-3 of float32 autograd of ``attention_plain`` at
    each tensor's largest entry, at head dims 64, 128, 256 and the padded
    route's 80 and 96 / 64."""
    from repro_torch.kernels import flash_attention as fa

    monkeypatch.setattr(fa, "VJP_TILE_ELEMS", case["s"] * 64)  # tiles of 64 rows
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    b, hq, hkv, s = case["b"], case["hq"], case["hkv"], case["s"]
    kw = {k: case[k] for k in ("causal", "window", "softcap") if k in case}

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)

    q, k, v = rnd(b, hq, s, case["dh"]), rnd(b, hkv, s, case["dh"]), rnd(b, hkv, s, case["dv"])
    g = rnd(b, hq, s, case["dv"])
    for t in (q, k, v):
        t.requires_grad_(True)
    before = fa.flash_attention.launches
    out = fa.FlashAttention.apply(q, k, v, kw.get("causal", True), kw.get("window"),
                                  kw.get("softcap"), None)
    assert fa.flash_attention.launches == before + 1
    got = torch.autograd.grad(out, (q, k, v), g)
    want = _attention_grads_f32(q, k, v, g, **kw)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        assert float((a.float() - w).abs().max()) <= 4e-3 * float(w.abs().max())


@pytest.mark.cuda
def test_ssd_function_gradients_on_the_card(cuda_device):
    """K5's autograd Function: one K5 launch forward, the gradients within
    1e-4 of float32 autograd of ``ssd_plain`` at each one's largest entry."""
    from repro_torch.kernels.ssd_scan import SSDScan

    gen = torch.Generator(device=cuda_device).manual_seed(6)
    shapes = ((2, 256, 8, 32), (2, 256, 8), (2, 256, 2, 64), (2, 256, 2, 64))
    x, a, bc, cc = (torch.randn(s, generator=gen, device=cuda_device) for s in shapes)
    a = -a.abs() * 0.1
    gy = torch.randn(shapes[0], generator=gen, device=cuda_device)
    ins = [t.requires_grad_(True) for t in (x, a, bc * 0.3, cc * 0.3)]
    before = ssd_scan.launches
    got = torch.autograd.grad(SSDScan.apply(*ins, 64), ins, gy)
    assert ssd_scan.launches == before + 1
    live = [t.detach().requires_grad_(True) for t in ins]
    want = torch.autograd.grad(ssd_plain(*live, chunk=64), live, gy)
    for u, w in zip(got, want):
        assert float((u - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["smollm-135m", "mamba2-370m", "granite-moe-1b-a400m"])
def test_lm_train_step_on_the_card_matches_the_cpu(cuda_device, name):
    """One reduced train step (remat full) on the card against the CPU from
    the same state and batch: the loss within 2e-3, every gradient leaf
    within 5e-2 of its largest entry (MoE-fed leaves: of the model's), K4
    and K5 launched twice a layer (forward and recomputed forward)."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.models.lm import LM
    from repro_torch.train import SyntheticTokens, tree_leaves, tree_map, value_and_grad
    from repro_torch.train.train_step import build_train_step, init_train_state

    cfg = configs.reduced(configs.get_config(name))
    tok, tgt = (torch.from_numpy(a) for a in
                SyntheticTokens(cfg.vocab_size, 128, 2).host_batch(0))
    state = init_train_state(LM(cfg, device="cpu", remat="full"), 0)
    out = {}
    for dev in ("cpu", cuda_device):
        model = LM(cfg, device=dev, remat="full")
        st = tree_map(lambda t: t.to(dev), state)
        k4_0, k5_0 = k4.launches, ssd_scan.launches
        loss, (grads,) = value_and_grad(lambda p: model.loss(p, tok.to(dev), tgt.to(dev)),
                                        st.params)
        out[str(dev)] = (loss, grads, k4.launches - k4_0, ssd_scan.launches - k5_0)
        from repro_torch.launch.mesh import make_debug_mesh

        step, _ = build_train_step(model, make_debug_mesh(1, 1, device=dev), 2)
        new, m = step(st, tok.to(dev), tgt.to(dev))
        assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(new.params))
    (l_c, g_c, _, _), (l_d, g_d, n4, n5) = out["cpu"], out[str(cuda_device)]
    attn = sum(m in ("attn", "local", "mla") for m, _ in cfg.block_pattern) * cfg.num_groups
    ssm = sum(m == "ssm" for m, _ in cfg.block_pattern) * cfg.num_groups
    assert (n4, n5) == (2 * attn, 2 * ssm)
    assert abs(float(l_c) - float(l_d)) <= 2e-3
    moe = {i for i, (_, f) in enumerate(cfg.block_pattern) if f == "moe"}
    model_max = max(float(x.float().abs().max()) for x in tree_leaves(g_c))
    for pos, (bc_, bd) in enumerate(zip(g_c["blocks"], g_d["blocks"])):
        for key in bc_:
            for a, b in zip(tree_leaves(bc_[key]), tree_leaves(bd[key])):
                scale = model_max if pos in moe and key in ("ffn", "ln2") else \
                    float(a.float().abs().max())
                assert float((b.cpu().float() - a.float()).abs().max()) <= 5e-2 * max(scale, 1e-30)


@pytest.mark.cuda
def test_lm_train_step_repeats_bitwise_on_the_card(cuda_device, monkeypatch):
    """Two steps from one state and batch under deterministic algorithms
    (a fixed cuBLAS workspace) are bitwise equal."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.lm import LM
    from repro_torch.train import SyntheticTokens, tree_leaves
    from repro_torch.train.train_step import build_train_step, init_train_state

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = configs.reduced(configs.get_config("granite-moe-1b-a400m"))
    model = LM(cfg, device=cuda_device, remat="full")
    state = init_train_state(model, 0)
    step, _ = build_train_step(model, make_debug_mesh(1, 1, device="cuda"), 4, microbatches=2)
    tok, tgt = (torch.from_numpy(a).to(cuda_device) for a in
                SyntheticTokens(cfg.vocab_size, 128, 4).host_batch(0))
    torch.use_deterministic_algorithms(True)
    try:
        a, ma = step(state, tok, tgt)
        b, mb = step(state, tok, tgt)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(ma["loss"], mb["loss"])
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["smollm-135m", "granite-moe-1b-a400m"])
def test_data_parallel_step_on_two_ranks_of_the_card_matches_the_cpu(cuda_device, name):
    """A reduced train step over a (2, 1) mesh of two ranks on the card
    against the one-rank step on the CPU from the same state and batch: the
    loss within 2e-3, first moments within 5e-2 of each leaf's largest entry
    (of the model's for MoE-fed leaves: routing may flip on the card), K4
    launched ranks x 2 a layer (forward and recomputed forward)."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh_for
    from repro_torch.models.lm import LM
    from repro_torch.train import SyntheticTokens, tree_leaves, tree_map
    from repro_torch.train._lm_pspecs import data_pspec
    from repro_torch.train.train_step import build_train_step, init_train_state

    cfg = configs.reduced(configs.get_config(name))
    data = SyntheticTokens(cfg.vocab_size, 128, 4)
    state = init_train_state(LM(cfg, device="cpu", remat="full"), 0)
    one, m1 = build_train_step(LM(cfg, device="cpu", remat="full"),
                               make_debug_mesh(1, 1, device="cpu"), 4)[0](
        state, *(torch.from_numpy(a) for a in data.host_batch(0)))
    mesh = make_mesh_for([cuda_device, cuda_device], shard_axes=("data", "model"),
                         shape=(2, 1))
    fn, _ = build_train_step(LM(cfg, device=cuda_device, remat="full"), mesh, 4)
    k4_0 = k4.launches
    dp, m2 = fn(tree_map(lambda t: t.to(cuda_device), state),
                data.sharded_batch(0, mesh, data_pspec(mesh, 4)))
    attn = sum(m in ("attn", "local", "mla") for m, _ in cfg.block_pattern) * cfg.num_groups
    assert k4.launches - k4_0 == 2 * 2 * attn
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= 2e-3
    model_max = max(float(x.abs().max()) for x in tree_leaves(one.opt.mu))
    for a, b in zip(tree_leaves(one.opt.mu), tree_leaves(dp.opt.mu)):
        scale = model_max if cfg.num_experts else float(a.abs().max())
        assert b.device.type == "cuda"
        assert float((b.cpu() - a).abs().max()) <= 5e-2 * max(scale, 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("native", [False, True])
def test_cp_zigzag_attention_on_sixteen_ranks_of_the_card(cuda_device, native):
    """``cp_zigzag_attention`` at p_shards=16 over a (1, 16) mesh of ranks
    on the card (B = 2, 9 / 3 heads of 64, S = 4096, bf16): 32 K4 launches,
    and against the float32 plain causal attention per element within
    4e-3 + 2^-6 |ref|, in both modes."""
    from repro_torch.kernels.cp_attention import cp_zigzag_attention, zigzag_positions
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.launch.mesh import make_mesh_for

    s = 4096
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((2, h, s, 64), generator=gen, device=cuda_device).to(torch.bfloat16)
               for h in (9, 3, 3))
    want = attention_plain(q.float(), k.float(), v.float(), causal=True)
    mesh = make_mesh_for([cuda_device] * 16, shard_axes=("data", "model"), shape=(1, 16))
    pos = torch.from_numpy(zigzag_positions(s, 16)).to(cuda_device)
    args = (q[:, :, pos], k[:, :, pos], v[:, :, pos]) if native else (q, k, v)
    k4_0 = k4.launches
    got = cp_zigzag_attention(*args, p_shards=16, pre_permuted=native, mesh=mesh)
    assert k4.launches - k4_0 == 32
    if native:
        got = got[:, :, torch.argsort(pos)]
    err = (got.float() - want).abs()
    assert bool((err <= 4e-3 + 2 ** -6 * want.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cp_zigzag", "cp_zigzag_native"])
def test_cp_train_step_on_the_card_matches_the_one_call_step(cuda_device, mode):
    """A reduced smollm-135m ``train_4k`` step (B = 2 as 2 x 1, S = 4096,
    remat full) on the card under a CP route over a (1, 16) mesh of ranks
    on the card, inside ``set_mesh`` (the remat recompute reads the route in
    the backward), against the step with one K4 call a layer: the loss
    within 1e-4, first moments within 2e-2 of each leaf's largest entry
    (bf16 leaves; ``chip_smoke.py``'s CP_TRAIN_LEAF_RTOL), K4 launched 2 x 2
    x 32 a layer; the native mode on tokens and targets permuted by
    ``zigzag_positions``."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.kernels.cp_attention import zigzag_positions
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.launch.mesh import make_mesh_for, set_mesh
    from repro_torch.models.lm import LM
    from repro_torch.train import SyntheticTokens, tree_leaves
    from repro_torch.train.train_step import build_train_step, init_train_state

    s = 4096
    cfg = configs.reduced(configs.get_config("smollm-135m"))
    model = LM(cfg, device=cuda_device, remat="full")
    state = init_train_state(model, 0)
    mesh = make_mesh_for([cuda_device] * 16, shard_axes=("data", "model"), shape=(1, 16))
    step, _ = build_train_step(model, mesh, 2, microbatches=2)
    tok, tgt = (torch.from_numpy(a).to(cuda_device) for a in
                SyntheticTokens(cfg.vocab_size, s, 2).host_batch(0))
    one, m1 = step(state, tok, tgt)
    if mode == "cp_zigzag_native":
        pos = torch.from_numpy(zigzag_positions(s, 16)).to(cuda_device)
        tok, tgt = tok[:, pos], tgt[:, pos]
    impl = ops.ATTN_IMPL
    k4_0 = k4.launches
    with set_mesh(mesh):
        ops.ATTN_IMPL = mode
        try:
            cp, m2 = step(state, tok, tgt)
        finally:
            ops.ATTN_IMPL = impl
    assert k4.launches - k4_0 == 2 * 2 * 32 * cfg.num_layers
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-4
    for a, b in zip(tree_leaves(one.opt.mu), tree_leaves(cp.opt.mu)):
        assert float((b - a).abs().max()) <= 2e-2 * max(float(a.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["smollm-135m", "gemma2-2b", "minicpm3-4b"])
def test_chunk_filled_decode_matches_the_prefill_on_the_card(cuda_device, name):
    """Reduced models on the card, B = 2, S = 4096: the cache filled with
    the first 4,095 tokens in chunks of 512 through the cached forward (no
    K4 launch), then token 4,095 decoded, within 5e-2 of the K4 prefill's
    last logits of the same tokens."""
    from repro_torch import configs
    from repro_torch.models.lm import LM
    from repro_torch.train import SyntheticTokens

    s, chunk = 4096, 512
    cfg = configs.reduced(configs.get_config(name))
    model = LM(cfg, device=cuda_device)
    params = model.init(0)
    tok = torch.from_numpy(SyntheticTokens(cfg.vocab_size, s, 2).host_batch(0)[0]).to(
        cuda_device)
    cache = model.init_cache(2, s)
    k4_0 = fa.flash_attention.launches
    for i in range(0, s - 1, chunk):
        model.forward(params, tok[:, i:min(i + chunk, s - 1)], cache=cache, cache_pos=i)
    dec = model.forward(params, tok[:, s - 1:], cache=cache, cache_pos=s - 1)[0]
    assert fa.flash_attention.launches == k4_0
    pre = model.forward(params, tok, last_only=True)[0]
    v = cfg.vocab_size
    assert float((dec - pre)[..., :v].abs().max()) <= 5e-2


# The shortest sequence at 32 heads whose data pass byte 2^31: one query tile
# (and one SSD chunk) of 128 rows beyond 262,144, which puts q and K4's
# output, and K5's x, y and chunk-state scratch, past byte 2^31 at their end.
PAST_2_31 = 262_144 + 128


@pytest.mark.cuda
def test_k5_past_byte_2_31_matches_plain_on_sampled_heads_and_chunks(cuda_device):
    """K5 at B = 1, S = 262,272 (2,049 chunks of 128), 32 heads of 64, state
    128, one group: x and y (2.15 GB each) and the chunk states of the
    scratch (2.15 GB) end past byte 2^31 (head 31's from chunk 2,017 on).
    Heads 0, 16 and 31 against ``ssd_plain`` on those heads within 3e-4,
    over every chunk and over the last chunk alone; bitwise repeatable."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    b, s, h, p, n, chunk = 1, PAST_2_31, 32, 64, 128, 128
    x = torch.randn((b, s, h, p), generator=gen, device=cuda_device)
    a = -torch.rand((b, s, h), generator=gen, device=cuda_device) * 0.1
    bm = torch.randn((b, s, 1, n), generator=gen, device=cuda_device) * 0.3
    cm = torch.randn((b, s, 1, n), generator=gen, device=cuda_device) * 0.3
    assert x.numel() * 4 > 2 ** 31 and h * (s // chunk) * p * n * 4 > 2 ** 31
    before = ssd_scan.launches
    y = ssd_scan(x, a, bm, cm, chunk=chunk)
    again = ssd_scan(x, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 2 and torch.equal(y, again)
    heads = [0, 16, 31]
    want = ssd_plain(x[:, :, heads].contiguous(), a[:, :, heads].contiguous(), bm, cm,
                     chunk=chunk)
    err = (y[:, :, heads] - want).abs()
    assert float(err.max()) <= 3e-4
    assert float(err[:, -chunk:].max()) <= 3e-4 and float(want[:, -chunk:].abs().max()) > 0


# K4's bf16 output against its float32 plain version on a 128-row query
# tile, as chip_smoke.py gates it: per element |d| <= 4e-3 + 2^-6 |ref|, and
# per tile ||d|| / ||ref|| <= 1e-2.  Past 2^18 keys the softmax is nearly
# flat and an entry is about sqrt(e / T) = 3e-3, under the per-element
# floor, so there the tile's relative error is the gate: bf16 rounding reads
# about 2e-3 of it, a tile missing 1/16 of its keys about 0.25.
K4_ATOL, K4_RTOL, K4_TILE_RMS = 4e-3, 2 ** -6, 1e-2


def _k4_tile_passes(got, ref):
    d = got.float() - ref
    return (bool((d.abs() <= K4_ATOL + K4_RTOL * ref.abs()).all())
            and float(d.norm() / ref.norm()) <= K4_TILE_RMS)


@pytest.mark.cuda
def test_k4_past_byte_2_31_matches_plain_on_sampled_tiles(cuda_device):
    """K4 at B = 1, S = T = 262,272, 32 / 8 heads of 128, causal, bf16, q, k
    and v (B, S, H, Dh) buffers seen as (B, H, S, Dh), as jamba's attention
    layer gives them: q and the output (2.15 GB each) end past byte 2^31,
    their last query tile wholly.  The first, middle and last 128-row tiles
    of heads 0 and 31 against the float32 plain version (each tile over the
    keys up to its last row: exact for a causal call) per element and per
    tile (``_k4_tile_passes``); bitwise repeatable.  Planted faults the same
    gate must reject on the middle and last tiles: the tile zeroed, the rows
    of the other head of the same kv group, and the tile's output without
    1/16 of the keys it sees (from their middle)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    b, hq, hkv, s, dh = 1, 32, 8, PAST_2_31, 128

    def rand(heads):
        return torch.randn((b, s, heads, dh), generator=gen, device=cuda_device).to(
            torch.bfloat16).transpose(1, 2)

    q, k, v = rand(hq), rand(hkv), rand(hkv)
    assert q.numel() * 2 > 2 ** 31
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True)
    again = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2 and torch.equal(out, again)
    assert out.stride() == q.stride()
    g = hq // hkv
    for head, other in ((0, 1), (hq - 1, hq - 2)):
        kv = slice(head // g, head // g + 1)
        for first in (0, s // 2, s - 128):
            last = first + 128
            qt = q[:, head:head + 1, first:last].float()
            kt, vt = k[:, kv, :last].float(), v[:, kv, :last].float()
            want = attention_plain(qt, kt, vt, causal=True)
            assert _k4_tile_passes(out[:, head:head + 1, first:last], want), (head, first)
            if first == 0:
                continue
            # 1/16 of the keys every row of the tile sees, from their middle:
            # cut out, the causal limits (aligned to the last key) still hold
            span = (first + 1) // 16
            lo = (first + 1) // 2 - span // 2
            kd, vd = (torch.cat([x[:, :, :lo], x[:, :, lo + span:]], dim=2) for x in (kt, vt))
            faults = {"zeroed": torch.zeros_like(want),
                      "other head": out[:, other:other + 1, first:last],
                      "keys dropped": attention_plain(qt, kd, vd, causal=True)}
            for name, bad in faults.items():
                assert not _k4_tile_passes(bad, want), (head, first, name)


@pytest.mark.cuda
def test_examples_run_on_the_card(cuda_device):
    """``repro_torch.examples.quickstart`` at scale 0.2 on the card: K1 and
    K2 launch, the shgn logits are within 1e-4 of the same compile on the
    CPU, and every served response is bit for bit the rows of its
    version's compiled forward."""
    from repro_torch.api import ExecutorSpec, Session, device_features
    from repro_torch.examples import quickstart

    seg_sum_na.launches = edge_softmax_stats.launches = 0
    q = quickstart.main(["0.2"])
    assert seg_sum_na.launches > 0 and edge_softmax_stats.launches > 0
    cpu = Session(ExecutorSpec(planner="ctt", sgb_backend="host", device="cpu"))
    c_cpu = cpu.compile(q["graph"], quickstart.TARGETS, q["shgn"].cfg)
    want = c_cpu.forward(c_cpu.init(0), device_features(q["graph"], "cpu"))
    assert (q["logits"].cpu() - want).abs().max().item() <= 1e-4
    feats = device_features(q["graph"])
    g2 = q["graph"].apply_delta(q["delta"])
    forwards = {
        ("acm", 1): q["shgn"].forward(q["params"], feats),
        ("acm", 2): q["shgn"].forward(q["swapped_params"], feats),
        ("acm", 3): q["acm"].compiled.forward(q["swapped_params"], device_features(g2)),
        ("imdb", 1): q["imdb_tenant"].compiled.forward(q["imdb_tenant"].compiled.init(0),
                                                       device_features(q["imdb"])),
    }
    for r in q["responses"]:
        full = forwards[(r.graph, r.params_version)].cpu().numpy()
        rows = full if r.mode == "full" else full[: r.logits.shape[0]]
        assert np.array_equal(r.logits, rows), r.rid
