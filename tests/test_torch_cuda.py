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
from repro_torch.kernels.flash_attention import (attention_plain,  # noqa: E402
                                                 flash_attention, kernel_info)
from repro_torch.kernels.spgemm_bsr import (TILE,  # noqa: E402
                                            compose_padded_blocked,
                                            spgemm_bsr, spgemm_plain,
                                            tile_occupancy)
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
    (8, 24, 16, 0.0003)])
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
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                        k[..., :32].contiguous())
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
