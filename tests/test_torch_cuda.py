"""The hand-written CUDA kernels K1 and K2 against their plain PyTorch
versions, on a CUDA card.

Every test here needs the card (marker ``cuda``) and skips without one; on
the card run ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.  The
file imports no JAX, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.edge_softmax import (edge_softmax_stats,  # noqa: E402
                                              softmax_stats_plain)
from repro_torch.kernels.seg_sum import (pack_edge_blocks, seg_sum_na,  # noqa: E402
                                         seg_sum_plain)

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


@pytest.mark.cuda
def test_kernel_wrappers_check_operands(cuda_device):
    src, dst, ns, nd = _revisit()
    pk = pack_edge_blocks(src, dst, ns, nd)
    with pytest.raises(TypeError):
        seg_sum_na(pk, torch.zeros(ns, 4, dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError):
        seg_sum_na(pk, torch.zeros(ns - 1, 4, device=cuda_device))
    with pytest.raises(ValueError):
        edge_softmax_stats(pk, torch.zeros(1, 256, device=cuda_device))
