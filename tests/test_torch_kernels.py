"""Port kernel parity: the plain versions of K1 (banded seg-sum) and K2
(online softmax stats) on the CPU against the JAX package's Pallas kernels
in interpret mode (the CUDA kernels themselves are held against the plain
versions in ``test_torch_cuda.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

# PyTorch's CPU build can return a wrong result for the first vectorized
# float op of a fresh process (torch 2.13 CPU: exp off by up to 1.5e-4
# relative, about one process in 30); a throwaway call first keeps the
# comparisons below about the port (ROADMAP, queue 3).
torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402
from repro.kernels import seg_sum as ref_seg_sum  # noqa: E402
from repro.kernels.edge_softmax import block_logits  # noqa: E402
from repro.kernels.edge_softmax import \
    edge_softmax_stats as ref_stats  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.edge_softmax import (NEG, edge_softmax_ref,  # noqa: E402
                                              edge_softmax_stats)
from repro_torch.kernels.seg_sum import (pack_edge_blocks,  # noqa: E402
                                         seg_sum_na, seg_sum_na_ref)

SHAPES = [(64, 64, 200, 32), (300, 200, 1500, 64), (17, 5, 40, 16)]


def _edges(rng, ns, nd, ne):
    src = rng.integers(0, ns, ne)
    dst = rng.integers(0, nd, ne)
    o = np.lexsort((src, dst))
    return src[o], dst[o]


def _revisit():
    """Tile 0 -> tile 1 -> tile 0 again: dst 0 receives from both visits."""
    return np.array([0, 1, 700, 2]), np.array([0, 3, 130, 0]), 1024, 256


# ------------------------------------------------------- K1 plain vs JAX --
@pytest.mark.parametrize("ns,nd,ne,d", SHAPES)
@pytest.mark.parametrize("weighted", [False, True])
def test_seg_sum_plain_matches_jax_kernel(ns, nd, ne, d, weighted):
    rng = np.random.default_rng(ns * 7 + ne)
    src, dst = _edges(rng, ns, nd, ne)
    h = rng.standard_normal((ns, d)).astype(np.float32)
    pk = pack_edge_blocks(src, dst, ns, nd)
    pk_ref = ref_seg_sum.pack_edge_blocks(src, dst, ns, nd)
    w = None
    if weighted:  # random blocked weights; padding slots carry 0, as in
        # every blocked weight the reference builds (scatter_blocks fill)
        w = rng.random(pk.src_local.shape).astype(np.float32) * pk.valid_mask()
    want = ref_seg_sum.seg_sum_na(
        pk_ref, jnp.asarray(h), interpret=True,
        weights=None if w is None else jnp.asarray(w))
    got = seg_sum_na(pk, torch.from_numpy(h),
                     None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_seg_sum_plain_survives_nonconsecutive_revisit():
    src, dst, ns, nd = _revisit()
    h = np.random.default_rng(1).standard_normal((ns, 16)).astype(np.float32)
    pk = pack_edge_blocks(src, dst, ns, nd)
    want = ref_seg_sum.seg_sum_na(ref_seg_sum.pack_edge_blocks(src, dst, ns, nd),
                                  jnp.asarray(h), interpret=True)
    got = seg_sum_na(pk, torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # tiles no block touches (rows 256.. do not exist; tile 1 rows 131..)
    # are zero, and the revisited row 0 holds both visits' sum
    np.testing.assert_allclose(got[0].numpy(), h[0] + h[2], atol=1e-6)


def test_seg_sum_oracle_matches_jax_oracle():
    rng = np.random.default_rng(3)
    src, dst = _edges(rng, 120, 90, 700)
    h = rng.standard_normal((120, 8)).astype(np.float32)
    w = rng.random(700).astype(np.float32)
    want = ref_oracles.seg_sum_na_ref(src, dst, jnp.asarray(h), 90, weight=w)
    got = seg_sum_na_ref(torch.from_numpy(src), torch.from_numpy(dst),
                         torch.from_numpy(h), 90, weight=torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    pk = pack_edge_blocks(src, dst, 120, 90, weight=w)
    np.testing.assert_allclose(seg_sum_na(pk, torch.from_numpy(h)).numpy(),
                               got.numpy(), atol=1e-5)


# ------------------------------------------------- K2 + alpha plain vs JAX --
@pytest.mark.parametrize("ns,nd,ne", [(300, 200, 1500), (50, 600, 900)])
def test_softmax_stats_plain_matches_jax_kernel(ns, nd, ne):
    rng = np.random.default_rng(ne)
    src, dst = _edges(rng, ns, nd, ne)
    logits = (rng.standard_normal(ne) * 3).astype(np.float32)
    pk_ref = ref_seg_sum.pack_edge_blocks(src, dst, ns, nd)
    m_ref, s_ref = ref_stats(pk_ref, block_logits(pk_ref, logits), interpret=True)
    pk = pack_edge_blocks(src, dst, ns, nd)
    lb = pk.scatter_blocks(torch.from_numpy(logits), fill=NEG)
    m, s = edge_softmax_stats(pk, lb)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), rtol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-5, rtol=1e-5)
    untouched = np.bincount(dst, minlength=nd) == 0
    assert (m.numpy()[untouched] == NEG).all() and (s.numpy()[untouched] == 0).all()


@pytest.mark.parametrize("case", ["random", "revisit", "zero_weight"])
def test_attention_packed_matches_jax(case):
    rng = np.random.default_rng(5)
    w = None
    if case == "revisit":
        src, dst, ns, nd = _revisit()
    else:
        ns, nd, ne = (300, 150, 1200) if case == "random" else (200, 100, 600)
        src, dst = _edges(rng, ns, nd, ne)
        if case == "zero_weight":  # masked edges on valid slots
            w = rng.random(ne).astype(np.float32)
            w[::3] = 0.0
    logits = (rng.standard_normal(src.size) * 2).astype(np.float32)
    h = rng.standard_normal((ns, 16)).astype(np.float32)
    pk_ref = ref_seg_sum.pack_edge_blocks(src, dst, ns, nd, weight=w)
    out_ref, alpha_ref = ref_ops.na_attention_packed(
        pk_ref, logits, jnp.asarray(h), backend="interpret")
    pk = pack_edge_blocks(src, dst, ns, nd, weight=w)
    out, alpha = ops.na_attention_packed(pk, torch.from_numpy(logits),
                                         torch.from_numpy(h))
    np.testing.assert_allclose(alpha.numpy(), np.asarray(alpha_ref), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref)[:nd], atol=1e-4)
    # and both agree with the flat-edge oracles
    alpha_o = edge_softmax_ref(torch.from_numpy(logits), torch.from_numpy(dst), nd)
    np.testing.assert_allclose(alpha.numpy(), alpha_o.numpy(), atol=1e-5)
    want_o, _ = ref_ops.na_attention_aggregate(src, dst, logits, jnp.asarray(h),
                                               nd, backend="jnp")
    np.testing.assert_allclose(out.numpy(), np.asarray(want_o), atol=1e-4)


def test_edge_softmax_oracle_matches_jax_oracle():
    rng = np.random.default_rng(9)
    src, dst = _edges(rng, 40, 70, 300)
    logits = (rng.standard_normal(300) * 3).astype(np.float32)
    want = ref_oracles.edge_softmax_ref(jnp.asarray(logits), jnp.asarray(dst), 70)
    got = edge_softmax_ref(torch.from_numpy(logits), torch.from_numpy(dst), 70)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_na_aggregate_packs_on_demand_and_reuses_packing():
    rng = np.random.default_rng(2)
    src, dst = _edges(rng, 100, 80, 400)
    h = torch.from_numpy(rng.standard_normal((100, 8)).astype(np.float32))
    w = rng.random(400).astype(np.float32)
    fresh = ops.na_aggregate(src, dst, h, 80, weight=w)
    cached = ops.na_aggregate(src, dst, h, 80, weight=w,
                              packed=pack_edge_blocks(src, dst, 100, 80))
    want = seg_sum_na_ref(torch.from_numpy(src), torch.from_numpy(dst), h, 80,
                          weight=torch.from_numpy(w))
    np.testing.assert_allclose(fresh.numpy(), want.numpy(), atol=1e-5)
    np.testing.assert_allclose(cached.numpy(), fresh.numpy(), atol=1e-6)
    logits = torch.from_numpy(rng.standard_normal(400).astype(np.float32))
    out, alpha = ops.na_attention_aggregate(src, dst, logits, h, 80)
    np.testing.assert_allclose(
        alpha.numpy(), edge_softmax_ref(logits, torch.from_numpy(dst), 80).numpy(),
        atol=1e-5)


# ------------------------------------------------------- device routing --
def test_cpu_path_counts_no_launch():
    src, dst, ns, nd = _revisit()
    pk = pack_edge_blocks(src, dst, ns, nd)
    k1, k2 = seg_sum_na.launches, edge_softmax_stats.launches
    seg_sum_na(pk, torch.zeros(ns, 4))
    edge_softmax_stats(pk, torch.zeros(pk.src_local.shape))
    assert (seg_sum_na.launches, edge_softmax_stats.launches) == (k1, k2)


def test_wrappers_reject_other_devices():
    src, dst, ns, nd = _revisit()
    pk = pack_edge_blocks(src, dst, ns, nd)
    with pytest.raises(ValueError, match="cuda or cpu"):
        seg_sum_na(pk, torch.zeros(ns, 4, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        edge_softmax_stats(pk, torch.zeros(pk.src_local.shape, device="meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import cuda_build

    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build._nvcc()
