"""Port kernel parity for the LM path: the plain versions of K4 (flash
attention) and K5 (SSD scan) on the CPU against the JAX package's Pallas
kernels in interpret mode and its oracles (the CUDA kernels themselves are
held against the plain versions in ``test_torch_cuda.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

# PyTorch's CPU build can return a wrong result for the first vectorized
# float op of a fresh process (torch 2.13 CPU: exp off by up to 1.5e-4
# relative, about one process in 30); a throwaway call first keeps the
# comparisons below about the port (ROADMAP, queue 3).
torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as ref_oracles  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as ref_flash  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as ref_ssd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (attention_plain,  # noqa: E402
                                                 flash_attention)
from repro_torch.kernels.ssd_scan import ssd_plain, ssd_scan  # noqa: E402

# the grid of test_flash_attention_sweep (tests/test_kernels.py:83-90)
FA_CASES = [
    (2, 4, 2, 128, 128, 64, True, None, None),
    (1, 8, 2, 100, 100, 64, True, None, 50.0),
    (1, 4, 4, 96, 224, 64, True, None, None),
    (2, 4, 2, 128, 128, 64, True, 64, None),
    (1, 2, 1, 64, 64, 128, False, None, None),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _same_inputs(rng, dtype, *shapes):
    """Seeded numpy arrays as (jax, torch) pairs of one dtype (both round
    float32 to bfloat16 to nearest even, so the bits agree)."""
    jdt, tdt, _ = DTYPES[dtype]
    out = []
    for shape in shapes:
        a = rng.standard_normal(shape).astype(np.float32)
        out.append((jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)))
    return out


# ------------------------------------------------------------------- K4 ---
@pytest.mark.parametrize("b,hq,hkv,s,t,dh,causal,window,cap", FA_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_plain_matches_jax_kernel(b, hq, hkv, s, t, dh, causal, window,
                                            cap, dtype):
    rng = np.random.default_rng(s * 1000 + t + hq)
    (qj, qt), (kj, kt), (vj, vt) = _same_inputs(
        rng, dtype, (b, hq, s, dh), (b, hkv, t, dh), (b, hkv, t, dh))
    want = ref_flash(qj, kj, vj, causal=causal, window=window, softcap=cap,
                     bq=64, bk=64, interpret=True)
    before = flash_attention.launches
    got = flash_attention(qt, kt, vt, causal=causal, window=window, softcap=cap)
    assert flash_attention.launches == before  # the CPU runs the plain version
    assert got.dtype == DTYPES[dtype][1] and got.shape == (b, hq, s, dh)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol)
    # the ops entry takes any layout and gives the same
    via_ops = ops.attention(qt, kt.transpose(2, 3).contiguous().transpose(2, 3), vt,
                            causal=causal, window=window, softcap=cap)
    assert torch.equal(via_ops, got)


def test_attention_plain_rows_without_live_keys_are_zero():
    """Window 1 with S > T end-alignment leaves leading rows with no live
    key; the TPU kernel's / max(l, 1e-20) makes them 0, and so does the
    plain version (the softmax oracle would spread them uniformly)."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 2, 8, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 1, 4, 64)).astype(np.float32))
    out = attention_plain(q, k, k, causal=True)
    assert torch.all(out[:, :, :4] == 0)  # qpos -4..-1: no key at or before
    want = ref_flash(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                     jnp.asarray(k.numpy()), causal=True, bq=64, bk=64,
                     interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5)


# ------------------------------------------------------------------- K5 ---
SSD_CASES = [  # b, s, h, g, p, n, chunk
    (1, 64, 8, 8, 16, 16, 16),  # the fast case of test_ssd_sweep
    (2, 128, 4, 1, 16, 16, 64),  # mamba2's layout: one group, chunked
]


@pytest.mark.parametrize("b,s,h,g,p,n,chunk", SSD_CASES)
def test_ssd_plain_matches_jax_kernel_and_oracle(b, s, h, g, p, n, chunk):
    rng = np.random.default_rng(s + 10 * h + n)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a = (-np.abs(rng.standard_normal((b, s, h))) * 0.1).astype(np.float32)
    bc = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    cc = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    jx, ja, jb, jc = (jnp.asarray(v) for v in (x, a, bc, cc))
    kern = np.asarray(ref_ssd(jx, ja, jb, jc, chunk=chunk, interpret=True))
    oracle = np.asarray(ref_oracles.ssd_ref(jx, ja, jb, jc))
    tx, ta, tb, tc = (torch.from_numpy(v) for v in (x, a, bc, cc))
    before = ssd_scan.launches
    got = ssd_scan(tx, ta, tb, tc, chunk=chunk)
    assert ssd_scan.launches == before
    assert got.shape == (b, s, h, p) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), kern, atol=3e-4)
    np.testing.assert_allclose(got.numpy(), oracle, atol=3e-4)
    assert torch.equal(ops.ssd(tx, ta, tb, tc, chunk=chunk), got)
    assert torch.equal(ssd_plain(tx, ta, tb, tc, chunk=chunk), got)


def test_ssd_plain_rejects_a_ragged_sequence():
    x = torch.zeros((1, 48, 2, 4))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan(x, torch.zeros((1, 48, 2)), torch.zeros((1, 48, 1, 4)),
                 torch.zeros((1, 48, 1, 4)), chunk=32)


def test_wrappers_refuse_other_devices():
    q = torch.zeros((1, 1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q, q, q)
    x = torch.zeros((1, 4, 1, 4), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ssd_scan(x, torch.zeros((1, 4, 1), device="meta"), x, x, chunk=4)
