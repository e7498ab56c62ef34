"""Port MLA parity: ``repro_torch.models.layers.mla_attention`` (prefill
through ``ops.attention`` with q and k at the head dim and v at the nope
dim; absorbed decode over the latent cache) on the CPU against the JAX
package's ``mla_attention`` on ``backend="jnp"`` (its Pallas K4 takes one
head dim for q, k and v); K4's wrapper routes (native pairs launched as
they are, others through the padded route) and the padded route through
the plain version; reduced minicpm3-4b against the reference LM, and its
serving engine and command line."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# PyTorch's CPU build can return a wrong result for the first vectorized
# float op of a fresh process (torch 2.13 CPU: exp off by up to 1.5e-4
# relative, about one process in 30); a throwaway call first keeps the
# comparisons below about the port (ROADMAP, queue 3).
torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as ref_layers  # noqa: E402
from repro.serve.engine import Request as RefRequest  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import (HEAD_DIMS,  # noqa: E402
                                                 NATIVE_PAIRS, attention_plain,
                                                 pad_head_dims, padded_head_dim)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.serve.engine import Request  # noqa: E402
from test_torch_serve import (_assert_same_tokens, _engines,  # noqa: E402
                              _record_step_logits, _requests)
from torch_lm_parity import (LAYER_TOL, LOGIT_TOL, check_decode,  # noqa: E402
                             check_forward, check_init, check_init_cache,
                             check_params_cross, np32, pair, params_pair,
                             reduced_model)

# (d, heads, head dim, rope dim, kv rank): the reduced config's MLA and
# minicpm3-4b's head geometry (64 nope + 32 rope, v at 64) at a narrow width
MLA_CASES = {"reduced": (64, 4, 48, 16, 32), "minicpm3": (64, 4, 96, 32, 64)}
PAD_TOL = 1e-6  # float32: the padded route adds exact zeros


def _mla_setup(rng, case, s):
    d, h, hd, rope, rank = MLA_CASES[case]
    nope = hd - rope
    p_ref, p_port = params_pair(rng, {
        "wq": ((d, h * hd), 0.1), "w_dkv": ((d, rank), 0.1), "kv_norm": ((rank,), 1.0),
        "w_kr": ((d, rope), 0.1), "w_ukv": ((rank, h * 2 * nope), 0.1),
        "wo": ((h * nope, d), 0.1)}, bf16_keys=("wq", "w_dkv", "w_kr", "w_ukv", "wo"))
    xj, xt = pair(rng.standard_normal((2, s, d)).astype(np.float32), bf16=True)
    return p_ref, p_port, xj, xt, dict(num_heads=h, head_dim=hd, rope_dim=rope)


def _tables(pos, dim):
    return (ref_layers.rope_cos_sin(jnp.asarray(pos), dim),
            layers.rope_cos_sin(torch.from_numpy(pos), dim))


@pytest.mark.parametrize("case", sorted(MLA_CASES))
@pytest.mark.parametrize("causal", [True, False])
def test_mla_prefill_matches_reference(case, causal):
    rng = np.random.default_rng(20)
    p_ref, p_port, xj, xt, kw = _mla_setup(rng, case, 40)
    pos = np.arange(40)[None].repeat(2, 0)
    (cj, sj), (ct, st) = _tables(pos, kw["head_dim"])
    want, _ = ref_layers.mla_attention(p_ref, xj, cj, sj, causal=causal, backend="jnp", **kw)
    got, cache = layers.mla_attention(p_port, xt, ct, st, causal=causal, **kw)
    assert cache is None and got.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(got), np32(want), atol=LAYER_TOL)


@pytest.mark.parametrize("case", sorted(MLA_CASES))
@pytest.mark.parametrize("s,cache_pos", [(1, 5), (2, 15)])
def test_mla_absorbed_decode_matches_reference(case, s, cache_pos):
    """One or two new tokens into a 16-long latent cache; (2, 15) runs past
    the end, where the write start clamps to 14 as dynamic_update_slice's
    does.  The cache is updated in place and never holds expanded K or V."""
    rng = np.random.default_rng(21)
    p_ref, p_port, xj, xt, kw = _mla_setup(rng, case, s)
    rank, rope = MLA_CASES[case][4], kw["rope_dim"]
    ckv = rng.standard_normal((2, 16, rank)).astype(np.float32)
    kr = rng.standard_normal((2, 1, 16, rope)).astype(np.float32)
    cache_ref = {"c_kv": pair(ckv, True)[0], "k_r": pair(kr, True)[0]}
    cache_port = {"c_kv": pair(ckv, True)[1], "k_r": pair(kr, True)[1]}
    pos = (cache_pos + np.arange(s))[None].repeat(2, 0)
    (cj, sj), (ct, st) = _tables(pos, kw["head_dim"])
    want, new_ref = ref_layers.mla_attention(
        p_ref, xj, cj, sj, backend="jnp", cache=cache_ref, cache_pos=jnp.int32(cache_pos), **kw)
    got, new_port = layers.mla_attention(p_port, xt, ct, st, cache=cache_port,
                                         cache_pos=cache_pos, **kw)
    assert new_port["c_kv"] is cache_port["c_kv"] and new_port["k_r"] is cache_port["k_r"]
    assert sorted(new_port) == ["c_kv", "k_r"]
    np.testing.assert_allclose(np32(got), np32(want), atol=LAYER_TOL)
    for key in ("c_kv", "k_r"):
        np.testing.assert_allclose(np32(new_port[key]), np32(new_ref[key]), atol=LAYER_TOL)
    start = min(cache_pos, 16 - s)
    assert not np.array_equal(np32(new_port["c_kv"])[:, start:start + s],
                              ckv[:, start:start + s])
    assert np.array_equal(np32(new_port["c_kv"])[:, :start], np32(pair(ckv, True)[1])[:, :start])


def test_mla_decode_equals_its_own_prefill():
    """Absorbed decode over the latent and the expanded prefill compute one
    function: the last rows of a 12-token prefill against 12 decode steps."""
    rng = np.random.default_rng(22)
    _, p_port, _, xt, kw = _mla_setup(rng, "minicpm3", 12)
    pos = np.arange(12)[None].repeat(2, 0)
    ct, st = layers.rope_cos_sin(torch.from_numpy(pos), kw["head_dim"])
    full, _ = layers.mla_attention(p_port, xt, ct, st, **kw)
    rank, rope = MLA_CASES["minicpm3"][4], kw["rope_dim"]
    cache = {"c_kv": torch.zeros((2, 12, rank), dtype=torch.bfloat16),
             "k_r": torch.zeros((2, 1, 12, rope), dtype=torch.bfloat16)}
    for i in range(12):
        step, cache = layers.mla_attention(p_port, xt[:, i:i + 1], ct[:, i:i + 1],
                                           st[:, i:i + 1], cache=cache, cache_pos=i, **kw)
        np.testing.assert_allclose(np32(step)[:, 0], np32(full)[:, i], atol=LAYER_TOL)


# ------------------------------------------------------ K4's padded route ---
@pytest.mark.parametrize("dqk,dv", [(48, 32), (96, 64), (80, 80), (16, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_k4_padded_route_is_exact(dqk, dv, causal):
    """What K4's wrapper runs for a head dim the kernel does not take: q, k
    and v zero-padded to the next of HEAD_DIMS, the true scale Dqk ** -0.5,
    the output cut to Dv.  Through the float32 plain version it equals the
    unpadded plain version within 1e-6; the padded head dim's own scale
    would miss it by more than 1e-2 (the fault a wrapper that forgot the
    scale would make)."""
    rng = np.random.default_rng(dqk * 100 + dv)
    b, hq, hkv, s, t = 2, 4, 2, 40, 56

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, k, v = rand(b, hq, s, dqk), rand(b, hkv, t, dqk), rand(b, hkv, t, dv)
    want = attention_plain(q, k, v, causal=causal)
    assert want.shape == (b, hq, s, dv)
    qp, kp, vp, scale, got_dv = pad_head_dims(q, k, v)
    dp = padded_head_dim(dqk, dv)
    assert dp in HEAD_DIMS and dp >= max(dqk, dv) and got_dv == dv
    assert qp.shape[-1] == kp.shape[-1] == vp.shape[-1] == dp
    assert scale == dqk ** -0.5
    assert not qp[..., dqk:].any() and not vp[..., dv:].any()
    got = attention_plain(qp, kp, vp, causal=causal, scale=scale)[..., :dv]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=PAD_TOL)
    wrong = attention_plain(qp, kp, vp, causal=causal, scale=dp ** -0.5)[..., :dv]
    assert float((wrong - want).abs().max()) > 1e-2


# (q/k head dim, v head dim, dtype, launched as it is): every bf16 pair the
# kernel is instantiated at; the float32 kernel's square pairs; MLA and
# hubert in float32, a reduced config's 16 and pairs of no instantiation
# in bf16, all padded
ROUTE_CASES = [(dqk, dv, torch.bfloat16, True) for dqk, dv in NATIVE_PAIRS] + [
    (64, 64, torch.float32, True), (128, 128, torch.float32, True),
    (80, 80, torch.float32, False), (96, 64, torch.float32, False),
    (16, 16, torch.bfloat16, False), (48, 32, torch.bfloat16, False),
    (128, 64, torch.bfloat16, False), (64, 80, torch.bfloat16, False),
]


@pytest.mark.parametrize("dqk,dv,dtype,native", ROUTE_CASES)
@pytest.mark.parametrize("junk", [False, True])
def test_k4_wrapper_launches_native_pairs_as_they_are(monkeypatch, dqk, dv, dtype, native,
                                                      junk):
    """``flash_attention_cuda`` with the launch replaced by a recorder (the
    plain version into the output it was handed): a pair the kernel takes
    is launched once at its own head dims, with no ``pad_head_dims`` call
    and the scale ``Dqk ** -0.5``; any other is launched once at
    ``padded_head_dim`` after one ``pad_head_dims`` call, at the same
    scale, its output cut to ``Dv``.  With ``junk``, q, k and v are the
    first columns of buffers 64 columns wider, those columns noise: a
    native pair is launched on those views, uncopied."""
    rng = np.random.default_rng(dqk * 1000 + dv)
    b, hq, hkv, s, t = 2, 4, 2, 40, 56

    def rand(rows, d, heads):
        wide = rng.standard_normal((b, heads, rows, d + 64 * junk)).astype(np.float32)
        return torch.from_numpy(wide).to(dtype)[..., :d]

    q, k, v = rand(s, dqk, hq), rand(t, dqk, hkv), rand(t, dv, hkv)
    launched, pads = [], []
    pad = fa.pad_head_dims

    def launch(q, k, v, out, scale, causal, window, softcap):
        launched.append((q.shape[-1], k.shape[-1], v.shape[-1], out.shape[-1], scale,
                         q.data_ptr()))
        out.copy_(attention_plain(q, k, v, causal=causal, window=window, softcap=softcap,
                                  scale=scale))

    def spy(*args):
        pads.append(args)
        return pad(*args)

    monkeypatch.setattr(fa, "_fa_forward", launch)
    monkeypatch.setattr(fa, "pad_head_dims", spy)
    got = fa.flash_attention_cuda(q, k, v, causal=True)
    dp = padded_head_dim(dqk, dv)
    assert len(launched) == 1 and launched[0][4] == dqk ** -0.5
    if native:
        assert launched[0][:4] == (dqk, dqk, dv, dv) and not pads
        assert launched[0][5] == q.data_ptr()  # q itself, however strided
    else:
        assert launched[0][:4] == (dp, dp, dp, dp) and len(pads) == 1
    assert got.shape == (b, hq, s, dv) and got.dtype == dtype
    want = attention_plain(q.float(), k.float(), v.float(), causal=True)
    tol = 2 ** -7 if dtype == torch.bfloat16 else PAD_TOL  # one bf16 rounding of |out| < 2
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=tol)


def test_k4_padded_head_dim_bounds():
    assert [padded_head_dim(d, d) for d in (16, 64, 80, 96, 128, 200, 256)] == \
        [64, 64, 128, 128, 128, 256, 256]
    assert padded_head_dim(96, 64) == 128
    with pytest.raises(ValueError, match="head dims up to 256"):
        padded_head_dim(288, 64)


# ---------------------------------------------------------------- models ---
@pytest.fixture(scope="module")
def minicpm3():
    return reduced_model("minicpm3-4b", 64)


def test_mla_model_params_cross_bit_for_bit(minicpm3):
    check_params_cross(minicpm3)


def test_mla_model_forward_matches_reference(minicpm3):
    check_forward(minicpm3)


def test_mla_model_decode_matches_reference_and_its_own_forward(minicpm3):
    """Decode within LOGIT_TOL of the reference's decode, caches within
    LAYER_TOL, and of the port's own full causal forward (the reference's
    test_decode_matches_full_forward case)."""
    steps = check_decode(minicpm3)
    full, _, _ = minicpm3["port"].forward(minicpm3["pp"], **minicpm3["inputs"])
    v = minicpm3["cfg"].vocab_size
    errs = [float(np.abs(a - full.numpy()[:, i, :v]).max()) for i, a in enumerate(steps)]
    assert max(errs) < LOGIT_TOL, errs


def test_mla_model_init_keys_shapes_dtypes_and_scale():
    check_init("minicpm3-4b")


def test_mla_init_cache_matches_reference_layout():
    check_init_cache("minicpm3-4b")


def test_mla_serve_matches_reference_engine():
    """Reduced minicpm3-4b through both engines: the latent cache, written
    by the engine's decode-path prefill, ends equal too."""
    cfg, ref, port = _engines("minicpm3-4b", slots=2, max_len=32)
    steps = _record_step_logits(ref)
    done_ref = ref.run(_requests(RefRequest, cfg, 5, 4, 4, seed=0), max_steps=64)
    done_port = port.run(_requests(Request, cfg, 5, 4, 4, seed=0), max_steps=64)
    assert set(done_port) == {0, 1, 2, 3, 4}
    assert all(len(v) == 4 for v in done_port.values())
    _assert_same_tokens(done_ref, done_port, steps)
    for a, b in zip(jax.tree.leaves(ref.cache), jax.tree.leaves(port.cache)):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                   atol=LAYER_TOL)


def test_serve_cli_serves_an_mla_arch_on_the_cpu(capsys):
    serve_cli.main(["--arch", "minicpm3-4b", "--reduced", "--device", "cpu",
                    "--requests", "3", "--slots", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens" in out and "on cpu" in out


def test_mla_model_at_minicpm3_head_geometry():
    """The reduced config at minicpm3-4b's own head dims (96 = 64 nope + 32
    rope, v 64): the port's forward against the reference's."""
    from repro.configs import ARCHS, reduced
    from repro.models.lm import LM as RefLM
    from repro_torch import configs
    from repro_torch.models.lm import LM, lm_params_from_numpy

    geo = dict(head_dim=96, mla_rope_dim=32)
    cfg = dataclasses.replace(reduced(ARCHS["minicpm3-4b"]), **geo)
    ref = RefLM(cfg, backend="jnp")
    rp = ref.init(jax.random.key(0))
    port = LM(dataclasses.replace(configs.reduced(configs.get_config("minicpm3-4b")), **geo),
              device="cpu")
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    want, _, _ = ref.forward(rp, tokens=jnp.asarray(toks))
    got, _, _ = port.forward(pp, tokens=torch.from_numpy(toks))
    v = cfg.vocab_size
    np.testing.assert_allclose(got.numpy()[..., :v], np.asarray(want)[..., :v], atol=LOGIT_TOL)


def test_mla_prefill_at_k4_width_passes_the_true_scale(monkeypatch):
    """MLA hands ``ops.attention`` q and k at the true head dim (96), v at
    the nope dim (64) and the scale of the true head dim: a pair the bf16
    kernel takes as it is.  The padded route, which the float32 kernel and
    any pair the kernel does not take run (``pad_head_dims``, here forced
    onto the CPU at MLA's own operands), must keep that scale, not 128 **
    -0.5: it equals the unpadded prefill and the reference's."""
    from repro_torch.kernels import ops

    assert fa.kernel_pair(96, 64, torch.bfloat16) == (96, 64)
    assert fa.kernel_pair(96, 64, torch.float32) == (128, 128)
    assert fa.kernel_pair(48, 32, torch.bfloat16) == (padded_head_dim(48, 32),) * 2 == (64, 64)
    rng = np.random.default_rng(23)
    p_ref, p_port, xj, xt, kw = _mla_setup(rng, "minicpm3", 40)
    pos = np.arange(40)[None].repeat(2, 0)
    (cj, sj), (ct, st) = _tables(pos, kw["head_dim"])
    seen = []
    attention = ops.attention

    def spy(q, k, v, **call):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1], call.get("scale")))
        return attention(q, k, v, **call)

    monkeypatch.setattr(ops, "attention", spy)
    unpadded, _ = layers.mla_attention(p_port, xt, ct, st, **kw)
    assert seen == [(96, 96, 64, 96 ** -0.5)]

    def padded_route(q, k, v, **call):
        qp, kp, vp, true_scale, dv = pad_head_dims(q, k, v)
        assert true_scale == call["scale"]
        return spy(qp, kp, vp, **call)[..., :dv]

    monkeypatch.setattr(ops, "attention", padded_route)
    padded, _ = layers.mla_attention(p_port, xt, ct, st, **kw)
    assert seen[1:] == [(128, 128, 128, 96 ** -0.5)]
    np.testing.assert_allclose(np32(padded), np32(unpadded), atol=LAYER_TOL)
    want, _ = ref_layers.mla_attention(p_ref, xj, cj, sj, backend="jnp", **kw)
    np.testing.assert_allclose(np32(padded), np32(want), atol=LAYER_TOL)
    np.testing.assert_allclose(np32(unpadded), np32(want), atol=LAYER_TOL)
