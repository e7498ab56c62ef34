"""Port LM parity: ``repro_torch.configs``, ``models.layers`` and
``models.lm`` on the CPU (the plain versions of K4 and K5) against the JAX
package's LM zoo with its Pallas kernels in interpret mode.  Reference
parameters cross over with ``lm_params_from_numpy``; the port's own init
is checked for keys, shapes, dtypes and scale."""
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

import repro.configs as ref_configs  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models.lm import LM as RefLM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402
from repro_torch.models.lm import (LM, lm_params_from_numpy,  # noqa: E402
                                   make_model, padded_vocab)

# bf16 layer outputs: the reference suite's bf16 attention tolerance
# (tests/test_kernels.py:98); logits: its decode-vs-forward tolerance for
# these bf16 models (tests/test_models_lm.py:80)
LAYER_TOL = 3e-2
LOGIT_TOL = 5e-2
MODELS = {"smollm-135m": 64, "mamba2-370m": 128}  # arch -> prefill length
DECODE_STEPS = 16


def _np(x):
    """A jax array or a tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pair(a: np.ndarray, bf16: bool = False):
    """One seeded numpy array as a (jax, torch) pair, bit for bit."""
    if bf16:
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _params(rng, shapes, bf16_keys=()):
    ref, port = {}, {}
    for k, (shape, scale) in shapes.items():
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        ref[k], port[k] = _pair(a, k in bf16_keys)
    return ref, port


# --------------------------------------------------------------- configs ---
@pytest.mark.parametrize("name", sorted(ref_configs.ARCHS))
def test_configs_equal_the_reference(name):
    ref = ref_configs.ARCHS[name]
    port = configs.get_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(configs.reduced(port)) == dataclasses.asdict(
        ref_configs.reduced(ref))
    assert [s.name for s in configs.cells(port)] == [s.name for s in ref_configs.cells(ref)]
    assert port.param_count() == ref.param_count()
    assert port.num_groups == ref.num_groups and port.conv_dim == ref.conv_dim


def test_config_registry_and_shapes():
    assert sorted(configs.ARCHS) == sorted(ref_configs.ARCHS)
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


# ---------------------------------------------------------------- layers ---
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm(bf16, plus_one):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal((2, 5, 64)).astype(np.float32), bf16)
    wj, wt = _pair((rng.standard_normal(64) * 0.1).astype(np.float32))
    got = layers.rms_norm(xt, wt, 1e-5, plus_one=plus_one)
    want = ref_layers.rms_norm(xj, wj, 1e-5, plus_one=plus_one)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=LAYER_TOL if bf16 else 1e-5)


def test_rope():
    pos = np.arange(3, 11, dtype=np.int32)[None].repeat(2, 0)
    cos, sin = layers.rope_cos_sin(torch.from_numpy(pos), 16, 1e4)
    cj, sj = ref_layers.rope_cos_sin(jnp.asarray(pos), 16, 1e4)
    np.testing.assert_allclose(cos.numpy(), np.asarray(cj), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(sj), atol=1e-6)
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.standard_normal((2, 4, 8, 16)).astype(np.float32), bf16=True)
    got = layers.apply_rope(xt, cos, sin)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(ref_layers.apply_rope(xj, cj, sj)),
                               atol=LAYER_TOL)


ATTN = dict(num_heads=4, num_kv_heads=2, head_dim=16)
ATTN_VARIANTS = {  # smollm (plain causal) and gemma2 (window, softcaps, q_scale)
    "causal": dict(window=None, softcap=None, q_scale=None),
    "window_softcap": dict(window=8, softcap=50.0, q_scale=0.2),
}


def _attn_setup(rng, s):
    d, hd = 64, ATTN["head_dim"]
    p_ref, p_port = _params(rng, {
        "wq": ((d, 4 * hd), 0.1), "wk": ((d, 2 * hd), 0.1),
        "wv": ((d, 2 * hd), 0.1), "wo": ((4 * hd, d), 0.1)},
        bf16_keys=("wq", "wk", "wv", "wo"))
    xj, xt = _pair(rng.standard_normal((2, s, d)).astype(np.float32), bf16=True)
    return p_ref, p_port, xj, xt


@pytest.mark.parametrize("variant", sorted(ATTN_VARIANTS))
def test_gqa_attention_prefill(variant):
    rng = np.random.default_rng(2)
    p_ref, p_port, xj, xt = _attn_setup(rng, 32)
    pos = np.arange(32)[None].repeat(2, 0)
    cj, sj = ref_layers.rope_cos_sin(jnp.asarray(pos), 16)
    ct, st = layers.rope_cos_sin(torch.from_numpy(pos), 16)
    kw = dict(ATTN, **ATTN_VARIANTS[variant])
    want, _ = ref_layers.gqa_attention(p_ref, xj, cj, sj, backend="interpret", **kw)
    got, cache = layers.gqa_attention(p_port, xt, ct, st, **kw)
    assert cache is None and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=LAYER_TOL)


@pytest.mark.parametrize("variant", sorted(ATTN_VARIANTS))
@pytest.mark.parametrize("s,cache_pos", [(1, 5), (2, 15)])
def test_gqa_attention_decode_with_cache(variant, s, cache_pos):
    """One or two new tokens into a 16-long cache; (2, 15) runs past the end,
    where the write start clamps to 14 as dynamic_update_slice's does."""
    rng = np.random.default_rng(3)
    p_ref, p_port, xj, xt = _attn_setup(rng, s)
    kc = rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
    cache_ref = {"k": _pair(kc, True)[0], "v": _pair(vc, True)[0]}
    cache_port = {"k": _pair(kc, True)[1], "v": _pair(vc, True)[1]}
    pos = (cache_pos + np.arange(s))[None].repeat(2, 0)
    cj, sj = ref_layers.rope_cos_sin(jnp.asarray(pos), 16)
    ct, st = layers.rope_cos_sin(torch.from_numpy(pos), 16)
    kw = dict(ATTN, **ATTN_VARIANTS[variant])
    want, new_ref = ref_layers.gqa_attention(
        p_ref, xj, cj, sj, backend="interpret", cache=cache_ref,
        cache_pos=jnp.int32(cache_pos), **kw)
    got, new_port = layers.gqa_attention(p_port, xt, ct, st, cache=cache_port,
                                         cache_pos=cache_pos, **kw)
    assert new_port["k"] is cache_port["k"]  # updated in place
    np.testing.assert_allclose(_np(got), _np(want), atol=LAYER_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(new_port[key]), _np(new_ref[key]), atol=LAYER_TOL)
    start = min(cache_pos, 16 - s)
    assert not np.array_equal(_np(new_port["k"])[:, :, start:start + s], kc[:, :, start:start + s])


def test_swiglu_mlp():
    rng = np.random.default_rng(4)
    p_ref, p_port = _params(rng, {"w_gate": ((64, 128), 0.1), "w_up": ((64, 128), 0.1),
                                  "w_down": ((128, 64), 0.1)},
                            bf16_keys=("w_gate", "w_up", "w_down"))
    xj, xt = _pair(rng.standard_normal((2, 8, 64)).astype(np.float32), bf16=True)
    got = layers.swiglu_mlp(p_port, xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(ref_layers.swiglu_mlp(p_ref, xj)),
                               atol=LAYER_TOL)


MAMBA = dict(num_heads=4, head_dim=16, state_dim=16, num_groups=1, conv_width=4)


def _mamba_setup(rng, s):
    d, h, di, n = 64, 4, 64, 16
    cd = di + 2 * n
    p_ref, p_port = _params(rng, {
        "w_in": ((d, 2 * di + 2 * n + h), 0.1), "dt_bias": ((h,), 0.5),
        "a_log": ((h,), 0.5), "w_conv": ((4, cd), 0.2), "b_conv": ((cd,), 0.1),
        "norm": ((di,), 1.0), "w_out": ((di, d), 0.1)}, bf16_keys=("w_in", "w_out"))
    xj, xt = _pair(rng.standard_normal((2, s, d)).astype(np.float32), bf16=True)
    return p_ref, p_port, xj, xt


def test_mamba2_mixer_prefill():
    rng = np.random.default_rng(5)
    p_ref, p_port, xj, xt = _mamba_setup(rng, 64)
    want, _ = ref_layers.mamba2_mixer(p_ref, xj, chunk=32, backend="interpret", **MAMBA)
    got, state = layers.mamba2_mixer(p_port, xt, chunk=32, **MAMBA)
    assert state is None and got.dtype == torch.float32  # f32 y @ bf16 w_out
    np.testing.assert_allclose(_np(got), _np(want), atol=LAYER_TOL)


def test_mamba2_mixer_decode_with_state():
    rng = np.random.default_rng(6)
    p_ref, p_port, xj, xt = _mamba_setup(rng, 1)
    conv = rng.standard_normal((2, 3, 96)).astype(np.float32)
    ssm = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    st_ref = {"conv": _pair(conv, True)[0], "ssm": jnp.asarray(ssm)}
    st_port = {"conv": _pair(conv, True)[1], "ssm": torch.from_numpy(ssm.copy())}
    want, new_ref = ref_layers.mamba2_mixer(p_ref, xj, backend="interpret",
                                            state=st_ref, **MAMBA)
    got, new_port = layers.mamba2_mixer(p_port, xt, state=st_port, **MAMBA)
    assert new_port is st_port  # updated in place
    np.testing.assert_allclose(_np(got), _np(want), atol=LAYER_TOL)
    np.testing.assert_allclose(_np(new_port["conv"]), _np(new_ref["conv"]), atol=LAYER_TOL)
    np.testing.assert_allclose(_np(new_port["ssm"]), _np(new_ref["ssm"]), atol=1e-4)


def test_softplus_is_logaddexp_above_twenty():
    x = torch.tensor([-30.0, 0.0, 19.0, 21.0, 40.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(layers._softplus(x).numpy(), want, rtol=1e-7)


# ---------------------------------------------------------------- models ---
@pytest.fixture(scope="module", params=sorted(MODELS))
def reduced_pair(request):
    """(cfg, reference model, its params, port model, carried params,
    tokens, reference full logits) for a reduced arch."""
    name = request.param
    cfg = ref_configs.reduced(ref_configs.ARCHS[name])
    ref = RefLM(cfg, backend="interpret")
    rp = ref.init(jax.random.key(0))
    port = LM(configs.reduced(configs.get_config(name)), device="cpu")
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, MODELS[name]))
    want, _, _ = ref.forward(rp, tokens=jnp.asarray(toks, jnp.int32))
    return cfg, ref, rp, port, pp, toks.astype(np.int32), np.asarray(want)


def test_params_cross_bit_for_bit(reduced_pair):
    _, _, rp, _, pp, _, _ = reduced_pair
    leaves_ref = jax.tree.leaves(rp)
    leaves_port = jax.tree.leaves(pp)
    assert len(leaves_ref) == len(leaves_port)
    for a, b in zip(leaves_ref, leaves_port):
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())


def test_reduced_forward_matches_reference(reduced_pair):
    cfg, _, _, port, pp, toks, want = reduced_pair
    v = cfg.vocab_size
    got, cache, aux = port.forward(pp, tokens=torch.from_numpy(toks))
    assert cache is None and float(aux) == 0.0
    assert got.shape == want.shape == (2, toks.shape[1], padded_vocab(cfg))
    assert bool(torch.isfinite(got[..., :v]).all())
    np.testing.assert_allclose(got.numpy()[..., :v], want[..., :v], atol=LOGIT_TOL)
    if got.shape[-1] > v:
        assert float(got[..., v:].max()) < -1e20
    last, _, _ = port.forward(pp, tokens=torch.from_numpy(toks), last_only=True)
    assert last.shape == (2, 1, got.shape[-1])
    np.testing.assert_allclose(last.numpy()[..., :v], want[:, -1:, :v], atol=LOGIT_TOL)


def test_reduced_decode_matches_reference_decode(reduced_pair):
    cfg, ref, rp, port, pp, toks, want = reduced_pair
    decode = jax.jit(lambda p, t, c, i: ref.forward(p, tokens=t, cache=c, cache_pos=i))
    c_ref = ref.init_cache(2, DECODE_STEPS)
    c_port = port.init_cache(2, DECODE_STEPS)
    v = cfg.vocab_size
    errs, errs_full = [], []
    for i in range(DECODE_STEPS):
        lr, c_ref, _ = decode(rp, jnp.asarray(toks[:, i:i + 1]), c_ref, jnp.int32(i))
        lp, c_port, _ = port.forward(pp, tokens=torch.from_numpy(toks[:, i:i + 1]),
                                     cache=c_port, cache_pos=i)
        errs.append(np.abs(lp.numpy()[..., :v] - np.asarray(lr)[..., :v]).max())
        errs_full.append(np.abs(lp.numpy()[:, 0, :v] - want[:, i, :v]).max())
    assert max(errs) < LOGIT_TOL, errs
    assert max(errs_full) < LOGIT_TOL, errs_full  # decode == full causal forward
    for a, b in zip(jax.tree.leaves(c_ref), jax.tree.leaves(c_port)):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                   atol=LAYER_TOL)


@pytest.mark.parametrize("name", ["smollm-135m", "mamba2-370m", "gemma2-2b"])
def test_init_cache_matches_reference_layout(name):
    cfg = configs.reduced(configs.get_config(name))
    ref = RefLM(ref_configs.reduced(ref_configs.ARCHS[name]))
    got = LM(cfg, device="cpu").init_cache(3, 20)
    want = ref.init_cache(3, 20)
    assert [sorted(c) for c in got] == [sorted(c) for c in want]
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        assert not b.any()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_init_keys_shapes_dtypes_and_scale(name):
    cfg = configs.reduced(configs.get_config(name))
    port = make_model(cfg, device="cpu")
    got = port.init(0)
    want = RefLM(ref_configs.reduced(ref_configs.ARCHS[name])).init(jax.random.key(0))
    assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, want))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        a32, b32 = np.asarray(a, np.float32), b.float().numpy()
        if np.all(a32 == a32.flat[0]):  # constant leaves: norms, biases
            assert np.array_equal(a32, b32)
        else:  # random leaves: same scale
            assert abs(b32.std() / a32.std() - 1) < 0.15
    again = port.init(0)
    other = port.init(1)
    assert torch.equal(again["embed"], got["embed"])
    assert not torch.equal(other["embed"], got["embed"])


def test_every_config_trains_and_data_parallel_meshes_run():
    """Every shipped config constructs on the CPU and its loss is finite on
    its reduced form; the LM train step over a (2, 1) mesh and a pod mesh
    (2, 1, 1) of data ranks runs and equals the one-rank step (loss within
    1e-5, first moments within 5e-2 of each leaf's largest entry)."""
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh_for
    from repro_torch.train import tree_leaves
    from repro_torch.train.train_step import build_train_step, init_train_state

    for name in sorted(configs.ARCHS):
        LM(configs.get_config(name), device="cpu")
        cfg = configs.reduced(configs.get_config(name))
        model = LM(cfg, device="cpu", ssd_chunk=8)
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 16)))
        kw = {}
        if cfg.frontend != "none":
            kw["embeds"] = torch.from_numpy(
                rng.standard_normal((1, 16, cfg.d_model)).astype(np.float32))
        loss = model.loss(model.init(0), None if kw else toks, toks, **kw)
        assert loss.shape == () and bool(torch.isfinite(loss)), name
    cfg = configs.reduced(configs.get_config("smollm-135m"))
    model = LM(cfg, device="cpu")
    rng = np.random.default_rng(1)
    tok, tgt = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))) for _ in range(2))
    state = init_train_state(model, 0)
    one, m1 = build_train_step(model, make_debug_mesh(1, 1, device="cpu"), 4)[0](state, tok, tgt)
    cpu = torch.device("cpu")
    for shape, axes in (((2, 1), ("data", "model")), ((2, 1, 1), ("pod", "data", "model"))):
        mesh = make_mesh_for([cpu, cpu], shard_axes=axes, shape=shape)
        dp, m2 = build_train_step(model, mesh, 4)[0](state, tok, tgt)
        assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-5, shape
        for a, b in zip(tree_leaves(one.opt.mu), tree_leaves(dp.opt.mu)):
            assert float((a - b).abs().max()) <= 5e-2 * float(a.abs().max()), shape


def test_cuda_model_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.reduced(configs.get_config("smollm-135m"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(cfg)  # the default device is "cuda"
    LM(cfg, device="cpu")
