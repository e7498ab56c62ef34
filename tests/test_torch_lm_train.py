"""The port's ``LM.loss`` and its gradients on the CPU against the JAX
package's: ``jax.value_and_grad(LM(cfg, backend="jnp", remat="none").loss)``
on every reduced config (the reference trains on its jnp path: its Pallas
K4 and K5 have no VJP), from the same parameters and inputs.  Also the
remat policies against each other, the K4 and K5 autograd Functions
against ``torch.autograd.gradcheck`` in float64, and K4's padded route's
gradient at head dims 80 and 96 / 64.

Tolerances: the loss within 1e-3 (both sides' bf16 layers round at other
places; the aux term dropped moves it by 1e-2) and every gradient leaf
within 5e-2 of its largest entry: the gradients are bf16, as the
reference's (one bf16 step is 2^-8 relative), and the two packages'
attention and SSD differ in their float32 internals.  One exception:
jamba-v0.1-52b's MoE layers route by near-tied gates (4 experts, top 2,
random weights), and its bf16 hidden states after an attention layer
round differently enough to flip a few tokens' experts and, through the
capacity queues, later tokens'; the leaves those decisions feed (the MoE
FFN and its input norm ``ln2``) are held to 5e-2 of the model's largest
gradient entry, and the MoE layer's own gradient on identical inputs to
2e-2 of each leaf's largest entry.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

# PyTorch's CPU build can return a wrong result for the first vectorized
# float op of a fresh process; a throwaway call first keeps the comparisons
# below about the port (ROADMAP, queue 3).
torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models.lm import LM as RefLM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ssd_scan import SSDScan  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.lm import LM, lm_params_from_numpy  # noqa: E402
from repro_torch.train import tree_leaves, value_and_grad  # noqa: E402
from torch_lm_parity import pos3_grid  # noqa: E402

LOSS_TOL = 1e-3
GRAD_RTOL = 5e-2
MOE_LAYER_RTOL = 2e-2
ROUTING_FLIPS = {"jamba-v0.1-52b"}
BATCH, SEQ, CHUNK = 2, 64, 32  # the SSD chunk divides the sequence on both sides


def _inputs(cfg, rng):
    """Token ids and targets, and ``embeds`` / ``pos3`` for a frontend stub."""
    toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    kw = {}
    if cfg.frontend != "none":
        kw["embeds"] = rng.standard_normal((BATCH, SEQ, cfg.d_model)).astype(np.float32)
        if cfg.mrope_sections is not None:
            kw["pos3"] = pos3_grid(BATCH, SEQ)
    return toks[:, :-1], toks[:, 1:], kw


def _both(name, remat="none"):
    cfg = ref_configs.reduced(ref_configs.ARCHS[name])
    ref = RefLM(cfg, backend="jnp", remat="none", ssd_chunk=CHUNK)
    rp = ref.init(jax.random.key(0))
    port = LM(configs.reduced(configs.get_config(name)), device="cpu", remat=remat,
              ssd_chunk=CHUNK)
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    return cfg, ref, rp, port, pp


def _ref_value_and_grad(ref, rp, tok, tgt, kw):
    rkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tokens = None if "embeds" in kw else jnp.asarray(tok)
    f = jax.jit(jax.value_and_grad(
        lambda p: ref.loss(p, tokens, jnp.asarray(tgt), **rkw)))
    return f(rp)


def _port_value_and_grad(port, pp, tok, tgt, kw, aux_weight=0.01):
    pkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    tokens = None if "embeds" in kw else torch.from_numpy(tok)
    loss, (grads,) = value_and_grad(
        lambda p: port.loss(p, tokens, torch.from_numpy(tgt), aux_weight=aux_weight, **pkw),
        pp)
    return loss, grads


def _leaf_errors(name, ref_grads, port_grads):
    """[(path, error / its scale)]: each leaf against its largest entry, or
    for routing-fed leaves of a ROUTING_FLIPS config the model's."""
    paths = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    mine = tree_leaves(port_grads)
    assert len(paths) == len(mine)
    model_max = max(float(np.abs(np.asarray(a, np.float32)).max()) for _, a in paths)
    out = []
    for (path, a), b in zip(paths, mine):
        key = jax.tree_util.keystr(path)
        a32, b32 = np.asarray(a, np.float32), b.float().numpy()
        assert a32.shape == b32.shape and str(a.dtype) == str(b.dtype).replace("torch.", "")
        routed = name in ROUTING_FLIPS and _is_moe_leaf(name, key)
        scale = model_max if routed else float(np.abs(a32).max())
        out.append((key, float(np.abs(a32 - b32).max()) / max(scale, 1e-30)))
    return out


def _is_moe_leaf(name, key):
    """A leaf of a MoE position's FFN or of its input norm ``ln2``."""
    cfg = ref_configs.reduced(ref_configs.ARCHS[name])
    for pos, (_, ffn) in enumerate(cfg.block_pattern):
        if ffn == "moe" and key.startswith(f"['blocks'][{pos}]") and (
                "['ffn']" in key or key.endswith("['ln2']")):
            return True
    return False


@pytest.mark.parametrize("name", sorted(ref_configs.ARCHS))
def test_loss_and_every_gradient_leaf_match_the_reference(name):
    cfg, ref, rp, port, pp = _both(name)
    tok, tgt, kw = _inputs(cfg, np.random.default_rng(1))
    want_loss, want = _ref_value_and_grad(ref, rp, tok, tgt, kw)
    loss, grads = _port_value_and_grad(port, pp, tok, tgt, kw)
    assert bool(torch.isfinite(loss))
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL, (float(loss), float(want_loss))
    errs = _leaf_errors(name, want, grads)
    worst = max(errs, key=lambda e: e[1])
    assert worst[1] <= GRAD_RTOL, worst
    # every leaf the reference moves, the port moves
    for a, b in zip(jax.tree.leaves(want), tree_leaves(grads)):
        if np.abs(np.asarray(a, np.float32)).max() > 0:
            assert float(b.abs().max()) > 0


def test_dropped_aux_term_breaks_the_gradient_gate():
    """The planted fault: granite-moe's loss without its aux term reads
    above both tolerances (the loss, and the router's gradient)."""
    name = "granite-moe-1b-a400m"
    cfg, ref, rp, port, pp = _both(name)
    tok, tgt, kw = _inputs(cfg, np.random.default_rng(1))
    want_loss, want = _ref_value_and_grad(ref, rp, tok, tgt, kw)
    loss, grads = _port_value_and_grad(port, pp, tok, tgt, kw, aux_weight=0.0)
    assert abs(float(loss) - float(want_loss)) > LOSS_TOL
    errs = dict(_leaf_errors(name, want, grads))
    assert max(v for k, v in errs.items() if "w_router" in k) > GRAD_RTOL


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "jamba-v0.1-52b"])
def test_moe_layer_gradient_matches_the_reference(name):
    """The MoE FFN's gradient (experts, router, input) on identical inputs,
    so identical routing, within MOE_LAYER_RTOL of each leaf's largest
    entry; the loss mixes the output and the aux term."""
    cfg = ref_configs.reduced(ref_configs.ARCHS[name])
    rp = RefLM(cfg, backend="jnp").init(jax.random.key(0))
    pos = next(i for i, (_, f) in enumerate(cfg.block_pattern) if f == "moe")
    p_ref = jax.tree.map(lambda a: a[0], rp["blocks"][pos]["ffn"])
    p_port = lm_params_from_numpy(jax.tree.map(np.asarray, p_ref), "cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, SEQ, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.experts_per_token,
              group_size=min(cfg.moe_group_size, BATCH * SEQ))

    def f_ref(p, xx):
        out, aux = ref_layers.moe_ffn(p, xx, **kw)
        return jnp.sum(out.astype(jnp.float32) * r) + aux

    def f_port(p, xx):
        out, terms = layers.moe_ffn(p, xx, **kw)
        return (out.float() * torch.from_numpy(r)).sum() + layers.moe_aux(*terms)

    v_ref, (g_ref, gx_ref) = jax.value_and_grad(f_ref, argnums=(0, 1))(
        p_ref, jnp.asarray(x, jnp.bfloat16))
    v, (g, gx) = value_and_grad(f_port, p_port, torch.from_numpy(x).to(torch.bfloat16))
    assert abs(float(v) - float(v_ref)) <= LOSS_TOL * abs(float(v_ref))
    for k in sorted(g_ref):
        a, b = np.asarray(g_ref[k], np.float32), g[k].float().numpy()
        assert np.abs(a - b).max() <= MOE_LAYER_RTOL * np.abs(a).max(), k
    a, b = np.asarray(gx_ref, np.float32), gx.float().numpy()
    assert np.abs(a - b).max() <= MOE_LAYER_RTOL * np.abs(a).max()


@pytest.mark.parametrize("name", ["smollm-135m", "mamba2-370m", "granite-moe-1b-a400m",
                                  "minicpm3-4b", "gemma2-2b", "hubert-xlarge"])
def test_remat_policies_give_equal_gradients(name):
    """``remat`` "none", "full" (each layer group recomputed) and "dots"
    (matmul outputs kept) give the same loss and gradients, bit for bit
    (hubert-xlarge: non-causal, fed ``embeds``)."""
    cfg = configs.reduced(configs.get_config(name))
    tok, tgt, kw = _inputs(cfg, np.random.default_rng(2))
    out = {}
    for remat in ("none", "full", "dots"):
        model = LM(cfg, device="cpu", remat=remat, ssd_chunk=CHUNK)
        params = model.init(0)
        out[remat] = _port_value_and_grad(model, params, tok, tgt, kw)
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(tree_leaves(out[remat][1]), tree_leaves(out["none"][1])):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="remat"):
        LM(cfg, device="cpu", remat="some")


def test_forward_records_autograd_only_when_training():
    """Without a parameter that requires grad the forward runs in inference
    mode (serving, decode); with one it records autograd."""
    model = LM(configs.reduced(configs.get_config("smollm-135m")), device="cpu")
    params = model.init(0)
    toks = torch.zeros((1, 8), dtype=torch.int64)
    logits, _, _ = model.forward(params, toks)
    assert logits.is_inference() and not logits.requires_grad
    live = {**params, "final_norm": params["final_norm"].clone().requires_grad_(True)}
    logits, _, _ = model.forward(live, toks)
    assert logits.requires_grad and not logits.is_inference()
    with torch.no_grad():
        assert not model.forward(live, toks)[0].requires_grad


# -------------------------------------------------------- the Functions --
@pytest.mark.parametrize("case", [
    dict(hq=4, hkv=2, s=6, t=6, dh=8, dv=8, causal=True, window=None, softcap=None),
    dict(hq=4, hkv=1, s=5, t=9, dh=8, dv=6, causal=True, window=4, softcap=3.0),
    dict(hq=2, hkv=2, s=7, t=7, dh=6, dv=6, causal=False, window=None, softcap=None),
])
def test_flash_attention_function_passes_gradcheck(case):
    """K4's Function in float64 on the CPU (its forward is the plain
    version there; its backward float64 autograd of it, recomputed)
    against finite differences."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, case["hq"], case["s"], case["dh"], dtype=torch.float64, generator=g)
    k = torch.randn(1, case["hkv"], case["t"], case["dh"], dtype=torch.float64, generator=g)
    v = torch.randn(1, case["hkv"], case["t"], case["dv"], dtype=torch.float64, generator=g)
    args = (case["causal"], case["window"], case["softcap"], None)
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.FlashAttention.apply(a, b, c, *args),
        tuple(t.requires_grad_(True) for t in (q, k, v)))


def test_ssd_function_passes_gradcheck():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 8, 4, 4, dtype=torch.float64, generator=g)
    a = -torch.rand(1, 8, 4, dtype=torch.float64, generator=g)
    b = torch.randn(1, 8, 2, 4, dtype=torch.float64, generator=g)
    c = torch.randn(1, 8, 2, 4, dtype=torch.float64, generator=g)
    assert torch.autograd.gradcheck(lambda *t: SSDScan.apply(*t, 4),
                                    tuple(t.requires_grad_(True) for t in (x, a, b, c)))


def test_flash_attention_query_tiles_give_the_untiled_gradient(monkeypatch):
    """Beyond S·T = VJP_TILE_ELEMS the backward recomputes query tile by
    query tile over each tile's live keys; the gradients equal the untiled
    ones (float32 summation order aside), rows with no live key pass
    none."""
    g = torch.Generator().manual_seed(1)
    q, k, v, gy = (torch.randn(shape, generator=g) for shape in
                   ((2, 4, 48, 16), (2, 2, 48, 16), (2, 2, 48, 16), (2, 4, 48, 16)))
    for kw in (dict(causal=True), dict(causal=True, window=10, softcap=5.0),
               dict(causal=False)):
        whole = fa.attention_vjp(q, k, v, gy, **kw)
        monkeypatch.setattr(fa, "VJP_TILE_ELEMS", 48 * 7)  # tiles of 7 rows
        tiled = fa.attention_vjp(q, k, v, gy, **kw)
        monkeypatch.undo()
        for a, b in zip(tiled, whole):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
    # queries before the first key (S > T, end-aligned): no live key, zero rows
    dq, _, _ = fa.attention_vjp(q, k[:, :, :40], v[:, :, :40], gy)
    assert float(dq[:, :, :8].abs().max()) == 0.0 and float(dq[:, :, 8:].abs().max()) > 0


@pytest.mark.parametrize("dqk,dv", [(80, 80), (96, 64)])
def test_padded_route_gradient_equals_the_true_head_dims(dqk, dv):
    """K4's padded route (hubert's 80, MLA's 96 / 64) runs the kernel on
    zero-padded q, k and v at the true scale; differentiating through that
    padding and the slice back gives the Function's gradient at the true
    head dims (padding is exact)."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn(1, 4, 32, dqk, generator=g).to(torch.bfloat16).requires_grad_(True)
    k = torch.randn(1, 2, 32, dqk, generator=g).to(torch.bfloat16).requires_grad_(True)
    v = torch.randn(1, 2, 32, dv, generator=g).to(torch.bfloat16).requires_grad_(True)
    gy = torch.randn(1, 4, 32, dv, generator=g)
    got = torch.autograd.grad(fa.FlashAttention.apply(q, k, v, True, None, None, None),
                              (q, k, v), gy.to(torch.bfloat16))
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
        qp, kp, vp, scale, keep = fa.pad_head_dims(qf, kf, vf)
        assert qp.shape[-1] == fa.padded_head_dim(dqk, dv) and scale == dqk ** -0.5
        out = fa.attention_plain(qp, kp, vp, causal=True, scale=scale)[..., :keep]
        want = torch.autograd.grad(out, (qf, kf, vf), gy)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), atol=2e-2 * float(b.abs().max()))


def test_embedding_gradient_is_the_one_hot_contraction():
    """``EmbedLookup``'s gradient is the reference's one-hot contraction in
    ``dy``'s dtype, and the tied unembed's gradient adds to it."""
    from repro_torch.models.lm import EmbedLookup

    g = torch.Generator().manual_seed(3)
    embed = torch.randn(16, 8, generator=g).to(torch.bfloat16).requires_grad_(True)
    toks = torch.tensor([[1, 3, 3, 15], [0, 1, 1, 1]])
    dy = torch.randn(2, 4, 8, generator=g).to(torch.bfloat16)
    (de,) = torch.autograd.grad(EmbedLookup.apply(embed, toks), embed, dy)
    onehot = jax.nn.one_hot(jnp.asarray(toks.numpy()), 16, dtype=jnp.bfloat16)
    want = jnp.einsum("...v,...d->vd", onehot,
                      jnp.asarray(dy.float().numpy(), jnp.bfloat16)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(de.float().numpy(), np.asarray(want, np.float32))
    assert float(de[2].abs().max()) == 0.0  # a row no token reads

