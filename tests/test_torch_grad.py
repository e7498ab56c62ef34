"""Gradients of the port on the CPU against the JAX package's.

The NA Functions (``seg_sum.BandedMatvec`` behind ``seg_sum_na``,
``ops.AttentionPacked`` behind ``na_attention_packed``) against
``jax.grad`` of the reference's custom VJPs (Pallas interpret mode) on the
random streams of ``test_grad_banded.py``, plus central finite
differences; then ``HGNN.execute_loss`` gradients on both executors
against the reference's, features included.  The same Functions run on
the card, where their backward launches K1 over the packing's
source-major view (``test_torch_cuda.py``, ``chip_smoke.py``).
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

import repro.api as ref_api  # noqa: E402
from repro.core.hgnn import HGNN as RefHGNN  # noqa: E402
from repro.core.hgnn import HGNNConfig as RefConfig  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import seg_sum as ref_seg_sum  # noqa: E402
from repro_torch.api import ExecutorSpec, Session, device_features  # noqa: E402
from repro_torch.core.hgnn import HGNNConfig, params_from_numpy  # noqa: E402
from repro_torch.hetero import make_dataset  # noqa: E402
from repro_torch.kernels.ops import na_attention_packed  # noqa: E402
from repro_torch.kernels.seg_sum import pack_edge_blocks, seg_sum_na  # noqa: E402
from repro_torch.train import tree_leaves, value_and_grad  # noqa: E402

WORKLOADS = {
    "acm_small": ("ACM", 0.15, ["APA", "PAP", "PSP"], "P"),
    "imdb_small": ("IMDB", 0.2, ["AMA", "MAM", "MDM"], "M"),
}
MODELS = ["rgcn", "rgat", "shgn"]


def _random_stream(ns, nd, ne, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, ns, ne)
    dst = rng.integers(0, nd, ne)
    o = np.lexsort((src, dst))
    return src[o], dst[o]


def _stream(case):
    """(src, dst, num_src, num_dst): the reference test's random streams
    (one band; four bands), a tile revisited after another tile, and
    rows and tiles without edges."""
    if case == "one_band":
        return (*_random_stream(300, 150, 1200, 0), 300, 150)
    if case == "multi_band":
        return (*_random_stream(1100, 400, 3000, 1), 1100, 400)
    if case == "revisit":  # tile 0 -> tile 1 -> tile 0 again
        return np.array([0, 1, 700, 2, 5]), np.array([0, 3, 130, 0, 0]), 1024, 256
    assert case == "gaps"
    s, d = _random_stream(600, 40, 800, 3)
    return s, np.where(d < 20, d, d + 400), 600, 512


STREAMS = ["one_band", "multi_band", "revisit", "gaps"]


# ------------------------------------------------------ op-level VJPs --
@pytest.mark.parametrize("case", STREAMS)
def test_seg_sum_na_grads_match_reference(case):
    """grad wrt features (packing weights) and wrt blocked weights."""
    src, dst, ns, nd = _stream(case)
    rng = np.random.default_rng(len(case))
    pk = pack_edge_blocks(src, dst, ns, nd)
    pk_ref = ref_seg_sum.pack_edge_blocks(src, dst, ns, nd)
    h = rng.standard_normal((ns, 8)).astype(np.float32)
    r = rng.standard_normal((nd, 8)).astype(np.float32)
    w = np.zeros(pk.src_local.shape, np.float32)
    blk, slot = pk.edge_map()
    w[blk, slot] = rng.random(blk.size).astype(np.float32)

    gh_ref = jax.grad(lambda x: jnp.sum(
        ref_seg_sum.seg_sum_na(pk_ref, x, interpret=True) * r))(jnp.asarray(h))
    gh2_ref, gw_ref = jax.grad(lambda x, ww: jnp.sum(ref_seg_sum.seg_sum_na(
        pk_ref, x, interpret=True, weights=ww) * r), argnums=(0, 1))(
            jnp.asarray(h), jnp.asarray(w))

    ht = torch.from_numpy(h).requires_grad_(True)
    (seg_sum_na(pk, ht) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh_ref), atol=1e-5)
    ht2 = torch.from_numpy(h).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    (seg_sum_na(pk, ht2, wt) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(ht2.grad.numpy(), np.asarray(gh2_ref), atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_ref), atol=1e-5)
    assert float(ht.grad.abs().max()) > 0 and float(wt.grad.abs().max()) > 0


def test_seg_sum_na_constant_weights_take_no_gradient():
    """The packing's own weights are constants: no weight cotangent."""
    src, dst, ns, nd = _stream("one_band")
    pk = pack_edge_blocks(src, dst, ns, nd)
    h = torch.randn(ns, 4, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    out = seg_sum_na(pk, h)
    assert out.requires_grad and out.grad_fn.__class__.__name__ == "BandedMatvecBackward"
    with torch.no_grad():  # a call that needs no gradient skips the Function
        bare = seg_sum_na(pk, h)
    assert not bare.requires_grad and torch.equal(bare, out.detach())


def test_na_attention_packed_without_gradient_skips_the_function():
    src, dst, ns, nd = _stream("multi_band")
    pk = pack_edge_blocks(src, dst, ns, nd)
    gen = torch.Generator().manual_seed(1)
    h = torch.randn(ns, 4, generator=gen, requires_grad=True)
    logits = torch.randn(src.size, generator=gen)
    out, alpha = na_attention_packed(pk, logits, h)
    assert out.grad_fn is not None
    with torch.inference_mode():
        out2, alpha2 = na_attention_packed(pk, logits, h)
    assert out2.grad_fn is None
    assert torch.equal(out2, out.detach()) and torch.equal(alpha2, alpha.detach())


@pytest.mark.parametrize("case", STREAMS)
def test_na_attention_packed_grads_match_reference(case):
    """Logits and features, with an output and an alpha cotangent."""
    src, dst, ns, nd = _stream(case)
    rng = np.random.default_rng(10 + len(case))
    pk = pack_edge_blocks(src, dst, ns, nd)
    pk_ref = ref_seg_sum.pack_edge_blocks(src, dst, ns, nd)
    ne = src.size
    h = rng.standard_normal((ns, 8)).astype(np.float32)
    r = rng.standard_normal((nd, 8)).astype(np.float32)
    ra = rng.standard_normal(ne).astype(np.float32)
    logits = (rng.standard_normal(ne) * 2).astype(np.float32)

    def f_ref(lg, x):
        out, alpha = ref_ops.na_attention_packed(pk_ref, lg, x, dst, backend="interpret")
        return jnp.sum(out * r) + jnp.sum(alpha * ra)

    gl_ref, gh_ref = jax.grad(f_ref, argnums=(0, 1))(jnp.asarray(logits), jnp.asarray(h))
    lt = torch.from_numpy(logits).requires_grad_(True)
    ht = torch.from_numpy(h).requires_grad_(True)
    out, alpha = na_attention_packed(pk, lt, ht)
    ((out * torch.from_numpy(r)).sum() + (alpha * torch.from_numpy(ra)).sum()).backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gl_ref), atol=1e-5)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh_ref), atol=1e-5)
    assert float(lt.grad.abs().max()) > 0


def _central_fd(f, x0: np.ndarray, idx, eps=1e-2):
    xp, xm = x0.copy(), x0.copy()
    xp[idx] += eps
    xm[idx] -= eps
    return (f(xp) - f(xm)) / (2 * eps)


def test_seg_sum_na_vjp_finite_difference():
    """Central differences confirm the backward formula itself, not only
    its agreement with the reference's."""
    src, dst = _random_stream(96, 48, 300, 5)
    pk = pack_edge_blocks(src, dst, 96, 48)
    rng = np.random.default_rng(5)
    h0 = rng.standard_normal((96, 4)).astype(np.float32)
    w0 = np.zeros(pk.src_local.shape, np.float32)
    blk, slot = pk.edge_map()
    w0[blk, slot] = rng.random(blk.size).astype(np.float32)
    r = torch.from_numpy(rng.standard_normal((48, 4)).astype(np.float32))

    def f(x, w):
        return float((seg_sum_na(pk, torch.from_numpy(x), torch.from_numpy(w)) * r)
                     .double().sum())

    ht = torch.from_numpy(h0).requires_grad_(True)
    wt = torch.from_numpy(w0).requires_grad_(True)
    (seg_sum_na(pk, ht, wt) * r).sum().backward()
    for i, j in [(0, 0), (7, 3), (31, 2), (95, 1), (50, 0)]:
        fd = _central_fd(lambda x: f(x, w0), h0, (i, j))
        np.testing.assert_allclose(ht.grad[i, j].item(), fd, atol=5e-2, rtol=5e-2)
    for e in (0, 17, 150, 299):
        fd = _central_fd(lambda w: f(h0, w), w0, (blk[e], slot[e]))
        np.testing.assert_allclose(wt.grad[blk[e], slot[e]].item(), fd,
                                   atol=5e-2, rtol=5e-2)


def test_na_attention_packed_vjp_finite_difference():
    src, dst = _random_stream(80, 30, 260, 6)
    pk = pack_edge_blocks(src, dst, 80, 30)
    rng = np.random.default_rng(6)
    h0 = rng.standard_normal((80, 4)).astype(np.float32)
    l0 = rng.standard_normal(260).astype(np.float32)
    r = torch.from_numpy(rng.standard_normal((30, 4)).astype(np.float32))
    ra = torch.from_numpy(rng.standard_normal(260).astype(np.float32))

    def f(lg, x):
        out, alpha = na_attention_packed(pk, torch.from_numpy(lg), torch.from_numpy(x))
        return float((out * r).double().sum() + (alpha * ra).double().sum())

    lt = torch.from_numpy(l0).requires_grad_(True)
    ht = torch.from_numpy(h0).requires_grad_(True)
    out, alpha = na_attention_packed(pk, lt, ht)
    ((out * r).sum() + (alpha * ra).sum()).backward()
    for e in (0, 9, 100, 259):
        fd = _central_fd(lambda lg: f(lg, h0), l0, (e,))
        np.testing.assert_allclose(lt.grad[e].item(), fd, atol=5e-2, rtol=5e-2)
    for i, j in [(0, 0), (40, 3), (79, 1)]:
        fd = _central_fd(lambda x: f(l0, x), h0, (i, j))
        np.testing.assert_allclose(ht.grad[i, j].item(), fd, atol=5e-2, rtol=5e-2)


# ------------------------------------------------- model-level parity --
@pytest.fixture(scope="module")
def setups(acm_small, imdb_small):
    """Per workload: the reference's and the port's graph, frontend, the
    reference's features and the port's, labels and a mask."""
    ref_graphs = {"acm_small": acm_small, "imdb_small": imdb_small}
    sess = ref_api.Session(ref_api.ExecutorSpec(na_executor="banded"))
    out = {}
    for name, (ds, scale, targets, ttype) in WORKLOADS.items():
        g_ref = ref_graphs[name]
        n = g_ref.num_vertices[ttype]
        rng = np.random.default_rng(7)
        out[name] = {
            "ref_graph": g_ref, "ref_res": sess.frontend(g_ref, targets),
            "port_graph": make_dataset(ds, scale=scale),
            "labels": rng.integers(0, 3, n).astype(np.int32),
            "mask": (np.arange(n) % 3 == 0).astype(np.float32),
        }
    return out


@pytest.mark.parametrize("executor", ["banded", "jnp"])
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("ds", sorted(WORKLOADS))
def test_loss_grads_match_reference(setups, ds, model, executor):
    """``execute_loss`` and its gradients, every parameter and the input
    features, within 1e-4 of the reference's on the same executor."""
    st = setups[ds]
    _, _, targets, ttype = WORKLOADS[ds]
    kw = dict(model=model, hidden=16, num_layers=2, num_classes=3, target_type=ttype)
    g_ref = st["ref_graph"]
    m = RefHGNN(RefConfig(**kw), g_ref.feature_dims, g_ref.num_vertices, sorted(targets))
    params = m.init(jax.random.key(2))
    feats = {t: jnp.asarray(x) for t, x in g_ref.features.items()}
    graphs = (st["ref_res"].banded_batches() if executor == "banded"
              else st["ref_res"].batches())
    labels, mask = jnp.asarray(st["labels"]), jnp.asarray(st["mask"])
    loss_ref, (gp_ref, gf_ref) = jax.jit(jax.value_and_grad(
        lambda p, f: m.execute_loss(p, f, graphs, labels, mask=mask,
                                    na_executor=executor), argnums=(0, 1)))(params, feats)

    compiled = Session(ExecutorSpec(na_executor=executor, device="cpu")).compile(
        st["port_graph"], targets, HGNNConfig(**kw))
    p_port = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    f_port = device_features(st["port_graph"], "cpu")
    lab, msk = torch.from_numpy(st["labels"]), torch.from_numpy(st["mask"])
    loss, (gp, gf) = value_and_grad(
        lambda p, f: compiled.loss(p, f, lab, msk), p_port, f_port)

    np.testing.assert_allclose(loss.item(), float(loss_ref), atol=1e-5)
    ref_leaves = jax.tree.leaves(gp_ref)
    mine = tree_leaves(gp)
    assert len(mine) == len(ref_leaves)
    for a, b in zip(mine, ref_leaves):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    for t in sorted(gf_ref):
        np.testing.assert_allclose(gf[t].numpy(), np.asarray(gf_ref[t]), atol=1e-4)
    assert max(float(a.abs().max()) for a in mine) > 0


def test_leaves_without_a_path_to_the_loss_get_zero_grads(setups):
    """A-typed leaves never reach the P head on ACM: zeros, as jax.grad
    gives (the optimizer then still decays them), not ``None``."""
    st = setups["acm_small"]
    _, _, targets, _ = WORKLOADS["acm_small"]
    compiled = Session(ExecutorSpec(device="cpu")).compile(
        st["port_graph"], targets, HGNNConfig(model="rgcn", hidden=8, num_layers=2))
    params = compiled.init(0)
    lab, msk = torch.from_numpy(st["labels"]), torch.from_numpy(st["mask"])
    loss, (grads,) = value_and_grad(
        lambda p: compiled.loss(p, device_features(st["port_graph"], "cpu"), lab, msk),
        params)
    for lp in grads["layers"]:
        assert isinstance(lp["na"]["APA"]["w_rel"], torch.Tensor)
        assert float(lp["na"]["APA"]["w_rel"].abs().max()) == 0
        assert float(lp["sf"]["A"]["w_self"].abs().max()) == 0
        assert float(lp["na"]["PAP"]["w_rel"].abs().max()) > 0
    # value_and_grad leaves the parameters it was given untouched
    assert all(not p.requires_grad for p in tree_leaves(params))


def test_attention_param_grads_nonzero_on_the_banded_path(setups):
    """No hole in the fused attention path: a_src, a_dst, a_edge and
    edge_emb get gradients in every layer, through the logits cotangent."""
    st = setups["acm_small"]
    _, _, targets, _ = WORKLOADS["acm_small"]
    compiled = Session(ExecutorSpec(device="cpu")).compile(
        st["port_graph"], targets, HGNNConfig(model="shgn", hidden=16, num_layers=2))
    lab = torch.from_numpy(st["labels"])
    _, (grads,) = value_and_grad(
        lambda p: compiled.loss(p, device_features(st["port_graph"], "cpu"), lab),
        compiled.init(3))
    for lp in grads["layers"]:
        for mp in ("PAP", "PSP"):
            assert float(lp["na"][mp]["a_src"].abs().max()) > 0
            assert float(lp["na"][mp]["a_dst"].abs().max()) > 0
        assert float(lp["a_edge"].abs().max()) > 0
        assert float(lp["edge_emb"].abs().max()) > 0
