"""Port model parity: ``repro_torch.api`` banded forward on the CPU (the
plain versions of the NA kernels) against ``repro.api``'s banded forward
(Pallas interpret mode) with the reference's parameters carried across by
``params_from_numpy``; plus the port's init, spec and session surface."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

# PyTorch's CPU build can return a wrong result for the first vectorized
# float op of a fresh process (torch 2.13 CPU: exp off by up to 1.5e-4
# relative, about one process in 30); a throwaway call first keeps the
# comparisons below about the port (ROADMAP, queue 3).
torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))

import jax  # noqa: E402

import repro.api as ref_api  # noqa: E402
from repro.core.hgnn import HGNNConfig as RefConfig  # noqa: E402
from repro_torch.api import ExecutorSpec, Session, device_features  # noqa: E402
from repro_torch.core.hgnn import HGNNConfig, params_from_numpy  # noqa: E402
from repro_torch.hetero import make_dataset  # noqa: E402

WORKLOADS = {
    "acm_small": ("ACM", 0.15, ["APA", "PAP", "PSP"], "P"),
    "imdb_small": ("IMDB", 0.2, ["AMA", "MAM", "MDM"], "M"),
}
MODELS = ["rgcn", "rgat", "shgn"]


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.fixture(scope="module")
def sessions(acm_small, imdb_small):
    """One reference session and one port session (CPU) per module, each
    with its graphs (the port builds its own from the same seed)."""
    ref_graphs = {"acm_small": acm_small, "imdb_small": imdb_small}
    return {
        "ref": ref_api.Session(ref_api.ExecutorSpec(
            na_executor="banded", kernel_backend="interpret")),
        "port": Session(ExecutorSpec(na_executor="banded", device="cpu")),
        "ref_graphs": ref_graphs,
        "port_graphs": {k: make_dataset(ds, scale=sc)
                        for k, (ds, sc, _, _) in WORKLOADS.items()},
    }


@pytest.mark.parametrize("ds", sorted(WORKLOADS))
@pytest.mark.parametrize("model", MODELS)
def test_banded_forward_matches_reference(sessions, ds, model):
    _, _, targets, target_type = WORKLOADS[ds]
    g_ref, g_port = sessions["ref_graphs"][ds], sessions["port_graphs"][ds]
    kw = dict(model=model, hidden=32, num_layers=2, num_classes=3,
              target_type=target_type)
    c_ref = sessions["ref"].compile(g_ref, targets, RefConfig(**kw))
    p_ref = c_ref.init(0)
    want = np.asarray(c_ref.forward(p_ref, ref_api.device_features(g_ref)))
    c_port = sessions["port"].compile(g_port, targets, HGNNConfig(**kw))
    params = params_from_numpy(jax.tree.map(np.asarray, p_ref), "cpu")
    got = c_port.forward(params, device_features(g_port, "cpu"))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("model", MODELS)
def test_init_matches_reference_shapes_and_keys(sessions, model):
    _, _, targets, target_type = WORKLOADS["acm_small"]
    kw = dict(model=model, hidden=32, num_layers=2, target_type=target_type)
    c_ref = sessions["ref"].compile(sessions["ref_graphs"]["acm_small"],
                                    targets, RefConfig(**kw))
    c_port = sessions["port"].compile(sessions["port_graphs"]["acm_small"],
                                      targets, HGNNConfig(**kw))
    ref_params = jax.tree.map(np.asarray, c_ref.init(0))
    mine = c_port.init(0)
    assert _shapes(mine) == _shapes(ref_params)
    # seeded: same seed, same values; another seed, other values
    again = c_port.init(0)
    other = c_port.init(1)
    assert torch.equal(mine["head"]["w"], again["head"]["w"])
    assert not torch.equal(mine["head"]["w"], other["head"]["w"])
    # the reference's scales: sqrt(2 / fan_in) dense, 0.1 vectors, 0 biases
    w = mine["layers"][1]["na"]["APA"]["w_rel"]
    assert abs(w.std().item() - (2.0 / 32) ** 0.5) < 0.05
    assert (mine["layers"][0]["fp"]["P"]["b"] == 0).all()
    # the port's own params drive its forward
    out = c_port.forward(mine, device_features(sessions["port_graphs"]["acm_small"], "cpu"))
    assert torch.isfinite(out).all()


def test_params_from_numpy_keeps_tree():
    tree = {"layers": [{"fp": {"P": {"w": np.ones((2, 3)), "b": np.zeros(3)}}}],
            "head": {"w": np.eye(3, dtype=np.float64), "b": np.zeros(3)}}
    out = params_from_numpy(tree, "cpu")
    assert _shapes(out) == _shapes(tree)
    assert out["head"]["w"].dtype == torch.float32
    assert torch.equal(out["layers"][0]["fp"]["P"]["w"], torch.ones(2, 3))


@pytest.mark.parametrize("kw,match", [
    (dict(shard="relation", na_executor="jnp"), "requires na_executor='banded'"),
    (dict(shard="edge_block", mesh_shape=(0,)), "positive ints"),
])
def test_unported_spec_values_raise(kw, match):
    """Sharding is ported: the spec values it cannot run raise the
    reference's ``ValueError`` (a sharded segment-sum executor, an empty
    rank count)."""
    with pytest.raises(ValueError, match=match):
        ExecutorSpec(device="cpu", **kw)


def test_spec_takes_the_segment_sum_executor():
    spec = ExecutorSpec(na_executor="jnp", device="cpu")
    assert spec.pack is False and spec.restructure
    assert not spec.pipeline_config().pack
    assert ExecutorSpec(na_executor="jnp", pack=True, device="cpu").pack


@pytest.mark.parametrize("ds", sorted(WORKLOADS))
@pytest.mark.parametrize("model", MODELS)
def test_jnp_forward_matches_reference(sessions, ds, model):
    """The segment-sum executor (``na_executor="jnp"``) against the
    reference's, and against the port's banded forward."""
    _, _, targets, target_type = WORKLOADS[ds]
    g_ref, g_port = sessions["ref_graphs"][ds], sessions["port_graphs"][ds]
    kw = dict(model=model, hidden=32, num_layers=2, num_classes=3,
              target_type=target_type)
    c_ref = ref_api.Session(ref_api.ExecutorSpec(na_executor="jnp")).compile(
        g_ref, targets, RefConfig(**kw))
    p_ref = c_ref.init(0)
    want = np.asarray(c_ref.forward(p_ref, ref_api.device_features(g_ref)))
    c_port = Session(ExecutorSpec(na_executor="jnp", device="cpu")).compile(
        g_port, targets, HGNNConfig(**kw))
    assert [type(g).__name__ for g in c_port.graphs] == ["SemanticGraphBatch"] * 3
    params = params_from_numpy(jax.tree.map(np.asarray, p_ref), "cpu")
    got = c_port.forward(params, device_features(g_port, "cpu"))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    banded = sessions["port"].compile(g_port, targets, HGNNConfig(**kw))
    np.testing.assert_allclose(
        got.numpy(), banded.forward(params, device_features(g_port, "cpu")).numpy(),
        atol=1e-4)


def test_executor_and_batches_must_agree(sessions):
    _, _, targets, target_type = WORKLOADS["acm_small"]
    c = sessions["port"].compile(sessions["port_graphs"]["acm_small"], targets,
                                 HGNNConfig(model="rgcn", hidden=8, num_layers=1,
                                            target_type=target_type))
    feats = device_features(sessions["port_graphs"]["acm_small"], "cpu")
    with pytest.raises(TypeError, match="SemanticGraphBatch"):
        c.model.execute(c.init(0), feats, c.graphs, na_executor="jnp")
    with pytest.raises(ValueError, match="unknown na_executor"):
        c.model.execute(c.init(0), feats, c.graphs, na_executor="segment")


@pytest.mark.parametrize("kw", [
    dict(pack=False),
    dict(restructure=False),
    dict(planner="greedy"),
    dict(na_executor="segment"),
    dict(device="tpu"),
    dict(device="not-a-device"),
])
def test_spec_validation(kw):
    with pytest.raises(ValueError):
        ExecutorSpec(**{"device": "cpu", **kw})


def test_spec_resolves_pack_and_lowers_to_pipeline():
    spec = ExecutorSpec(device="cpu")
    assert spec.na_executor == "banded" and spec.pack is True
    cfg = spec.pipeline_config()
    assert cfg.pack and cfg.restructure and cfg.renumbered


@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:1"])
def test_device_sgb_spec_lowers_to_pipeline(device):
    spec = ExecutorSpec(sgb_backend="device", device=device)
    cfg = spec.pipeline_config()
    assert cfg.backend == "device" and cfg.device == device
    assert cfg.pack and cfg.restructure
    assert ExecutorSpec(device=device).pipeline_config().backend == "host"


def test_session_reuses_frontend_and_packings(sessions):
    _, _, targets, target_type = WORKLOADS["acm_small"]
    graph = sessions["port_graphs"]["acm_small"]
    sess = Session(ExecutorSpec(device="cpu"))
    cfgs = [HGNNConfig(model=m, hidden=16, num_layers=1, target_type=target_type)
            for m in MODELS]
    compiled = [sess.compile(graph, targets, c) for c in cfgs]
    assert sess.compile(graph, targets, cfgs[0]) is compiled[0]
    st = sess.stats()
    assert st.compiles == 4 and st.compiles_cached == 1
    assert st.frontend_runs == 1 and st["frontend_served"] == 2
    for b0, b1 in zip(compiled[0].graphs, compiled[2].graphs):
        assert b1 is b0  # one BandedBatch (and PackedEdges) per semantic graph
        assert b0.packed is compiled[0].frontend.packed[b0.metapath]
    assert compiled[1].num_target == graph.num_vertices["P"]


# ------------------------------------------- the segment-sum executor's sums --
def _segments(rng, e, n, shape=()):
    """Segment ids over ``n`` segments (some left empty) and values spanning
    six decades, so that the order of a sum shows in its bits."""
    seg = torch.from_numpy(rng.integers(0, n - 3, e))
    x = (rng.standard_normal((e,) + shape) * 10.0 ** rng.uniform(-3, 3, (e,) + shape))
    return torch.from_numpy(x.astype(np.float32)), seg


@pytest.mark.parametrize("e,n,shape", [(20000, 400, (64,)), (5000, 40, ()), (9, 7, (3,))])
def test_segment_sum_is_index_add_on_the_cpu(e, n, shape):
    """``segment_sum`` sums each segment in index order with no atomics:
    on the CPU bitwise ``index_add_`` (which adds in index order too),
    within 1e-6 relative of a float64 oracle, empty segments 0, and
    unchanged when edges of different segments are permuted while each
    segment keeps its own order."""
    from repro_torch.core.hgnn.layers import segment_sum

    rng = np.random.default_rng(e + n)
    x, seg = _segments(rng, e, n, shape)
    got = segment_sum(x, seg, n)
    want = x.new_zeros((n,) + shape).index_add_(0, seg, x)
    assert torch.equal(got, want)
    oracle = x.double().new_zeros((n,) + shape).index_add_(0, seg, x.double())
    scale = torch.zeros((n,) + shape, dtype=torch.float64).index_add_(0, seg, x.double().abs())
    assert float(((got.double() - oracle).abs() / scale.clamp(min=1e-300)).max()) <= 1e-6
    assert float(got[n - 3:].abs().max()) == 0.0
    # a stable sort by a random rank of each segment: segments interleave
    # otherwise, every segment's edges keep their relative order
    perm = torch.from_numpy(np.argsort(rng.permutation(n)[seg.numpy()], kind="stable"))
    assert torch.equal(segment_sum(x[perm], seg[perm], n), got)


def test_segment_gather_backward_is_the_segment_sum():
    """``gather``'s gradient is ``segment_sum`` over its indices, bitwise
    autograd's gradient of ``x[idx]`` on the CPU, and ``segment_sum``'s is
    the gather; the order of a segment is memoised on its index tensor."""
    from repro_torch.core.hgnn.layers import gather, segment_order, segment_sum

    rng = np.random.default_rng(3)
    g, idx = _segments(rng, 3000, 50, (8,))
    x = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32))
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    (da,) = torch.autograd.grad(gather(xa, idx), xa, g)
    (db,) = torch.autograd.grad(xb[idx], xb, g)
    assert torch.equal(da, db)
    y = torch.from_numpy(rng.standard_normal((3000, 8)).astype(np.float32)).requires_grad_(True)
    gy = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32))
    (dy,) = torch.autograd.grad(segment_sum(y, idx, 50), y, gy)
    assert torch.equal(dy, gy[idx])
    order, lengths = segment_order(idx, 50)
    assert segment_order(idx, 50)[0] is order and int(lengths.sum()) == 3000
    with pytest.raises(ValueError, match="beyond 10 segments"):
        segment_order(idx, 10)
