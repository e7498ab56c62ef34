"""Port device SGB parity: the block-sparse SpGEMM composition of
``repro_torch`` (its plain version, on the CPU) against the JAX package's
K3 Pallas kernel in interpret mode and against the host join — the SpGEMM
itself, the device composer for every planner, the frontend pipeline and
the ``sgb_backend="device"`` session.  Products and counters must be
exactly equal; logits within the reference suite's 1e-4."""
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

import repro.api as ref_api  # noqa: E402
from repro.core import sgb as ref_sgb  # noqa: E402
from repro.core.hgnn import HGNNConfig as RefConfig  # noqa: E402
from repro.hetero.graph import Relation as RefRelation  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402
from repro.kernels import spgemm_bsr as ref_spgemm  # noqa: E402
from repro.pipeline import (FrontendPipeline as RefPipeline,  # noqa: E402
                            PipelineConfig as RefPipelineConfig,
                            SemanticGraphCache as RefCache)
from repro_torch.api import ExecutorSpec, Session, device_features  # noqa: E402
from repro_torch.core import sgb  # noqa: E402
from repro_torch.core.hgnn import HGNNConfig, params_from_numpy  # noqa: E402
from repro_torch.hetero import Relation, make_dataset  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.spgemm_bsr import (TILE, compose_dense_blocked,  # noqa: E402
                                            compose_padded_blocked,
                                            pad_to_tiles, spgemm_bsr,
                                            spgemm_macs_ref, spgemm_plain,
                                            spgemm_ref, tile_occupancy)
from repro_torch.pipeline import (FrontendPipeline, PipelineConfig,  # noqa: E402
                                  SemanticGraphCache)

# (dataset, fixture scale, targets, target type): the conftest fixtures'
# scales, the SGB targets of each dataset
WORKLOADS = {
    "ACM": (0.15, ["APA", "PAP", "PSP"], "P"),
    "IMDB": (0.2, ["AMA", "MAM", "MKM"], "M"),
    "DBLP": (0.1, ["APA", "APTPA", "APVPA"], "A"),
}
PLANNERS = ["naive", "ctt", "ctt_dp"]
MODELS = ["rgcn", "rgat", "shgn"]
_PACKED_FIELDS = ("src_local", "dst_local", "band", "dst_tile",
                  "first_in_tile", "count", "edge_block_id", "edge_slot")


def _equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _same_edges(mine, ref) -> bool:
    return (mine.num_src, mine.num_dst) == (ref.num_src, ref.num_dst) and (
        _equal(mine.src, ref.src) and _equal(mine.dst, ref.dst))


def _costs(res):
    return [(repr(st), c.macs, c.bytes_read, c.bytes_written) for st, c in res.per_step]


@pytest.fixture(scope="module")
def graphs(acm_small, imdb_small, dblp_small):
    """(reference graph, port graph) per dataset at fixture scale."""
    ref = {"ACM": acm_small, "IMDB": imdb_small, "DBLP": dblp_small}
    return {name: (ref[name], make_dataset(name, scale=WORKLOADS[name][0]))
            for name in WORKLOADS}


# ------------------------------------------------------------ relations --
@pytest.mark.parametrize("rel", ["AP", "PS", "PP"])
def test_dense_forms_round_trip(graphs, rel):
    g_ref, g = graphs["ACM"]
    r, mine = g_ref.relation(rel), g.relation(rel)
    assert _equal(mine.dense(), r.dense())
    padded = mine.dense_padded("cpu", TILE)
    assert padded.dtype == torch.uint8
    assert padded.shape == tuple(-(-s // TILE) * TILE for s in r.dense().shape)
    assert _equal(padded.numpy(), pad_to_tiles(r.dense().astype(np.uint8)))
    want = RefRelation.from_dense(r.src_type, r.dst_type, r.dense())
    for back in (Relation.from_dense(mine.src_type, mine.dst_type, mine.dense()),
                 Relation.from_dense(mine.src_type, mine.dst_type,
                                     padded[:mine.num_src, :mine.num_dst])):
        assert _same_edges(back, want) and _same_edges(back, mine)


# --------------------------------------------------------------- SpGEMM --
def test_compose_dense_blocked_matches_jax_on_acm(graphs):
    g_ref, g = graphs["ACM"]
    a, b = g_ref.relation("AP").dense(), g_ref.relation("PA").dense()
    want, want_stats = ref_spgemm.compose_dense_blocked(a, b)
    got, stats = compose_dense_blocked(g.relation("AP").dense(), g.relation("PA").dense())
    assert got.dtype == torch.float32 and _equal(got.numpy(), want)
    assert stats == want_stats
    oracle = np.asarray(ref_oracles.spgemm_ref(jnp.asarray(a), jnp.asarray(b)))
    assert _equal(spgemm_ref(a, b).numpy(), oracle)
    got_ops, stats_ops = ops.compose_boolean(a, b)
    assert _equal(got_ops.numpy(), want) and stats_ops == want_stats


def test_spgemm_sparse_skips_tiles():
    rng = np.random.default_rng(7)
    n = 512
    a = np.zeros((n, n), np.float32)
    a[:128, :128] = rng.random((128, 128)) < 0.05
    a[300:400, 300:400] = rng.random((100, 100)) < 0.05
    want, want_stats = ref_spgemm.compose_dense_blocked(a, a)
    got, stats = compose_dense_blocked(a, a)
    assert _equal(got.numpy(), want) and stats == want_stats
    assert stats["tile_pairs_live"] < stats["tile_pairs_total"] * 0.5


@pytest.mark.parametrize("seed,m,k,n,density", [
    (0, 1, 1, 1, 0.0),
    (1, 37, 200, 129, 0.2),
    (2, 300, 130, 250, 0.05),
    (3, 130, 400, 90, 0.01),
    (4, 257, 257, 257, 0.002),
    (5, 200, 56, 300, 0.1),
])
def test_compose_dense_random_matches_jax(seed, m, k, n, density):
    rng = np.random.default_rng(seed)
    a = (rng.random((m, k)) < density).astype(np.float32)
    b = (rng.random((k, n)) < density).astype(np.float32)
    want, want_stats = ref_spgemm.compose_dense_blocked(a, b)
    got, stats = compose_dense_blocked(a, b)
    assert _equal(got.numpy(), want) and stats == want_stats
    oracle = np.asarray(ref_oracles.spgemm_ref(jnp.asarray(a), jnp.asarray(b)))
    assert _equal(got.numpy(), oracle)
    # the uint8 form the composer stores gives the same product
    got8, _ = compose_dense_blocked(a.astype(np.uint8), b.astype(np.uint8))
    assert got8.dtype == torch.uint8 and _equal(got8.numpy(), want.astype(np.uint8))
    assert spgemm_macs_ref(pad_to_tiles(a), pad_to_tiles(b)) == \
        ref_oracles.spgemm_macs_ref(a, b)


def test_stale_occupancy_matches_jax_kernel():
    """A cleared bit on a nonzero tile drops that tile's pairs, in the
    plain version as in the TPU kernel."""
    rng = np.random.default_rng(3)
    a = pad_to_tiles((rng.random((300, 260)) < 0.02).astype(np.float32))
    b = pad_to_tiles((rng.random((260, 200)) < 0.02).astype(np.float32))
    ao, bo = tile_occupancy(a), tile_occupancy(b)
    assert ao[1] == 1 and bo[2] == 1
    ao[1] = 0  # tile (0, 1) of A holds ones
    bo[2] = 0  # tile (1, 0) of B holds ones
    want = np.asarray(ref_spgemm.spgemm_bsr(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(ao), jnp.asarray(bo),
        interpret=True))
    assert not np.array_equal(want, np.asarray(ref_oracles.spgemm_ref(a, b)))
    got, occ = spgemm_bsr(torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(ao), torch.from_numpy(bo))
    assert _equal(got.numpy(), want)
    assert _equal(occ.numpy(), ref_spgemm.tile_occupancy(want))
    plain, _ = spgemm_plain(torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(ao), torch.from_numpy(bo))
    assert torch.equal(plain, got)
    out, out_occ, stats = compose_padded_blocked(a, b, ao, bo)
    _, _, want_stats = ref_spgemm.compose_padded_blocked(a, b, ao, bo)
    assert _equal(out.numpy(), want) and torch.equal(out_occ, occ)
    assert stats == want_stats


def test_spgemm_wrapper_rejects_other_devices():
    a = torch.zeros((TILE, TILE), dtype=torch.uint8, device="meta")
    occ = torch.ones((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        spgemm_bsr(a, a, occ, occ)


# ------------------------------------------------------- device composer --
@pytest.fixture(scope="module")
def jax_device_sgb(graphs):
    """JAX device SGB (K3 in interpret mode) per (dataset, planner)."""
    out = {}
    for name, (g_ref, _) in graphs.items():
        targets = WORKLOADS[name][1]
        for planner in PLANNERS:
            plan = ref_sgb.make_plan(g_ref, targets, planner=planner)
            out[name, planner] = ref_sgb.execute_plan(
                g_ref, plan, backend="device", kernel_backend="interpret")
    return out


@pytest.mark.parametrize("name", sorted(WORKLOADS))
@pytest.mark.parametrize("planner", PLANNERS)
def test_execute_plan_device_matches_host_and_jax(graphs, jax_device_sgb, name, planner):
    _, g = graphs[name]
    targets = WORKLOADS[name][1]
    plan = sgb.make_plan(g, targets, planner=planner)
    dev = sgb.execute_plan(g, plan, backend="device", device="cpu")
    host = sgb.execute_plan(g, plan)
    ref = jax_device_sgb[name, planner]
    assert dev.backend == "device" and len(dev.per_step) == len(plan.steps)
    for res in (host, ref):
        assert dev.cost.macs == res.cost.macs
        assert _costs(dev) == _costs(res)
    assert dev.device_stats == ref.device_stats
    assert dev.device_stats["compositions"] == len(plan.steps)
    assert sorted(dev.graphs) == sorted(ref.graphs)
    for mp in {st.out for st in plan.steps} | set(targets):
        assert _same_edges(dev.graphs[mp], host.graphs[mp]), mp
        assert _same_edges(dev.graphs[mp], ref.graphs[mp]), mp
    # extraction follows plan order (the reference iterates a set)
    produced = [k for k in dev.graphs if k not in g.relations]
    assert produced == list(dict.fromkeys(st.out for st in plan.steps))


def test_build_semantic_graphs_device_matches_host(graphs):
    _, g = graphs["DBLP"]
    targets = WORKLOADS["DBLP"][1]
    dev = sgb.build_semantic_graphs(g, targets, backend="device", device="cpu")
    host = sgb.build_semantic_graphs(g, targets)
    assert _costs(dev) == _costs(host)
    for t in targets:
        assert _same_edges(dev.graphs[t], host.graphs[t])
    # DBLP is where occupancy pruning removes work at this scale
    assert dev.device_stats["tile_pairs_live"] < dev.device_stats["tile_pairs_total"]


def test_composer_over_preloaded_products(graphs):
    """A cache-aware plan composes from a preloaded semantic graph."""
    _, g = graphs["ACM"]
    apa = sgb.build_semantic_graphs(g, ["APA"]).graphs["APA"]
    plan = sgb.make_plan(g, ["APAPA"], preloaded=["APA"])
    assert [repr(s) for s in plan.steps] == ["APA ∘ APA -> APAPA"]
    dev = sgb.execute_plan(g, plan, backend="device", device="cpu",
                           preloaded={"APA": apa})
    cold = sgb.build_semantic_graphs(g, ["APAPA"], planner="ctt")
    assert _same_edges(dev.graphs["APAPA"], cold.graphs["APAPA"])
    assert dev.per_step[0][1].macs == sgb.execute_plan(
        g, plan, preloaded={"APA": apa}).per_step[0][1].macs


# ------------------------------------------------------------- pipeline --
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_pipeline_device_products_bitwise_equal(graphs, name):
    g_ref, g = graphs[name]
    targets = WORKLOADS[name][1]
    dev = FrontendPipeline(PipelineConfig(backend="device", device="cpu", pack=True),
                           cache=SemanticGraphCache()).run(g, targets)
    host = FrontendPipeline(PipelineConfig(pack=True),
                            cache=SemanticGraphCache()).run(g, targets)
    ref = RefPipeline(RefPipelineConfig(backend="device", kernel_backend="jnp",
                                        pack=True), cache=RefCache()).run(g_ref, targets)
    assert dev.sgb.backend == "device" and dev.cold
    assert _costs(dev.sgb) == _costs(host.sgb)
    for mp in targets:
        for other in (host, ref):
            assert _same_edges(dev.semantic[mp], other.semantic[mp]), mp
            for a, b in zip(dev.restructured[mp].permutations(),
                            other.restructured[mp].permutations()):
                assert _equal(a, b), mp
            for f in _PACKED_FIELDS:
                assert _equal(getattr(dev.packed[mp], f),
                              getattr(other.packed[mp], f)), (mp, f)


def test_device_pipeline_over_host_cache_runs_no_sgb(graphs):
    _, g = graphs["ACM"]
    targets = WORKLOADS["ACM"][1]
    cache = SemanticGraphCache()
    host = FrontendPipeline(PipelineConfig(), cache=cache).run(g, targets)
    dev = FrontendPipeline(PipelineConfig(backend="device", device="cpu"),
                           cache=cache).run(g, targets)
    assert host.cold and dev.sgb is None
    for mp in targets:
        assert dev.semantic[mp] is host.semantic[mp]


# -------------------------------------------------------------- session --
@pytest.fixture(scope="module")
def sessions():
    """Port sessions (device SGB and host SGB, CPU) and the JAX sessions
    they are held to, each with its own cache."""
    return {
        "port_device": Session(ExecutorSpec(sgb_backend="device", device="cpu")),
        "port_host": Session(ExecutorSpec(device="cpu")),
        "ref_device": ref_api.Session(ref_api.ExecutorSpec(
            sgb_backend="device", kernel_backend="interpret", na_executor="banded")),
        "ref_host": ref_api.Session(ref_api.ExecutorSpec(
            kernel_backend="interpret", na_executor="banded")),
    }


@pytest.mark.parametrize("name,ref_kind", [("ACM", "ref_device"), ("DBLP", "ref_host")])
@pytest.mark.parametrize("model", MODELS)
def test_device_sgb_session_logits(graphs, sessions, name, ref_kind, model):
    g_ref, g = graphs[name]
    _, targets, target_type = WORKLOADS[name]
    kw = dict(model=model, hidden=32, num_layers=2, num_classes=3,
              target_type=target_type)
    c_ref = sessions[ref_kind].compile(g_ref, targets, RefConfig(**kw))
    p_ref = c_ref.init(0)
    want = np.asarray(c_ref.forward(p_ref, ref_api.device_features(g_ref)))
    params = params_from_numpy(jax.tree.map(np.asarray, p_ref), "cpu")
    feats = device_features(g, "cpu")
    c_dev = sessions["port_device"].compile(g, targets, HGNNConfig(**kw))
    c_host = sessions["port_host"].compile(g, targets, HGNNConfig(**kw))
    assert c_dev.frontend.config.backend == "device"
    got = c_dev.forward(params, feats)
    assert torch.equal(got, c_host.forward(params, feats))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
