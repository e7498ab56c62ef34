"""The port's counterparts of the JAX package's public members that the
port gained last (the paper's SGB, CTT and GFP accounting, the session,
pipeline and cache members, and the arguments the counterparts did not
take) against the reference on the same seeded inputs, on the CPU."""
import dataclasses

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
import repro.train.hgnn_step as ref_step  # noqa: E402
import repro.train.optim as ref_optim  # noqa: E402
from repro.core import restructure as ref_restructure  # noqa: E402
from repro.core import sgb as ref_sgb  # noqa: E402
from repro.core.ctt import CallbackTrieTree as RefCTT  # noqa: E402
from repro.core.hgnn import HGNNConfig as RefConfig  # noqa: E402
from repro.core.hgnn import models as ref_models  # noqa: E402
from repro.hetero import make_dataset as ref_make_dataset  # noqa: E402
from repro.kernels.edge_softmax import block_logits as ref_block_logits  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.pipeline import FrontendPipeline as RefPipeline  # noqa: E402
from repro.pipeline import PipelineConfig as RefPipelineConfig  # noqa: E402
from repro.pipeline import SemanticGraphCache as RefCache  # noqa: E402
from repro.pipeline import default_cache as ref_default_cache  # noqa: E402
from repro_torch.api import ExecutorSpec, Session, device_features  # noqa: E402
from repro_torch.core import restructure, sgb  # noqa: E402
from repro_torch.core.ctt import CallbackTrieTree  # noqa: E402
from repro_torch.core.hgnn import (HGNNConfig, banded_graphs_from_pipeline,  # noqa: E402
                                   graphs_from_pipeline, graphs_from_sgb, init_params,
                                   package_batches)
from repro_torch.core.hgnn.models import SemanticGraphBatch  # noqa: E402
from repro_torch.hetero import make_dataset  # noqa: E402
from repro_torch.kernels.edge_softmax import block_logits  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.pipeline import (FrontendPipeline, PipelineConfig,  # noqa: E402
                                  SemanticGraphCache, default_cache, frontend)
from repro_torch.train import (make_train_step, propagated_feature_labels,  # noqa: E402
                               semi_supervised_masks, train_state_from_numpy, value_and_grad)

# (dataset, the conftest fixture's scale, SGB targets)
WORKLOADS = {
    "ACM": (0.15, ["APA", "PAP", "PSP", "APSPA"]),
    "DBLP": (0.1, ["APA", "APTPA", "APVPA"]),
    "IMDB": (0.2, ["AMA", "MAM", "MDM", "MKM"]),
}
PLANNERS = ("naive", "ctt", "ctt_dp")
CLIP = 0.1


@pytest.fixture(scope="module")
def graphs(acm_small, dblp_small, imdb_small):
    """(reference graph, port graph) per dataset at the fixture's scale."""
    ref = {"ACM": acm_small, "DBLP": dblp_small, "IMDB": imdb_small}
    return {name: (ref[name], make_dataset(name, scale=scale))
            for name, (scale, _) in WORKLOADS.items()}


@pytest.fixture(scope="module")
def frontends(graphs):
    """One pack=True frontend pass per dataset on each side, each on a
    cache of its own."""
    out = {}
    for name, (g_ref, g) in graphs.items():
        targets = WORKLOADS[name][1]
        out[name] = (RefPipeline(RefPipelineConfig(pack=True), cache=RefCache()).run(g_ref, targets),
                     FrontendPipeline(PipelineConfig(pack=True),
                                      cache=SemanticGraphCache()).run(g, targets))
    return out


# ------------------------------------------------------------ hetero --
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_graph_counts_and_metapaths_equal(graphs, name):
    g_ref, g = graphs[name]
    assert g.total_vertices() == g_ref.total_vertices()
    assert g.total_edges() == g_ref.total_edges()
    for hops in (1, 2, 3, 4):
        assert g.enumerate_metapaths(hops) == g_ref.enumerate_metapaths(hops)
        for t in g.vertex_types:
            assert g.enumerate_metapaths(hops, start=t) == g_ref.enumerate_metapaths(hops, start=t)


# --------------------------------------------------------------- SGB --
@pytest.mark.parametrize("planner", PLANNERS)
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_plan_and_cost_accounting_equal(graphs, name, planner):
    """``num_compositions``, MACs and ``total_bytes`` (Figs. 14/15) of one
    plan, per step and in total, and ``target_graphs`` edge for edge."""
    g_ref, g = graphs[name]
    targets = WORKLOADS[name][1]
    plan_ref = ref_sgb.make_plan(g_ref, targets, planner=planner)
    plan = sgb.make_plan(g, targets, planner=planner)
    assert plan.num_compositions == plan_ref.num_compositions == len(plan.steps)
    res_ref, res = ref_sgb.execute_plan(g_ref, plan_ref), sgb.execute_plan(g, plan)
    assert res.cost.macs == res_ref.cost.macs
    assert res.cost.total_bytes == res_ref.cost.total_bytes
    assert res.cost.total_bytes == res.cost.bytes_read + res.cost.bytes_written
    assert [c.total_bytes for _, c in res.per_step] == [c.total_bytes for _, c in res_ref.per_step]
    tg, tg_ref = res.target_graphs(targets), res_ref.target_graphs(targets)
    assert list(tg) == list(tg_ref) == list(targets)
    for t in targets:
        assert np.array_equal(tg[t].src, tg_ref[t].src)
        assert np.array_equal(tg[t].dst, tg_ref[t].dst)


def test_ctt_cost_never_worse_than_naive():
    """The port's counterpart of ``tests/test_ctt.py``'s test of the same
    name, on the port's ACM at the ``acm_mid`` fixture's scale."""
    g = make_dataset("ACM", scale=0.3)
    targets = [m for m in g.enumerate_metapaths(4) if len(m) >= 3][:20]
    rn = sgb.execute_plan(g, sgb.plan_naive(g, targets))
    rc = sgb.execute_plan(g, sgb.plan_ctt(g, targets))
    rd = sgb.execute_plan(g, sgb.plan_ctt_dp(g, targets))
    assert (sgb.plan_ctt(g, targets).num_compositions
            <= sgb.plan_naive(g, targets).num_compositions)
    assert rc.cost.macs <= rn.cost.macs * 1.05
    assert rc.cost.total_bytes <= rn.cost.total_bytes * 1.05
    assert rd.cost.macs <= rc.cost.macs * 1.02
    for t in targets:
        for other in (rc, rd):
            assert np.array_equal(rn.graphs[t].src, other.graphs[t].src)
            assert np.array_equal(rn.graphs[t].dst, other.graphs[t].dst)


def test_reduction_grows_with_metapath_length(graphs):
    """The port's counterpart of ``tests/test_ctt.py``'s test of the same
    name (Figs. 14/15 qualitatively), on the port's ACM at 0.15."""
    g = graphs["ACM"][1]
    ratios = []
    for hops in (3, 5):
        targets = [m for m in g.enumerate_metapaths(hops) if len(m) == hops + 1][:10]
        if not targets:
            continue
        rn = sgb.execute_plan(g, sgb.plan_naive(g, targets))
        rc = sgb.execute_plan(g, sgb.plan_ctt(g, targets))
        ratios.append(rn.cost.macs / max(1, rc.cost.macs))
    assert len(ratios) == 2 and ratios[1] >= ratios[0] >= 1.0


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_ctt_materialized_and_nbytes_equal(graphs, name):
    """The CTT after every target of the workload and of its 3-hop
    enumeration is inserted: the same materialized metapaths in the same
    order, and the same footprint (Table 3's 5 KB CTT buffer)."""
    g_ref, g = graphs[name]
    ctt, ctt_ref = CallbackTrieTree(g.relation_names), RefCTT(g_ref.relation_names)
    assert ctt.materialized() == ctt_ref.materialized()
    for t in WORKLOADS[name][1] + g.enumerate_metapaths(3):
        ctt.insert(t)
        ctt_ref.insert(t)
        assert ctt.nbytes() == ctt_ref.nbytes()
    assert ctt.materialized() == ctt_ref.materialized()
    assert ctt.nbytes() < 5 * 1024


# ------------------------------------------------ restructure, packing --
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_restructure_members_equal(graphs, name):
    """``decouple(rel, seed=)`` (the seed is unused on both sides) and the
    subgraphs' sizes."""
    g_ref, g = graphs[name]
    rel_name = max(g.relations, key=lambda r: g.relations[r].num_edges)
    rel, rel_ref = g.relations[rel_name], g_ref.relations[rel_name]
    for seed in (0, 3):
        ms, md = restructure.decouple(rel, seed=seed)
        ms_ref, md_ref = ref_restructure.decouple(rel_ref, seed=seed)
        assert np.array_equal(ms, ms_ref) and np.array_equal(md, md_ref)
    rg = restructure.recouple(rel, ms, md)
    rg_ref = ref_restructure.recouple(rel_ref, ms_ref, md_ref)
    assert ([(s.kind, s.num_src, s.num_dst, s.num_edges) for s in rg.subgraphs]
            == [(s.kind, s.num_src, s.num_dst, s.num_edges) for s in rg_ref.subgraphs])
    assert sum(s.num_edges for s in rg.subgraphs) == rel.num_edges


@pytest.mark.parametrize("elem_bytes", [4, 2])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_hbm_feature_bytes_equal(frontends, name, elem_bytes):
    """GFP feature traffic of one packing, fp32 (the default) and bf16."""
    res_ref, res = frontends[name]
    for mp in WORKLOADS[name][1]:
        got = res.packed[mp].hbm_feature_bytes(64, elem_bytes)
        assert got == res_ref.packed[mp].hbm_feature_bytes(64, elem_bytes)
        assert got == res.packed[mp].num_blocks * res.packed[mp].src_band * 64 * elem_bytes
    pk = res.packed[WORKLOADS[name][1][0]]
    assert pk.hbm_feature_bytes(64) == pk.hbm_feature_bytes(64, 4)


@pytest.mark.parametrize("renumbered", [True, False])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_packed_weight_and_from_relation_order_bitwise(frontends, name, renumbered):
    """``RestructuredGraph.packed(weight=)`` field for field, the host
    ``block_logits``, and ``SemanticGraphBatch.from_relation(order=)``."""
    res_ref, res = frontends[name]
    mp = WORKLOADS[name][1][-1]
    rg, rg_ref = res.restructured[mp], res_ref.restructured[mp]
    rng = np.random.default_rng(5)
    w = rng.standard_normal(rg.original.num_edges).astype(np.float32)
    pk, pk_ref = rg.packed(renumbered, weight=w), rg_ref.packed(renumbered, weight=w)
    for f in dataclasses.fields(pk_ref):
        a, b = getattr(pk, f.name), getattr(pk_ref, f.name)
        if isinstance(b, np.ndarray):
            assert np.array_equal(np.asarray(a), b), f.name
        else:
            assert a == b, f.name
    assert np.array_equal(block_logits(pk, w), ref_block_logits(pk_ref, w))
    rel = res.semantic[mp]
    order = rng.permutation(rel.num_edges)
    b = SemanticGraphBatch.from_relation(rel, mp, 2, "cpu", order=order)
    b_ref = ref_models.SemanticGraphBatch.from_relation(res_ref.semantic[mp], mp, 2, order)
    assert np.array_equal(b.src.numpy(), np.asarray(b_ref.src))
    assert np.array_equal(b.dst.numpy(), np.asarray(b_ref.dst))
    assert (b.num_src, b.num_dst, b.edge_type_id) == (b_ref.num_src, b_ref.num_dst, 2)


# ---------------------------------------------------- pipeline, cache --
def test_default_pipelines_share_the_process_cache():
    """A pipeline built without a cache takes the process-wide one, as the
    reference's does: a second default pipeline over the same graph reads
    only hits, and both packages count the same hits, misses and hit rate
    in each run.  (The graph's seed is used by no other test, so no entry
    of another test's run is in the process cache.)"""
    targets = WORKLOADS["IMDB"][1]
    counts = []
    for pipe_cls, cfg_cls, graph in (
            (RefPipeline, RefPipelineConfig, ref_make_dataset("IMDB", seed=11, scale=0.05)),
            (FrontendPipeline, PipelineConfig, make_dataset("IMDB", seed=11, scale=0.05))):
        runs = [pipe_cls(cfg_cls()).run(graph, targets) for _ in range(2)]
        counts.append([(r.cache_stats.hits, r.cache_stats.misses) for r in runs])
    assert counts[1] == counts[0]
    assert counts[1][1][0] > 0 and counts[1][1][1] == 0
    assert [r.cache_stats.hit_rate for r in runs] == [0.0, 1.0]


def test_default_cache_is_shared_and_clears():
    """``default_cache()`` is one object, every cache-less pipeline's;
    ``clear`` drops its entries and keeps its counters, as the
    reference's does."""
    assert FrontendPipeline().cache is FrontendPipeline().cache is default_cache()
    assert RefPipeline().cache is ref_default_cache()
    cache = SemanticGraphCache()
    g = make_dataset("ACM", seed=11, scale=0.05)
    FrontendPipeline(PipelineConfig(), cache=cache).run(g, ["APA"])
    before = cache.stats.snapshot()
    assert len(cache) > 0 and before.misses > 0
    cache.clear()
    assert len(cache) == 0 and cache.stats == before
    assert 0.0 <= before.hit_rate < 1.0


def test_run_dataset_memoizes_the_graph_and_matches_the_reference():
    pipe = FrontendPipeline(PipelineConfig(), cache=SemanticGraphCache())
    a = pipe.run_dataset("ACM", ["APA", "PAP"], seed=1, scale=0.05)
    b = pipe.run_dataset("ACM", ["PAP"], seed=1, scale=0.05)
    assert b.sgb is None and b.cache_stats.misses == 0
    assert frontend._dataset("ACM", 1, 0.05) is frontend._dataset("ACM", 1, 0.05)
    ref = RefPipeline(RefPipelineConfig(), cache=RefCache()).run_dataset(
        "ACM", ["APA", "PAP"], seed=1, scale=0.05)
    for mp in ("APA", "PAP"):
        assert np.array_equal(a.semantic[mp].src, ref.semantic[mp].src)
        assert np.array_equal(a.semantic[mp].dst, ref.semantic[mp].dst)


# ---------------------------------------------------- models, session --
def test_batch_builders_and_init_params_hidden_override(frontends, graphs):
    """``graphs_from_sgb`` and ``banded_graphs_from_pipeline`` are the
    result's and ``package_batches``' batches; ``init_params(
    hidden_override=)`` gives the reference's shapes."""
    _, res = frontends["ACM"]
    targets = WORKLOADS["ACM"][1]
    got = graphs_from_sgb(graphs["ACM"][1], res.semantic, targets, restructured=True,
                          restructured_graphs=res.restructured, device="cpu")
    want = package_batches(res.semantic, targets, restructured=True,
                           restructured_graphs=res.restructured, device="cpu")
    assert [(b.metapath, b.src.tolist(), b.dst.tolist()) for b in got] == \
        [(b.metapath, b.src.tolist(), b.dst.tolist()) for b in want]
    assert banded_graphs_from_pipeline(res, "cpu") is res.banded_batches("cpu")
    assert graphs_from_pipeline(res, "cpu") is res.batches("cpu")
    g = graphs["ACM"][1]
    cfg = dict(model="shgn", hidden=16, num_layers=2, target_type="P")
    p = init_params(0, HGNNConfig(**cfg), g.feature_dims, targets, hidden_override=24,
                    device="cpu")
    p_ref = jax.eval_shape(lambda: ref_models.init_params(
        jax.random.key(0), RefConfig(**cfg), g.feature_dims, targets, hidden_override=24))
    shapes = jax.tree.map(lambda x: tuple(x.shape), p_ref)
    assert jax.tree.map(lambda x: tuple(x.shape), p) == shapes
    assert p["head"]["w"].shape == (24, 3)


def test_swiglu_act_matches_reference():
    rng = np.random.default_rng(2)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("w_gate", (8, 12)), ("w_up", (8, 12)), ("w_down", (12, 8)))}
    x = rng.standard_normal((3, 8)).astype(np.float32)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    for act, act_ref in ((None, None), (torch.nn.functional.gelu, jax.nn.gelu)):
        kw, kw_ref = ({}, {}) if act is None else ({"act": lambda t: act(t, approximate="tanh")},
                                                   {"act": act_ref})
        got = layers.swiglu_mlp(pt, torch.from_numpy(x), **kw).numpy()
        want = np.asarray(ref_layers.swiglu_mlp(pj, jnp.asarray(x), **kw_ref))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _memo_keys(sess):
    def norm(key):
        return tuple(dataclasses.astuple(k) if dataclasses.is_dataclass(k) else k for k in key)

    return ([norm(k) for k in sess._frontends], [norm(k) for k in sess._compiled])


def test_session_max_memo_evicts_like_the_reference(graphs):
    """``Session(max_memo=2)``: after every compile the frontend and
    compile memos hold the reference's keys in the reference's LRU order,
    the counters agree, and an evicted ``CompiledHGNN`` keeps working."""
    (acm_ref, acm), (imdb_ref, imdb) = graphs["ACM"], graphs["IMDB"]
    sess = Session(ExecutorSpec(na_executor="jnp", device="cpu"), max_memo=2)
    sess_ref = ref_api.Session(ref_api.ExecutorSpec(na_executor="jnp"), max_memo=2)
    steps = [(acm_ref, acm, ["APA", "PAP"], "rgcn"), (acm_ref, acm, ["APA", "PAP"], "rgat"),
             (imdb_ref, imdb, ["AMA", "MAM"], "rgcn"), (acm_ref, acm, ["APA", "PAP"], "rgcn"),
             (acm_ref, acm, ["PSP"], "shgn"), (imdb_ref, imdb, ["AMA", "MAM"], "rgcn"),
             (acm_ref, acm, ["APA", "PAP"], "rgat")]
    first = None
    for g_ref, g, targets, model in steps:
        kw = dict(model=model, hidden=8, num_layers=1,
                  target_type="P" if g is acm else "M")
        c = sess.compile(g, targets, HGNNConfig(**kw))
        sess_ref.compile(g_ref, targets, RefConfig(**kw))
        first = first or c
        assert _memo_keys(sess) == _memo_keys(sess_ref)
        st, st_ref = sess.stats(), sess_ref.stats()
        assert (st.compiles, st.compiles_cached, st.frontend_runs, st.frontend_served) == \
            (st_ref.compiles, st_ref.compiles_cached, st_ref.frontend_runs,
             st_ref.frontend_served)
    assert len(sess._compiled) == 2 and first not in sess._compiled.values()
    assert first.semantic is first.frontend.semantic
    out = first.forward(first.init(0), device_features(acm, "cpu"))
    assert out.shape == (acm.num_vertices["P"], 3) and torch.isfinite(out).all()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only refusal")
def test_device_features_defaults_to_the_card(graphs):
    """``device_features(graph)`` puts features on the card, as a session
    does, and does not fall back to the CPU when there is none."""
    g = graphs["IMDB"][1]
    with pytest.raises((RuntimeError, AssertionError)):
        device_features(g)
    assert all(t.device.type == "cpu" for t in device_features(g, "cpu").values())


# ---------------------------------------------------------- training --
def test_train_step_clip_norm_trajectory_matches_reference(graphs):
    """Three ``make_train_step(clip_norm=0.1)`` steps from the same
    parameters: losses and first moments within 1e-6 of the reference's,
    and the clip binds (the first gradient's norm is above 0.1, and the
    first moment after one step is 0.1 times the clip, as AdamW's b1 = 0.9
    makes it for a gradient clipped to norm 0.1).  Parameters agree within
    1e-4: AdamW
    divides each gradient entry by its own root mean square, so an entry
    near zero turns a float difference of the forward into a visible one
    (4e-5 at most here, 2 entries of 121,728)."""
    g_ref, g = graphs["ACM"]
    targets = ["APA", "PAP"]
    kw = dict(model="rgcn", hidden=64, num_layers=2, target_type="P")
    ref_c = ref_api.Session(ref_api.ExecutorSpec(na_executor="jnp")).compile(
        g_ref, targets, RefConfig(**kw))
    n = ref_c.num_target
    p_ref = ref_c.init(4)
    labels_ref = ref_step.propagated_feature_labels(ref_c.semantic, targets, g_ref.features, n)
    masks_ref = ref_step.semi_supervised_masks(n, seed=0)
    feats_ref = ref_api.device_features(g_ref)
    step_ref = ref_step.make_train_step(ref_c.model, ref_c.graphs, warmup=1, total=3,
                                        clip_norm=CLIP, executor=ref_c.spec)
    st_ref = ref_step.HGNNTrainState(params=p_ref, opt=ref_optim.adamw_init(p_ref))

    c = Session(ExecutorSpec(na_executor="jnp", device="cpu")).compile(
        g, targets, HGNNConfig(**kw))
    labels = propagated_feature_labels(c.semantic, targets, g.features, n, device="cpu")
    masks = semi_supervised_masks(n, seed=0, device="cpu")
    feats = device_features(g, "cpu")
    p_np = jax.tree.map(np.asarray, p_ref)
    st0 = train_state_from_numpy(p_np, "cpu")
    _, (grads,) = value_and_grad(
        lambda p: c.model.execute_loss(p, feats, c.graphs, labels, mask=masks["train"],
                                       na_executor="jnp"), st0.params)
    norm = float(torch.sqrt(sum(torch.sum(x ** 2) for x in jax.tree.leaves(
        grads, is_leaf=lambda x: isinstance(x, torch.Tensor)))))
    assert norm > 1.2 * CLIP
    step = make_train_step(c.model, c.graphs, warmup=1, total=3, clip_norm=CLIP,
                           executor=c.spec)

    def leaves(tree):
        return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))

    st = st0
    losses, losses_ref = [], []
    for i in range(3):
        st_ref, l_ref = step_ref(st_ref, feats_ref, labels_ref, masks_ref["train"])
        st, loss = step(st, feats, labels, masks["train"])
        losses_ref.append(float(l_ref))
        losses.append(loss.item())
        if i == 0:  # the first moment is (1 - b1) times the clipped gradient
            mu_norm = float(torch.sqrt(sum(torch.sum(x ** 2) for x in leaves(st.opt.mu))))
            np.testing.assert_allclose(mu_norm, 0.1 * CLIP, rtol=1e-5)
    np.testing.assert_allclose(losses, losses_ref, rtol=0, atol=1e-6)
    for a, b in zip(leaves(st.opt.mu), jax.tree.leaves(st_ref.opt.mu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    for a, b in zip(leaves(st.params), jax.tree.leaves(st_ref.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)
