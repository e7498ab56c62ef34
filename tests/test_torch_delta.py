"""Port parity for incremental graphs: ``GraphDelta`` and ``apply_delta``,
the cache's migration and lineage, the block-splice repack, the frontend's
delta path, ``Session.compile_delta`` and the extractor's memo migration,
held against the JAX package (``repro.hetero.delta``, ``repro.pipeline``,
``repro.api``) on the same seeded inputs, and against a cold port rebuild
of the mutated graph.

The invariant at every layer: the delta path's products are bitwise equal
to a cold rebuild.  The port adds one risk the reference cannot have: the
row kernels read memoized row views and device copies of a packing, so a
spliced packing must start with none of its predecessor's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

# PyTorch's CPU build can return a wrong result for the first vectorized
# float op of a fresh process (ROADMAP, queue 3); a throwaway call first.
torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))

import jax  # noqa: E402

import repro.api as ref_api  # noqa: E402
from repro.core.hgnn import HGNNConfig as RefConfig  # noqa: E402
from repro.hetero import GraphDelta as RefDelta  # noqa: E402
from repro.kernels.seg_sum import pack_edge_blocks as ref_pack  # noqa: E402
from repro.kernels.seg_sum import \
    splice_pack_edge_blocks as ref_splice  # noqa: E402
from repro.pipeline import FrontendPipeline as RefPipeline  # noqa: E402
from repro.pipeline import PipelineConfig as RefPipelineConfig  # noqa: E402
from repro.pipeline import SemanticGraphCache as RefCache  # noqa: E402
from repro_torch.api import ExecutorSpec, Session, device_features  # noqa: E402
from repro_torch.core.hgnn import HGNNConfig, params_from_numpy  # noqa: E402
from repro_torch.hetero import GraphDelta, HetGraph, Relation, make_dataset  # noqa: E402
from repro_torch.kernels.seg_sum import (pack_edge_blocks,  # noqa: E402
                                         pack_edge_blocks_reference,
                                         seg_sum_plain,
                                         splice_pack_edge_blocks)
from repro_torch.pipeline import (FrontendPipeline, PipelineConfig,  # noqa: E402
                                  SemanticGraphCache)

TARGETS = ["APA", "PAP", "PSP"]
LOGIT_ATOL = 1e-4  # tests/test_subgraph.py:106
PACKED_FIELDS = ("src_local", "dst_local", "band", "dst_tile", "first_in_tile",
                 "count", "edge_block_id", "edge_slot")
MEMOS = ("_valid_mask", "_flat_edges", "_tile_blocks", "_tile_edges",
         "_row_edges", "_src_edges", "_device", "_device_src")


@pytest.fixture(scope="module")
def acm():
    """The port's ACM at scale 0.15 (the reference suite's ``acm_small``)."""
    return make_dataset("ACM", scale=0.15)


def _pipe(cache=None):
    return FrontendPipeline(PipelineConfig(planner="ctt", backend="host", pack=True),
                            cache=cache if cache is not None else SemanticGraphCache())


def _ref_pipe(cache=None):
    return RefPipeline(RefPipelineConfig(planner="ctt", backend="host", pack=True),
                       cache=cache if cache is not None else RefCache())


def _delta_parts(graph, kind, seed):
    """``(add_edges, remove_edges, add_vertices)`` of a seeded delta of one
    kind: ``insert`` (PS edges), ``remove`` (existing PA edges), ``grow``
    (P grows by 3 vertices, each with one PA edge) or ``mixed`` (random
    relations, insert or remove, sometimes a grown type)."""
    rng = np.random.default_rng(seed)
    if kind == "insert":
        r = graph.relations["PS"]
        return ({"PS": (rng.integers(0, r.num_src, 6), rng.integers(0, r.num_dst, 6))},
                {}, {})
    if kind == "remove":
        r = graph.relations["PA"]
        take = rng.choice(r.src.size, size=5, replace=False)
        return {}, {"PA": (r.src[take], r.dst[take])}, {}
    if kind == "grow":
        n_p = graph.num_vertices["P"]
        a = rng.integers(0, graph.num_vertices["A"], 3)
        return {"PA": (np.arange(n_p, n_p + 3), a)}, {}, {"P": 3}
    add, rem, grow = {}, {}, {}
    names = sorted(graph.relations)
    for rname in rng.choice(names, size=rng.integers(1, 3), replace=False):
        r = graph.relations[rname]
        k = int(rng.integers(1, 9))
        if r.src.size > k and rng.random() < 0.3:
            take = rng.choice(r.src.size, size=k, replace=False)
            rem[rname] = (r.src[take], r.dst[take])
        else:
            add[rname] = (rng.integers(0, r.num_src, k), rng.integers(0, r.num_dst, k))
    if rng.random() < 0.25:
        grow[str(rng.choice(sorted(graph.num_vertices)))] = int(rng.integers(1, 4))
    return add, rem, grow


def _deltas(graph, kind, seed):
    """The same seeded delta for both packages: ``(port, reference)``."""
    add, rem, grow = _delta_parts(graph, kind, seed)
    return (GraphDelta(add_edges=add, remove_edges=rem, add_vertices=grow),
            RefDelta(add_edges=add, remove_edges=rem, add_vertices=grow))


def _assert_graph_equal(port, ref):
    assert port.num_vertices == ref.num_vertices
    assert port.feature_dims == ref.feature_dims
    assert sorted(port.relations) == sorted(ref.relations)
    for name, r in port.relations.items():
        q = ref.relations[name]
        assert (r.src_type, r.dst_type, r.num_src, r.num_dst) == (
            q.src_type, q.dst_type, q.num_src, q.num_dst)
        assert r.src.dtype == q.src.dtype and r.dst.dtype == q.dst.dtype
        np.testing.assert_array_equal(r.src, q.src, err_msg=name)
        np.testing.assert_array_equal(r.dst, q.dst, err_msg=name)
    for t, f in port.features.items():
        assert f.dtype == ref.features[t].dtype
        np.testing.assert_array_equal(f, ref.features[t], err_msg=t)
    assert port.fingerprint() == ref.fingerprint()


def _assert_packed_equal(a, b, what=""):
    assert (a.num_src, a.num_dst, a.num_blocks) == (b.num_src, b.num_dst, b.num_blocks)
    for f in PACKED_FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f"{what}{f}"
        np.testing.assert_array_equal(x, y, err_msg=f"{what}{f}")


def _assert_frontend_equal(a, b, targets):
    """Bitwise equality of every frontend product for ``targets`` (``b``
    may come from either package)."""
    for mp in targets:
        ra, rb = a.semantic[mp], b.semantic[mp]
        assert (ra.num_src, ra.num_dst) == (rb.num_src, rb.num_dst)
        np.testing.assert_array_equal(ra.src, rb.src)
        np.testing.assert_array_equal(ra.dst, rb.dst)
        for pa, pb in zip(a.restructured[mp].permutations(),
                          b.restructured[mp].permutations()):
            np.testing.assert_array_equal(pa, pb)
        _assert_packed_equal(a.packed[mp], b.packed[mp], f"{mp}.")


def _assert_rows_equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------ delta value --
@pytest.mark.parametrize("case", ["relation", "vertex_type", "range", "absent"])
def test_apply_delta_validates_like_the_reference(acm, acm_small, case):
    """Each malformed delta raises the reference's ``ValueError``."""
    def build(D, g):
        r = g.relations["PS"]
        if case == "relation":
            return g.apply_delta, D.insert("XX", [0], [0]), "unknown relation"
        if case == "vertex_type":
            return g.apply_delta, D(add_vertices={"X": 1}), "unknown vertex type"
        if case == "range":
            return g.apply_delta, D.insert("PS", [r.num_src], [0]), "out of range"
        edge = (r.src[:1], r.dst[:1])
        return (g.apply_delta(D.remove("PS", *edge)).apply_delta,
                D.remove("PS", *edge), "not in the graph")

    for D, g in ((GraphDelta, acm), (RefDelta, acm_small)):
        fn, delta, match = build(D, g)
        with pytest.raises(ValueError, match=match):
            fn(delta)
    with pytest.raises(ValueError, match="matching 1-D"):
        GraphDelta.insert("PS", [0, 1], [0])


@pytest.mark.parametrize("kind,seed", [("insert", 0), ("remove", 1), ("grow", 2),
                                       ("mixed", 3), ("mixed", 4), ("mixed", 5)])
def test_apply_delta_equals_the_reference(acm, acm_small, kind, seed):
    """Graphs and fingerprints of a delta-applied graph equal the
    reference's, character for character, vertex growth included."""
    assert acm.fingerprint() == acm_small.fingerprint()
    d, rd = _deltas(acm, kind, seed)
    g2, r2 = acm.apply_delta(d), acm_small.apply_delta(rd)
    _assert_graph_equal(g2, r2)
    assert d.insert_only == rd.insert_only
    assert d.touched_relations(acm) == rd.touched_relations(acm_small)
    tv, rtv = d.touched_vertices(acm), rd.touched_vertices(acm_small)
    assert sorted(tv) == sorted(rtv)
    for t in tv:
        np.testing.assert_array_equal(tv[t], rtv[t])
    for name in acm.relations:
        a, b = d.delta_relation(acm, name), rd.delta_relation(acm_small, name)
        assert (a.num_src, a.num_dst) == (b.num_src, b.num_dst)
        np.testing.assert_array_equal(a.src, b.src)
        np.testing.assert_array_equal(a.dst, b.dst)
    if kind == "grow":
        assert g2.num_vertices["P"] == acm.num_vertices["P"] + 3
        assert np.all(g2.features["P"][-3:] == 0)
        assert g2.relations["PS"].num_src == acm.relations["PS"].num_src + 3


def test_fingerprint_insertion_order_invariant(acm):
    """A delta-applied graph and an identically rebuilt one hash equal:
    the fingerprint covers the edge set, not the stored order."""
    rng = np.random.default_rng(0)
    r = acm.relations["PS"]
    g2 = acm.apply_delta(GraphDelta.insert("PS", rng.integers(0, r.num_src, 8),
                                           rng.integers(0, r.num_dst, 8)))
    relations = {}
    for name, rel in g2.relations.items():
        perm = rng.permutation(rel.src.size)
        relations[name] = Relation(rel.src_type, rel.dst_type, rel.num_src, rel.num_dst,
                                   rel.src[perm], rel.dst[perm])
    rebuilt = HetGraph(name=g2.name, num_vertices=dict(g2.num_vertices),
                       feature_dims=dict(g2.feature_dims), relations=relations,
                       features=dict(g2.features))
    assert rebuilt.fingerprint() == g2.fingerprint() != acm.fingerprint()


# ---------------------------------------------------------- cache lineage --
@pytest.mark.parametrize("kind,seed", [("insert", 0), ("remove", 1), ("grow", 2)])
def test_cache_migrate_matches_the_reference(acm, acm_small, kind, seed):
    """Moved count, stale keys and lineage equal the reference's; migrated
    products are the same objects, and nothing stays under the old
    fingerprint."""
    cache, rcache = SemanticGraphCache(), RefCache()
    pipe, rpipe = _pipe(cache), _ref_pipe(rcache)
    res = pipe.run(acm, TARGETS)
    rpipe.run(acm_small, TARGETS)
    d, rd = _deltas(acm, kind, seed)
    fp_old = acm.fingerprint()
    fp_new = acm.apply_delta(d).fingerprint()
    touched = d.touched_relations(acm)

    def keep(mp):
        return not any(mp[i:i + 2] in touched for i in range(len(mp) - 1))

    moved, stale = cache.migrate(fp_old, fp_new, keep)
    rmoved, rstale = rcache.migrate(fp_old, fp_new, keep)
    assert moved == rmoved and sorted(stale) == sorted(rstale)
    assert cache.lineage == rcache.lineage == {fp_new: fp_old}
    assert cache.stats.migrations == rcache.stats.migrations == moved
    assert sorted(cache._store) == sorted(rcache._store)
    assert not any(k[1] == fp_old for k in cache._store)
    for mp in TARGETS:
        if keep(mp):
            assert cache.get_packed(fp_new, mp, True, "barycenter", True) is res.packed[mp]
        else:
            assert ("pkd", fp_old, mp, True, "barycenter", True) in stale


def test_pipeline_apply_delta_migrates_and_keeps_objects(acm):
    cache = SemanticGraphCache()
    pipe = _pipe(cache)
    res = pipe.run(acm, TARGETS)
    dres = pipe.apply_delta(acm, GraphDelta.insert("PS", [0], [0]), TARGETS)
    fp_new = dres.graph.fingerprint()
    assert dres.touched == ["PSP"]
    assert cache.lineage[fp_new] == acm.fingerprint()
    assert cache.stats.migrations == dres.migrated > 0
    assert dres.result.cache_stats.migrations == dres.migrated
    assert sorted(dres.result.timings) == ["migrate", "pack", "restructure", "sgb", "total"]
    for mp in ("APA", "PAP"):
        assert dres.result.semantic[mp] is res.semantic[mp]
        assert dres.result.packed[mp] is res.packed[mp]
    assert pipe.run(dres.graph, TARGETS).sgb is None  # pure cache


# -------------------------------------------------------- splice equality --
def _splice_case(kind, seed):
    """An old stream and an edited one: ``insert`` adds a window of fresh
    edges, ``remove`` cuts one out, ``grow`` grows both vertex counts and
    replaces a window with edges that reach the new rows."""
    rng = np.random.default_rng(seed)
    n_src, n_dst = int(rng.integers(40, 900)), int(rng.integers(40, 900))
    e = int(rng.integers(1, 4000))
    src = rng.integers(0, n_src, e).astype(np.int32)
    dst = rng.integers(0, n_dst, e).astype(np.int32)
    i = int(rng.integers(0, e + 1))
    j = i if kind == "insert" else int(rng.integers(i, e + 1))
    k = 0 if kind == "remove" else int(rng.integers(1, 64))
    ns_, nd_ = n_src, n_dst
    if kind == "grow":
        ns_, nd_ = n_src + int(rng.integers(1, 600)), n_dst + int(rng.integers(1, 600))
    ns = np.concatenate([src[:i], rng.integers(0, ns_, k).astype(np.int32), src[j:]])
    nd = np.concatenate([dst[:i], rng.integers(0, nd_, k).astype(np.int32), dst[j:]])
    return src, dst, n_src, n_dst, ns, nd, ns_, nd_


@pytest.mark.parametrize("kind", ["insert", "remove", "grow"])
@pytest.mark.parametrize("seed", [0, 1, 7, 42, 123, 999])
def test_splice_equals_full_pack_and_the_reference(kind, seed):
    """The splice is bitwise a full pack of the edited stream and equal to
    the reference's splice, with the same ``(reused, total)``; nothing of
    the old packing is written."""
    src, dst, n_src, n_dst, ns, nd, ns_, nd_ = _splice_case(kind, seed)
    old = pack_edge_blocks(src, dst, n_src, n_dst)
    before = {f: np.array(getattr(old, f)) for f in PACKED_FIELDS}
    out = splice_pack_edge_blocks(ns, nd, src, dst, old, ns_, nd_)
    ref = ref_splice(ns, nd, src, dst, ref_pack(src, dst, n_src, n_dst), ns_, nd_)
    assert (out is None) == (ref is None)
    if out is None:
        assert ns.size == 0
        return
    spliced, reused, total = out
    assert (reused, total) == ref[1:]
    full = pack_edge_blocks(ns, nd, ns_, nd_)
    assert 0 <= reused <= total == full.num_blocks
    _assert_packed_equal(spliced, full)
    _assert_packed_equal(spliced, ref[0])
    for f in PACKED_FIELDS:
        np.testing.assert_array_equal(getattr(old, f), before[f], err_msg=f)


def test_splice_returns_none_where_the_reference_does():
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([0, 0, 1], np.int32)
    old = pack_edge_blocks(src, dst, 4, 4)
    assert splice_pack_edge_blocks(src[:0], dst[:0], src, dst, old, 4, 4) is None
    assert splice_pack_edge_blocks(src, dst, src, dst, old, 4, 4, edge_block=128) is None
    wide = pack_edge_blocks_reference(src, dst, 4, 4)  # int32 locals
    assert splice_pack_edge_blocks(src, dst, src, dst, wide, 4, 4) is None


@pytest.mark.parametrize("kind", ["insert", "remove", "grow"])
@pytest.mark.parametrize("seed", [0, 7, 42])
def test_spliced_views_equal_a_fresh_packing_and_share_no_memo(kind, seed):
    """The row view, the source-major view, the work lists and the CPU
    device copies of a spliced packing equal a fresh packing's, though the
    old packing's views were all built (and are stale) before the splice."""
    src, dst, n_src, n_dst, ns, nd, ns_, nd_ = _splice_case(kind, seed)
    old = pack_edge_blocks(src, dst, n_src, n_dst)
    old.row_edges(), old.src_edges(), old.device_blocked("cpu")
    old.device_src_edges("cpu"), old.valid_weight(), old.flat_global_edges()
    spliced, _, _ = splice_pack_edge_blocks(ns, nd, src, dst, old, ns_, nd_)
    assert not [m for m in MEMOS if m in vars(spliced)]
    assert spliced.weight is None
    for f in PACKED_FIELDS:
        assert not np.shares_memory(getattr(spliced, f), getattr(old, f)), f
    fresh = pack_edge_blocks(ns, nd, ns_, nd_)
    _assert_rows_equal(spliced.row_edges(), fresh.row_edges())
    _assert_rows_equal(spliced.src_edges(), fresh.src_edges())
    assert spliced.row_edges().row_ptr.size == nd_ + 1
    a, b = spliced.device_blocked("cpu"), fresh.device_blocked("cpu")
    assert sorted(a) == sorted(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    h = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (ns_, 8)).astype(np.float32))
    assert torch.equal(seg_sum_plain(spliced, h), seg_sum_plain(fresh, h))


# --------------------------------------------- pipeline delta == rebuild --
@pytest.mark.parametrize("kind,seed", [("insert", 0), ("remove", 1), ("grow", 2),
                                       ("mixed", 3), ("mixed", 4), ("mixed", 6)])
def test_frontend_apply_delta_equals_rebuild_and_the_reference(acm, acm_small, kind, seed):
    """``FrontendPipeline.apply_delta`` products, ``touched`` and
    ``spliced`` equal a cold port rebuild of the mutated graph and the
    reference's ``apply_delta``."""
    d, rd = _deltas(acm, kind, seed)
    pipe, rpipe = _pipe(), _ref_pipe()
    pipe.run(acm, TARGETS)
    rpipe.run(acm_small, TARGETS)
    dres = pipe.apply_delta(acm, d, TARGETS)
    rres = rpipe.apply_delta(acm_small, rd, TARGETS)
    cold = _pipe().run(acm.apply_delta(d), TARGETS)
    _assert_graph_equal(dres.graph, rres.graph)
    _assert_frontend_equal(dres.result, cold, TARGETS)
    _assert_frontend_equal(dres.result, rres.result, TARGETS)
    assert dres.touched == rres.touched
    assert dres.spliced == rres.spliced
    assert dres.migrated == rres.migrated
    assert dres.result.sgb.device_stats == rres.result.sgb.device_stats


def test_chained_deltas_keep_lineage_and_equality(acm):
    cache = SemanticGraphCache()
    pipe = _pipe(cache)
    pipe.run(acm, TARGETS)
    d1 = GraphDelta.insert("TP", [0, 1], [2, 3])
    r1 = pipe.apply_delta(acm, d1, TARGETS)
    assert r1.touched == []  # TP is outside every target metapath
    d2 = GraphDelta.insert("PS", [5], [1])
    r2 = pipe.apply_delta(r1.graph, d2, TARGETS)
    fp0, fp1, fp2 = (acm.fingerprint(), r1.graph.fingerprint(), r2.graph.fingerprint())
    assert cache.lineage == {fp1: fp0, fp2: fp1}
    cold = _pipe().run(acm.apply_delta(d1).apply_delta(d2), TARGETS)
    _assert_frontend_equal(r2.result, cold, TARGETS)


# ---------------------------------------------------------- compile_delta --
def _cfg(model):
    return dict(model=model, hidden=16, num_layers=2, num_classes=3, target_type="P")


@pytest.mark.parametrize("kind", ["insert", "remove", "grow"])
@pytest.mark.parametrize("executor", ["jnp", "banded"])
def test_compile_delta_logits_bitwise_a_cold_compile_and_near_the_reference(
        acm, acm_small, executor, kind):
    """Successor logits are bitwise a cold port compile's of the mutated
    graph on both executors, and within 1e-4 of the reference's successor
    (its segment-sum executor; reference params carried by
    ``params_from_numpy``)."""
    d, rd = _deltas(acm, kind, 10)
    for model in ("rgcn", "rgat"):
        sess = Session(ExecutorSpec(na_executor=executor, device="cpu"))
        c1 = sess.compile(acm, TARGETS, HGNNConfig(**_cfg(model)))
        rsess = ref_api.Session(ref_api.ExecutorSpec(na_executor="jnp"), cache=RefCache())
        r1 = rsess.compile(acm_small, TARGETS, RefConfig(**_cfg(model)))
        p_ref = r1.init(0)
        params = params_from_numpy(jax.tree.map(np.asarray, p_ref), "cpu")
        c1.forward(params, device_features(acm, "cpu"))
        c2, g2, dres = sess.compile_delta(c1, acm, d)
        r2, rg2, _ = rsess.compile_delta(r1, acm_small, rd)
        assert c2.fingerprint == g2.fingerprint() == rg2.fingerprint()
        cold = Session(ExecutorSpec(na_executor=executor, device="cpu")).compile(
            g2, TARGETS, HGNNConfig(**_cfg(model)))
        if executor == "banded":
            for a, b in zip(c2.graphs, cold.graphs):
                _assert_packed_equal(a.packed, b.packed, f"{a.metapath}.")
                _assert_rows_equal(a.packed.row_edges(), b.packed.row_edges())
        feats = device_features(g2, "cpu")
        got = c2.forward(params, feats)
        assert got.shape == (g2.num_vertices["P"], 3)
        assert torch.equal(got, cold.forward(params, feats)), (model, executor, kind)
        want = np.asarray(r2.forward(p_ref, ref_api.device_features(rg2)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_ATOL)
        assert sess.stats().compiles == 2
        assert sess.compile(g2, TARGETS, HGNNConfig(**_cfg(model))) is c2


def test_compile_delta_rejects_a_graph_of_another_fingerprint(acm):
    sess = Session(ExecutorSpec(na_executor="jnp", device="cpu"))
    c1 = sess.compile(acm, TARGETS, HGNNConfig(**_cfg("rgcn")))
    g2 = acm.apply_delta(GraphDelta.insert("TP", [0], [0]))
    with pytest.raises(ValueError, match="fingerprint"):
        sess.compile_delta(c1, g2, GraphDelta.insert("TP", [1], [1]))


# ------------------------------------------------------ extractor migration --
@pytest.mark.parametrize("executor", ["jnp", "banded"])
@pytest.mark.parametrize("delta", ["off_metapath", "insert", "grow"])
def test_migrate_from_adopts_like_the_reference(acm, acm_small, executor, delta):
    """The successor's extractor adopts as many entries as the reference's;
    the banded flavor drops every one once a target metapath was repacked,
    and an off-metapath delta keeps them all with the dependency
    signature set shared, so no new trace."""
    if delta == "off_metapath":
        parts = ({"TP": (np.array([0, 1, 2]), np.array([3, 4, 5]))}, {}, {})
    else:
        parts = _delta_parts(acm, delta, 5)
    d, rd = (GraphDelta(*parts), RefDelta(*parts))
    cfg = _cfg("rgcn")
    sess = Session(ExecutorSpec(na_executor=executor, device="cpu"))
    c1 = sess.compile(acm, TARGETS, HGNNConfig(**cfg))
    rsess = ref_api.Session(ref_api.ExecutorSpec(na_executor=executor), cache=RefCache())
    r1 = rsess.compile(acm_small, TARGETS, RefConfig(**cfg))
    rng = np.random.default_rng(3)
    id_sets = [np.unique(rng.integers(0, c1.num_target, size=n)) for n in (1, 2, 3, 5, 8)]
    params = c1.init(0)
    feats = device_features(acm, "cpu")
    for ids in id_sets:
        c1.dependency_subset(ids)
        r1.dependency_subset(ids)
    c1.forward_subset(params, feats, id_sets[0], mode="dependency")
    t0 = c1.dependency_traces
    c2, g2, dres = sess.compile_delta(c1, acm, d)
    r2, _, rdres = rsess.compile_delta(r1, acm_small, rd)
    assert dres.touched == rdres.touched
    adopted = len(c2._extractor._memo)
    assert adopted == len(r2._extractor._memo)
    assert sorted(c2._extractor._memo) == sorted(r2._extractor._memo)
    if executor == "banded" and dres.touched:
        assert adopted == 0
    if delta == "off_metapath":
        assert adopted == len(id_sets)
        assert c2._dependency_signatures is c1._dependency_signatures
        out = c2.forward_subset(params, device_features(g2, "cpu"), id_sets[0],
                                mode="dependency")
        assert c2.dependency_traces == t0
        assert torch.equal(out, c1.forward_subset(params, feats, id_sets[0],
                                                  mode="dependency"))
    total = sum(g2.num_vertices.values())
    for sub in c2._extractor._memo.values():
        assert sub.total_size == total
    ids = id_sets[-1]
    np.testing.assert_allclose(
        c2.forward_subset(params, device_features(g2, "cpu"), ids, mode="dependency").numpy(),
        c2.forward(params, device_features(g2, "cpu")).numpy()[ids], rtol=0,
        atol=LOGIT_ATOL)
