"""Port parity for sharded HGNN execution (``repro_torch.distributed``):
shard plans bitwise equal to the reference's, the mesh helpers, sharded
forwards on 2 and 4 CPU ranks against the reference's banded forward (and
its one-device ``ShardedHGNNExecutor``, interpret mode, as
``tests/test_shard.py`` runs it) and bitwise against the port's own
single-device forward, the compile cache and ``shard_traces``, spec
validation, pinned device groups on 4 ranks, and ``compile_delta`` on a
sharded compile.

The port runs a mesh in one process, so 4 ranks here are 4 CPU ranks
(``REPRO_TORCH_VIRTUAL_DEVICES=4``, or ``devices=[0, 1, 2, 3]`` out of
such a pool), not 4 XLA host devices.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

# PyTorch's CPU build can return a wrong result for the first vectorized
# float op of a fresh process (ROADMAP, queue 3); a throwaway call first.
torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))

import jax  # noqa: E402

import repro.api as ref_api  # noqa: E402
from repro.core.hgnn import HGNNConfig as RefConfig  # noqa: E402
from repro.distributed import build_shard_plan as ref_build_plan  # noqa: E402
from repro.launch.mesh import _balanced_shape as ref_balanced_shape  # noqa: E402
from repro.pipeline import SemanticGraphCache as RefCache  # noqa: E402
from repro_torch.api import ExecutorSpec, Session, device_features  # noqa: E402
from repro_torch.core.hgnn import HGNNConfig, params_from_numpy  # noqa: E402
from repro_torch.distributed import (SHARD_MODES, ShardedHGNNExecutor,  # noqa: E402
                                     build_shard_plan)
from repro_torch.distributed.hgnn import _build_geometry  # noqa: E402
from repro_torch.hetero import GraphDelta, make_dataset  # noqa: E402
from repro_torch.launch.mesh import (VIRTUAL_DEVICES_ENV,  # noqa: E402
                                     _balanced_shape, device_pool,
                                     make_mesh_for)
from repro_torch.pipeline import SemanticGraphCache  # noqa: E402
from repro_torch.serve import HGNNRequest, HGNNServeEngine  # noqa: E402

WORKLOADS = {
    "acm_small": ("ACM", 0.15, ["APA", "PAP", "PSP"], "P"),
    "imdb_small": ("IMDB", 0.2, ["AMA", "MAM", "MDM"], "M"),
}
MODELS = ("rgcn", "rgat", "shgn")
LOGIT_ATOL = 1e-4  # tests/test_shard.py:136
ORACLE_ATOL = 2e-3  # tests/test_shard.py:157, against the segment-sum executor


def _kw(model, target_type, **kw):
    kw.setdefault("hidden", 16)
    kw.setdefault("num_layers", 2)
    return dict(model=model, num_classes=3, target_type=target_type, **kw)


@pytest.fixture(scope="module")
def env(acm_small, imdb_small):
    """Reference sessions (banded, jnp, both sharded modes on its one
    device) and port sessions (banded and both sharded modes on the CPU),
    each side over one shared cache, and both sides' graphs."""
    rc, pc = RefCache(), SemanticGraphCache()
    ref = {"banded": ref_api.Session(ref_api.ExecutorSpec(na_executor="banded"), cache=rc),
           "jnp": ref_api.Session(ref_api.ExecutorSpec(), cache=rc)}
    for mode in SHARD_MODES:
        ref[mode] = ref_api.Session(
            ref_api.ExecutorSpec(na_executor="banded", shard=mode), cache=rc)
    port = {"banded": Session(ExecutorSpec(device="cpu"), cache=pc)}
    for mode in SHARD_MODES:
        port[mode] = Session(ExecutorSpec(device="cpu", shard=mode), cache=pc)
    return {"ref": ref, "port": port,
            "ref_graphs": {"acm_small": acm_small, "imdb_small": imdb_small},
            "port_graphs": {k: make_dataset(ds, scale=sc)
                            for k, (ds, sc, _, _) in WORKLOADS.items()}}


@pytest.fixture
def four_ranks(monkeypatch):
    """A pool of 4 CPU ranks."""
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "4")
    return device_pool("cpu")


def _graphs(env, ds):
    _, _, targets, tt = WORKLOADS[ds]
    ref = env["ref"]["banded"].compile(env["ref_graphs"][ds], targets,
                                       RefConfig(**_kw("rgcn", tt))).graphs
    port = env["port"]["banded"].compile(env["port_graphs"][ds], targets,
                                         HGNNConfig(**_kw("rgcn", tt))).graphs
    return ref, port


def _pair(env, ds, model):
    """(reference banded compile, its params, reference features, port
    params, port features, port single-device compile) for one case."""
    _, _, targets, tt = WORKLOADS[ds]
    c_ref = env["ref"]["banded"].compile(env["ref_graphs"][ds], targets,
                                         RefConfig(**_kw(model, tt)))
    p_ref = c_ref.init(0)
    params = params_from_numpy(jax.tree.map(np.asarray, p_ref), "cpu")
    c_port = env["port"]["banded"].compile(env["port_graphs"][ds], targets,
                                           HGNNConfig(**_kw(model, tt)))
    return (c_ref, p_ref, ref_api.device_features(env["ref_graphs"][ds]), params,
            device_features(env["port_graphs"][ds], "cpu"), c_port)


# ------------------------------------------------------------------ plans --
@pytest.mark.parametrize("dataset", sorted(WORKLOADS))
@pytest.mark.parametrize("mode", SHARD_MODES)
@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 7])
def test_plan_is_bitwise_the_reference(env, dataset, mode, ndev):
    """Every slice (metapath, rank, block ids with their dtype, edges) and
    the summary equal the reference's; the reference's invariants hold:
    every block assigned once, ascending per slice, a dst tile on one
    rank, relations whole in relation mode."""
    ref_graphs, graphs = _graphs(env, dataset)
    want = ref_build_plan(ref_graphs, ndev, mode, feature_dim=16)
    plan = build_shard_plan(graphs, ndev, mode, feature_dim=16)
    assert (plan.mode, plan.num_devices, plan.feature_dim) == (mode, ndev, 16)
    assert len(plan.slices) == len(want.slices)
    for a, b in zip(plan.slices, want.slices):
        assert (a.metapath, a.device, a.num_edges) == (b.metapath, b.device, b.num_edges)
        assert a.block_ids.dtype == b.block_ids.dtype
        np.testing.assert_array_equal(a.block_ids, b.block_ids)
    assert plan.summary() == want.summary()
    for g in graphs:
        ids = [s.block_ids for s in plan.slices if s.metapath == g.metapath]
        merged = np.concatenate(ids) if ids else np.zeros(0, np.int64)
        np.testing.assert_array_equal(np.sort(merged), np.arange(g.packed.num_blocks))
        assert all(a.size <= 1 or np.all(np.diff(a) > 0) for a in ids)
        owner = {}
        for s in plan.slices:
            if s.metapath == g.metapath:
                for t in np.unique(g.packed.dst_tile[s.block_ids]):
                    assert owner.setdefault(int(t), s.device) == s.device
    if mode == "relation":
        mps = [s.metapath for s in plan.slices]
        assert len(mps) == len(set(mps))
    total = sum(g.packed.num_edges for g in graphs)
    assert sum(plan.summary()["per_device_macs"]) == total * 16
    assert plan.load_balance() >= 1.0


def test_edge_block_mode_balances_at_least_as_well(env):
    _, graphs = _graphs(env, "acm_small")
    rel = build_shard_plan(graphs, 4, "relation")
    eb = build_shard_plan(graphs, 4, "edge_block")
    assert eb.load_balance() <= rel.load_balance() + 1e-9


def test_merged_stream_keeps_each_rows_edges_in_order(env):
    """Each rank's merged stream holds, for every row it owns, the
    single-device packing's edges of that row in the same order (sources
    offset into the shared band space): why the sharded forward is bitwise
    the single-device one.  A rank the plan gives nothing has no stream."""
    _, graphs = _graphs(env, "acm_small")
    plan = build_shard_plan(graphs, 4, "relation")
    model = _pair(env, "acm_small", "rgcn")[5].model
    ex = ShardedHGNNExecutor(model, graphs, plan, devices=[torch.device("cpu")] * 4)
    geom = _build_geometry(graphs)
    streams = ex.streams()
    assert [st is None for st in streams] == [c == 0 for c in plan.device_block_counts()]
    assert ex.traces == 1 and ex.streams() is streams and ex.traces == 1
    sb, td = geom.src_band, geom.dst_tile_rows
    seen = 0
    for st in streams:
        if st is None:
            continue
        rows = st.packed.row_edges()
        deg = np.diff(rows.row_ptr)
        for r, g in enumerate(graphs):
            one = g.packed.row_edges()
            lo = geom.tile_offsets[r] * td
            for i in np.flatnonzero(deg[lo: lo + g.num_dst]):
                a, b = rows.row_ptr[lo + i], rows.row_ptr[lo + i + 1]
                c, d = one.row_ptr[i], one.row_ptr[i + 1]
                np.testing.assert_array_equal(rows.row_src[a:b] - geom.band_offsets[r] * sb,
                                              one.row_src[c:d])
                seen += int(b - a)
    assert seen == sum(g.packed.num_edges for g in graphs)


# ------------------------------------------------------------------- mesh --
def test_balanced_shape_and_mesh_for(four_ranks):
    for n in (1, 2, 6, 7, 12, 256, 512):
        for k in (1, 2, 3):
            assert _balanced_shape(n, k) == ref_balanced_shape(n, k)
    assert _balanced_shape(256, 2) == (16, 16)
    assert _balanced_shape(512, 3) == (8, 8, 8)
    mesh = make_mesh_for(four_ranks)
    assert mesh.devices.size == 4 and mesh.axis_names == ("dev",)
    sub = make_mesh_for(four_ranks[:1], ("dev",))
    assert sub.axis_names == ("dev",) and sub.devices.size == 1
    assert make_mesh_for(four_ranks, ("a", "b")).devices.shape == (2, 2)
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh_for(four_ranks, ("a", "b"), shape=(5, 1))
    with pytest.raises(ValueError, match="n >= 1"):
        _balanced_shape(0, 2)


def test_device_pool(monkeypatch):
    monkeypatch.delenv(VIRTUAL_DEVICES_ENV, raising=False)
    assert device_pool("cpu") == [torch.device("cpu")]
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "3")
    assert device_pool("cpu") == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device_pool("cuda")
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "0")
    with pytest.raises(ValueError, match="positive"):
        device_pool("cpu")


# ----------------------------------------------------------------- parity --
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("mode", SHARD_MODES)
def test_forward_parity_acm(env, four_ranks, model, mode):
    """Sharded logits on 2 and 4 CPU ranks within 1e-4 of the reference's
    banded forward, and bitwise the port's single-device forward (each
    row's edges keep their order in its rank's merged stream, and the
    other ranks add exact zeros)."""
    c_ref, p_ref, f_ref, params, feats, c_port = _pair(env, "acm_small", model)
    want = np.asarray(c_ref.forward(p_ref, f_ref))
    single = c_port.forward(params, feats)
    _, _, targets, tt = WORKLOADS["acm_small"]
    for n in (2, 4):
        c = env["port"][mode].compile(env["port_graphs"]["acm_small"], targets,
                                      HGNNConfig(**_kw(model, tt)), devices=list(range(n)))
        assert c.shard_plan.num_devices == n
        got = c.forward(params, feats)
        np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL)
        assert torch.equal(got, single)


@pytest.mark.parametrize("model", MODELS)
def test_forward_parity_against_the_reference_sharded_executor(env, four_ranks, model):
    """The reference's one-device ``ShardedHGNNExecutor`` (interpret mode)
    against the port's on 4 ranks, edge-block mode, within 1e-4."""
    _, _, targets, tt = WORKLOADS["acm_small"]
    c_ref = env["ref"]["edge_block"].compile(env["ref_graphs"]["acm_small"], targets,
                                             RefConfig(**_kw(model, tt)))
    p_ref = c_ref.init(0)
    want = np.asarray(c_ref.forward(p_ref, ref_api.device_features(
        env["ref_graphs"]["acm_small"])))
    c = env["port"]["edge_block"].compile(env["port_graphs"]["acm_small"], targets,
                                          HGNNConfig(**_kw(model, tt)))
    assert c.shard_plan.num_devices == 4
    got = c.forward(params_from_numpy(jax.tree.map(np.asarray, p_ref), "cpu"),
                    device_features(env["port_graphs"]["acm_small"], "cpu"))
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL)


def test_forward_parity_imdb_both_executors(env, four_ranks):
    """IMDB rgat: within 1e-4 of the reference's banded forward, 2e-3 of
    its segment-sum oracle, bitwise the port's single-device forward."""
    c_ref, p_ref, f_ref, params, feats, c_port = _pair(env, "imdb_small", "rgat")
    _, _, targets, tt = WORKLOADS["imdb_small"]
    oracle = env["ref"]["jnp"].compile(env["ref_graphs"]["imdb_small"], targets,
                                       RefConfig(**_kw("rgat", tt))).forward(p_ref, f_ref)
    c = env["port"]["edge_block"].compile(env["port_graphs"]["imdb_small"], targets,
                                          HGNNConfig(**_kw("rgat", tt)))
    got = c.forward(params, feats)
    np.testing.assert_allclose(got.numpy(), np.asarray(c_ref.forward(p_ref, f_ref)),
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=ORACLE_ATOL)
    assert torch.equal(got, c_port.forward(params, feats))


def test_direct_executor_multi_device_plan(env):
    """``ShardedHGNNExecutor`` over an explicit 2-rank plan and explicit
    ranks; a mesh of the wrong size is refused."""
    _, graphs = _graphs(env, "acm_small")
    _, _, _, params, feats, c_port = _pair(env, "acm_small", "rgcn")
    plan = build_shard_plan(graphs, 2, "edge_block")
    ex = ShardedHGNNExecutor(c_port.model, graphs, plan, devices=["cpu", "cpu", "cpu"])
    assert len(ex.ranks) == 2
    assert torch.equal(ex.forward(params, feats), c_port.forward(params, feats))
    with pytest.raises(ValueError, match="plan expects 2 devices"):
        ShardedHGNNExecutor(c_port.model, graphs, plan, devices=["cpu"])


# ---------------------------------------------------- compile and traces --
def test_no_retrace_and_compile_cache(env, four_ranks):
    """``shard_traces`` is 1 after any number of forwards; an identical
    compile returns the same object; ``stats()["shard"]`` reports the
    plans; subset forwards on a sharded compile give the forward's rows."""
    _, _, targets, tt = WORKLOADS["acm_small"]
    graph = env["port_graphs"]["acm_small"]
    sess = Session(ExecutorSpec(device="cpu", shard="relation"), cache=SemanticGraphCache())
    assert sess.stats()["shard"]["plans"] == 0
    c = sess.compile(graph, targets, HGNNConfig(**_kw("rgcn", tt)))
    params, feats = c.init(0), device_features(graph, "cpu")
    assert c.shard_traces == 0
    full = c.forward(params, feats)
    assert c.shard_traces == 1
    c.forward(params, feats)
    c.forward(params, feats)
    assert c.shard_traces == 1
    cached = sess.stats().compiles_cached
    assert sess.compile(graph, targets, HGNNConfig(**_kw("rgcn", tt))) is c
    assert sess.stats().compiles_cached == cached + 1
    shard = sess.stats()["shard"]
    assert shard["mode"] == "relation" and shard["plans"] == 1
    assert len(shard["per_device_edges"]) == 4
    assert shard["load_balance"] >= 1.0 and sum(shard["per_device_macs"]) > 0
    # another model over the same products shares the plan
    c2 = sess.compile(graph, targets, HGNNConfig(**_kw("rgat", tt)))
    assert c2.shard_plan is c.shard_plan and sess.stats()["shard"]["plans"] == 1
    ids = np.array([7, 3, 11])
    assert torch.equal(c.forward_subset(params, feats, ids), full[ids])
    dep = c.forward_subset(params, feats, ids, mode="dependency")
    np.testing.assert_allclose(dep.numpy(), full[ids].numpy(), atol=LOGIT_ATOL)
    assert Session(ExecutorSpec(device="cpu")).stats()["shard"] is None


def test_spec_validation():
    with pytest.raises(ValueError, match="requires na_executor='banded'"):
        ExecutorSpec(shard="relation", na_executor="jnp", device="cpu")
    with pytest.raises(ValueError, match="mesh_shape without sharding"):
        ExecutorSpec(mesh_shape=(2,), device="cpu")
    with pytest.raises(ValueError, match="not in"):
        ExecutorSpec(shard="rows", device="cpu")
    with pytest.raises(ValueError, match="positive ints"):
        ExecutorSpec(shard="relation", mesh_shape=(), device="cpu")
    spec = ExecutorSpec(shard="edge_block", mesh_shape=[2, 1], device="cpu")
    assert spec.mesh_shape == (2, 1)


def test_mesh_shape_picks_the_rank_count(env, four_ranks):
    _, _, targets, tt = WORKLOADS["acm_small"]
    graph = env["port_graphs"]["acm_small"]
    cfg = HGNNConfig(**_kw("rgcn", tt))
    sess = Session(ExecutorSpec(device="cpu", shard="edge_block", mesh_shape=(3,)))
    assert sess.compile(graph, targets, cfg).shard_plan.num_devices == 3
    big = Session(ExecutorSpec(device="cpu", shard="edge_block", mesh_shape=(8,)))
    with pytest.raises(ValueError, match="needs 8 devices"):
        big.compile(graph, targets, cfg)


def test_unsharded_compile_rejects_devices(env):
    _, _, targets, tt = WORKLOADS["acm_small"]
    with pytest.raises(ValueError, match="requires a sharded spec"):
        env["port"]["banded"].compile(env["port_graphs"]["acm_small"], targets,
                                      HGNNConfig(**_kw("rgcn", tt)), devices=[0])


# ------------------------------------------------------ pinned serving --
def test_serve_pinned_disjoint_device_groups(env, four_ranks):
    """Two tenants pinned to disjoint halves of 4 ranks serve responses
    within 1e-4 of the reference's banded forwards and bitwise the port's
    unsharded ones (the case the reference skips on one device)."""
    _, _, targets, tt = WORKLOADS["acm_small"]
    graph = env["port_graphs"]["acm_small"]
    eng = HGNNServeEngine(session=env["port"]["edge_block"])
    params = {}
    for name, model, group in (("lo", "rgcn", [0, 1]), ("hi", "rgat", [2, 3])):
        c_ref, p_ref, f_ref, params[name], _, _ = _pair(env, "acm_small", model)
        eng.register(name, graph, targets, HGNNConfig(**_kw(model, tt)),
                     params=params[name], device_group=group)
    eng.submit([HGNNRequest(0, "lo"), HGNNRequest(1, "hi"),
                HGNNRequest(2, "lo", nodes=np.arange(5))])
    by_rid = {r.rid: r for r in eng.step()}
    assert set(by_rid) == {0, 1, 2}
    assert eng._registered["lo"].compiled is not eng._registered["hi"].compiled
    for name, rid, model in (("lo", 0, "rgcn"), ("hi", 1, "rgat")):
        reg = eng._registered[name]
        assert reg.compiled.shard_plan.num_devices == 2
        c_ref, p_ref, f_ref, _, feats, c_port = _pair(env, "acm_small", model)
        np.testing.assert_allclose(by_rid[rid].logits,
                                   np.asarray(c_ref.forward(p_ref, f_ref)), atol=LOGIT_ATOL)
        np.testing.assert_array_equal(by_rid[rid].logits,
                                      c_port.forward(params[name], feats).numpy())
    np.testing.assert_array_equal(by_rid[2].logits, by_rid[0].logits[:5])


# ----------------------------------------------------------- graph deltas --
def test_compile_delta_on_a_sharded_compile(four_ranks):
    """The successor replans over the predecessor's group: its plan equals
    a cold sharded compile's of the mutated graph, its logits are bitwise
    the cold compile's; ``swap_graph`` on a pinned tenant keeps the
    group."""
    graph = make_dataset("ACM", scale=0.15)
    targets = ["APA", "PAP", "PSP"]
    cfg = HGNNConfig(**_kw("rgat", "P"))
    spec = ExecutorSpec(device="cpu", shard="edge_block")
    sess = Session(spec)
    pred = sess.compile(graph, targets, cfg, devices=[1, 3])
    params, feats = pred.init(0), device_features(graph, "cpu")
    pred.forward(params, feats)
    rng = np.random.default_rng(0)
    delta = GraphDelta.insert("PS", rng.integers(0, graph.num_vertices["P"], 24),
                              rng.integers(0, graph.num_vertices["S"], 24))
    succ, g2, _ = sess.compile_delta(pred, graph, delta)
    assert succ._devices == pred._devices and succ.shard_plan.num_devices == 2
    assert succ.shard_plan is not pred.shard_plan
    cold = Session(spec).compile(g2, targets, cfg, devices=[1, 3])
    assert succ.shard_plan.summary() == cold.shard_plan.summary()
    assert torch.equal(succ.forward(params, feats), cold.forward(params, feats))
    assert sess.compile(g2, targets, cfg, devices=[1, 3]) is succ

    eng = HGNNServeEngine(session=Session(spec))
    handle = eng.register("acm", graph, targets, cfg, params=params, device_group=[2, 3])
    handle.swap_graph(delta)
    reg = eng._registered["acm"]
    assert [str(d) for d in reg.compiled._devices] == ["cpu", "cpu"]
    assert reg.compiled._devkey == (2, 3)
    eng.submit([HGNNRequest(0, "acm")])
    (resp,) = eng.step()
    np.testing.assert_array_equal(resp.logits, cold.forward(params, feats).numpy())
