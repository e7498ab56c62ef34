"""Port parity for the subset forwards: the k-hop ``DependencyExtractor``
(``repro_torch.core.subgraph``) against the reference's, products bitwise;
``forward_subset`` in modes ``"head"`` and ``"dependency"`` and
``fusion_betas`` against the reference (interpret mode on the banded
executor) with the reference's parameters carried across by
``params_from_numpy``; the sliced packing's row view, which K1 reads;
``canonical_node_ids``; and the bucket counters."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

# PyTorch's CPU build can return a wrong result for the first vectorized
# float op of a fresh process (ROADMAP, queue 3); a throwaway call first.
torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))

import jax  # noqa: E402

import repro.api as ref_api  # noqa: E402
from repro.api.session import canonical_node_ids as ref_canonical  # noqa: E402
from repro.core.hgnn import HGNNConfig as RefConfig  # noqa: E402
from repro.pipeline import SemanticGraphCache as RefCache  # noqa: E402
from repro_torch.api import (ExecutorSpec, Session, canonical_node_ids,  # noqa: E402
                             device_features)
from repro_torch.core.hgnn import HGNNConfig, params_from_numpy  # noqa: E402
from repro_torch.hetero import make_dataset  # noqa: E402
from repro_torch.kernels.seg_sum import seg_sum_plain  # noqa: E402
from repro_torch.pipeline import SemanticGraphCache  # noqa: E402

WORKLOADS = {
    "acm_small": ("ACM", 0.15, ["APA", "PAP", "PSP"], "P"),
    "imdb_small": ("IMDB", 0.2, ["AMA", "MAM", "MDM"], "M"),
}
MODELS = ["rgcn", "rgat", "shgn"]
EXECUTORS = ["jnp", "banded"]
LOGIT_ATOL = 1e-4  # tests/test_subgraph.py:106
BETA_ATOL = 1e-5
K1_TOL = 1e-4  # seg_sum in float32, tests/test_kernels.py


def _kw(model, target_type, **kw):
    kw.setdefault("hidden", 16)
    kw.setdefault("num_layers", 2)
    return dict(model=model, num_classes=3, target_type=target_type, **kw)


@pytest.fixture(scope="module")
def env(acm_small, imdb_small):
    """Reference and port sessions per executor (each side over one shared
    cache) and both sides' graphs (the port builds its own from the seed)."""
    rc, pc = RefCache(), SemanticGraphCache()
    return {
        "ref": {ex: ref_api.Session(ref_api.ExecutorSpec(na_executor=ex), cache=rc)
                for ex in EXECUTORS},
        "port": {ex: Session(ExecutorSpec(na_executor=ex, device="cpu"), cache=pc)
                 for ex in EXECUTORS},
        "ref_graphs": {"acm_small": acm_small, "imdb_small": imdb_small},
        "port_graphs": {k: make_dataset(ds, scale=sc)
                        for k, (ds, sc, _, _) in WORKLOADS.items()},
    }


def _pair(env, ds, executor, model, **kw):
    """(reference compiled, port compiled, reference params, port params,
    reference features, port features) for one case."""
    _, _, targets, tt = WORKLOADS[ds]
    g_ref, g_port = env["ref_graphs"][ds], env["port_graphs"][ds]
    c_ref = env["ref"][executor].compile(g_ref, targets, RefConfig(**_kw(model, tt, **kw)))
    c_port = env["port"][executor].compile(g_port, targets, HGNNConfig(**_kw(model, tt, **kw)))
    p_ref = c_ref.init(0)
    params = params_from_numpy(jax.tree.map(np.asarray, p_ref), "cpu")
    return (c_ref, c_port, p_ref, params, ref_api.device_features(g_ref),
            device_features(g_port, "cpu"))


def _id_sets(num_target, seed=7):
    rng = np.random.default_rng(seed)
    return [np.unique(rng.integers(0, num_target, size=n)) for n in (1, 5, 13)]


# ---------------------------------------------------- extraction products --
@pytest.mark.parametrize("ds", sorted(WORKLOADS))
@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("layers", [2, 3])
def test_extraction_products_bitwise(env, ds, executor, layers):
    """hops, closure, buckets, signature and every array of the flavor are
    bitwise equal to the reference's (dtypes included); the port's banded
    arrays add only the sliced ``PackedEdges``, built from the same
    blocked arrays."""
    c_ref, c_port, *_ = _pair(env, ds, executor, "rgcn", num_layers=layers)
    for ids in _id_sets(c_port.num_target):
        want, got = c_ref.dependency_subset(ids), c_port.dependency_subset(ids)
        assert np.array_equal(want.node_ids, got.node_ids)
        assert len(want.hops) == len(got.hops) == layers + 1
        for hw, hg in zip(want.hops, got.hops):
            assert sorted(hw) == sorted(hg)
            for t in hw:
                assert hw[t].dtype == hg[t].dtype and np.array_equal(hw[t], hg[t])
        for t in want.closure:
            assert np.array_equal(want.closure[t], got.closure[t])
        assert want.buckets == got.buckets
        assert want.signature == got.signature
        assert (want.closure_size, want.total_size) == (got.closure_size, got.total_size)
        ra = jax.tree.map(np.asarray, want.arrays)
        assert np.array_equal(ra["node_rows"], got.arrays["node_rows"].numpy())
        for t in ra["gather"]:
            assert np.array_equal(ra["gather"][t], got.arrays["gather"][t].numpy())
        for a, b in zip(ra["graphs"], got.arrays["graphs"]):
            extra = {"packed"} if executor == "banded" else set()
            assert set(b) == set(a) | extra
            for k, x in a.items():
                y = b[k].numpy()
                assert x.dtype == y.dtype and x.shape == y.shape, k
                assert np.array_equal(x, y), k
            if executor == "banded":
                pk = b["packed"]
                for name, field in (("srcl", pk.src_local), ("dstl", pk.dst_local),
                                    ("weight", pk.weight), ("band", pk.band),
                                    ("dtile", pk.dst_tile), ("first", pk.first_in_tile)):
                    assert np.array_equal(a[name], field), name
                assert int(pk.count.sum()) == int(a["e_valid"].sum())


@pytest.mark.parametrize("ds", sorted(WORKLOADS))
def test_sliced_packing_row_view_covers_valid_slots(env, ds):
    """The slice's ``row_edges()`` — what K1 reads — holds exactly the
    slice's valid slots, each on its destination row with its source, and
    the plain K1 over it equals a one-hot sum over the flat edge map."""
    _, c_port, *_ = _pair(env, ds, "banded", "rgcn")
    rng = np.random.default_rng(3)
    for ids in _id_sets(c_port.num_target, seed=11):
        sub = c_port.dependency_subset(ids)
        for dg in sub.arrays["graphs"]:
            pk = dg["packed"]
            rows = pk.row_edges()
            valid = dg["e_valid"].numpy() > 0
            e_blk, e_slot = dg["e_blk"].numpy()[valid], dg["e_slot"].numpy()[valid]
            e_src, e_dst = dg["e_src"].numpy()[valid], dg["e_dst"].numpy()[valid]
            want = sorted(zip(e_dst.tolist(), (e_blk * pk.edge_block + e_slot).tolist(),
                              e_src.tolist()))
            row_of = np.repeat(np.arange(pk.num_dst), np.diff(rows.row_ptr))
            got = sorted(zip(row_of.tolist(), rows.row_slot.tolist(), rows.row_src.tolist()))
            assert got == want
            # every row is written: the light items' row runs tile 0..num_dst
            light = rows.items[rows.items[:, 1] > 0]
            heavy_rows = set(rows.items[rows.items[:, 1] < 0, 0].tolist())
            covered = set(heavy_rows)
            for r, k, _, _ in light:
                covered.update(range(int(r), int(r) + int(k)))
            assert covered == set(range(pk.num_dst))
            h = torch.from_numpy(rng.standard_normal((pk.num_src, 4)).astype(np.float32))
            onehot = np.zeros((pk.num_dst, e_src.size), np.float32)
            onehot[e_dst, np.arange(e_src.size)] = 1.0
            np.testing.assert_allclose(seg_sum_plain(pk, h).numpy(),
                                       onehot @ h.numpy()[e_src], atol=K1_TOL, rtol=K1_TOL)


# ------------------------------------------------------------- the betas --
@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("model", MODELS)
def test_fusion_betas_match_reference(env, executor, model):
    c_ref, c_port, p_ref, params, f_ref, f_port = _pair(env, "acm_small", executor, model)
    want = c_ref.model.fusion_betas(p_ref, f_ref, c_ref.graphs, na_executor=executor)
    got = c_port.model.fusion_betas(params, f_port, c_port.graphs, na_executor=executor)
    assert len(got) == len(want) == c_port.cfg.num_layers
    for bw, bg in zip(want, got):
        assert sorted(bw) == sorted(bg)
        for t in bw:
            np.testing.assert_allclose(bg[t].numpy(), np.asarray(bw[t]), atol=BETA_ATOL)
    # the compiled memo returns one object per (params, features) pair
    assert c_port._fusion_betas(params, f_port) is c_port._fusion_betas(params, f_port)


# --------------------------------------------------------------- forwards --
@pytest.mark.parametrize("ds", sorted(WORKLOADS))
@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("model", MODELS)
def test_dependency_forward_matches_reference(env, ds, executor, model):
    """Dependency-mode rows within 1e-4 of the reference's dependency rows
    and of the port's own full forward; head-mode rows bitwise equal to
    the port's full forward."""
    c_ref, c_port, p_ref, params, f_ref, f_port = _pair(env, ds, executor, model)
    full = c_port.forward(params, f_port).numpy()
    for ids in _id_sets(c_port.num_target)[1:]:
        want = np.asarray(c_ref.forward_subset(p_ref, f_ref, ids, mode="dependency"))
        got = c_port.forward_subset(params, f_port, ids, mode="dependency")
        assert got.shape == (ids.size, 3) and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL)
        np.testing.assert_allclose(got.numpy(), full[ids], atol=LOGIT_ATOL)
        head = c_port.forward_subset(params, f_port, ids)
        np.testing.assert_array_equal(head.numpy(), full[ids])


@pytest.mark.parametrize("model", ["rgat", "shgn"])
def test_dependency_attention_takes_k2(env, model, monkeypatch):
    """The banded attention subset takes its softmax statistics from K2's
    route (``edge_softmax_stats``, the plain version on the CPU) over each
    slice's own ``PackedEdges``, once per layer and semantic graph, and its
    IMDB rows stay within 1e-4 of the reference's."""
    import repro_torch.core.subgraph as subgraph

    real, calls = subgraph.edge_softmax_stats, []

    def spy(pk, logits):
        calls.append(pk)
        return real(pk, logits)

    monkeypatch.setattr(subgraph, "edge_softmax_stats", spy)
    c_ref, c_port, p_ref, params, f_ref, f_port = _pair(env, "imdb_small", "banded", model)
    ids = _id_sets(c_port.num_target)[2]
    sub = c_port.dependency_subset(ids)
    got = c_port.forward_subset(params, f_port, ids, mode="dependency")
    slices = [dg["packed"] for dg in sub.arrays["graphs"]]
    assert calls == slices * c_port.cfg.num_layers
    want = np.asarray(c_ref.forward_subset(p_ref, f_ref, ids, mode="dependency"))
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL)


def test_subset_forwards_keep_caller_order(env):
    """Unsorted and duplicated ids come back per position, in both modes."""
    _, c, _, params, _, feats = _pair(env, "acm_small", "banded", "rgat")
    full = c.forward(params, feats).numpy()
    ids = np.array([11, 2, 11, 5, c.num_target - 1])
    np.testing.assert_array_equal(c.forward_subset(params, feats, ids).numpy(), full[ids])
    dep = c.forward_subset(params, feats, ids, mode="dependency").numpy()
    np.testing.assert_allclose(dep, full[ids], atol=LOGIT_ATOL)
    with pytest.raises(ValueError, match="unknown forward_subset mode"):
        c.forward_subset(params, feats, ids, mode="tail")


# --------------------------------------------------------------- validator --
@pytest.mark.parametrize("ids", [
    np.array([0.5, 1.0]), np.array([], np.int32), np.array([[1, 2]]),
    np.array([0, 50]), np.array([-1, 3]), [3, 4], np.array([7], np.uint8),
])
def test_canonical_node_ids_matches_reference(ids):
    def outcome(fn):
        try:
            out = fn(ids, 50, ctx="request 3: nodes")
        except (TypeError, ValueError) as err:
            return type(err), str(err)
        return out.dtype, out.tolist()

    assert outcome(canonical_node_ids) == outcome(ref_canonical)


def test_forward_subset_validates_ids(env):
    _, c, _, params, _, feats = _pair(env, "acm_small", "jnp", "rgcn")
    with pytest.raises(TypeError, match="integer"):
        c.forward_subset(params, feats, np.array([0.5, 1.0]))
    with pytest.raises(ValueError, match="bounds"):
        c.forward_subset(params, feats, np.array([c.num_target]), mode="dependency")
    with pytest.raises(ValueError, match="1-D"):
        c.forward_subset(params, feats, np.array([], np.int32))
    with pytest.raises(ValueError, match="out of bounds"):
        c.dependency_subset(np.array([0, c.num_target]), validate=False)


# ---------------------------------------------------- memo and counters --
def test_extract_memoized_and_order_insensitive(env):
    _, c, *_ = _pair(env, "acm_small", "banded", "rgcn")
    a = c.dependency_subset(np.array([9, 3, 7]))
    b = c.dependency_subset(np.array([3, 7, 9, 9, 3]))
    assert a is b and np.array_equal(a.node_ids, [3, 7, 9])
    assert a.arrays["graphs"][0]["packed"] is b.arrays["graphs"][0]["packed"]
    for prev, nxt in zip(a.hops[:-1], a.hops[1:]):  # frontiers are monotone
        for t in prev:
            assert np.isin(prev[t], nxt[t]).all(), t
    assert 0.0 <= a.coverage <= 1.0


def test_subset_traces_flat_within_bucket(env):
    _, c, _, params, _, feats = _pair(env, "acm_small", "jnp", "rgcn", hidden=8)
    c.forward_subset(params, feats, np.arange(3))  # bucket 8
    t0 = c.subset_traces
    for ids in (np.array([1, 4]), np.arange(8), np.array([9, 3, 5])):
        c.forward_subset(params, feats, ids)
    assert c.subset_traces == t0
    c.forward_subset(params, feats, np.arange(9))  # bucket 16
    assert c.subset_traces == t0 + 1
    c.forward_subset(params, feats, np.arange(12, 28))
    assert c.subset_traces == t0 + 1


@pytest.mark.parametrize("executor", EXECUTORS)
def test_dependency_traces_flat_within_signature(env, executor):
    """Two id sets with one bucket signature count once."""
    _, c, _, params, _, feats = _pair(env, "acm_small", executor, "rgat", hidden=8)
    rng = np.random.default_rng(0)
    seen, pair = {}, None
    for _ in range(64):
        sub = c.dependency_subset(np.unique(rng.integers(0, c.num_target, size=9)))
        prev = seen.get(sub.signature)
        if prev is not None and not np.array_equal(prev, sub.node_ids):
            pair = (prev, sub.node_ids)
            break
        seen[sub.signature] = sub.node_ids
    assert pair is not None, "no signature collision in 64 probes"
    c.forward_subset(params, feats, pair[0], mode="dependency")
    traces = c.dependency_traces
    assert traces >= 1
    c.forward_subset(params, feats, pair[1], mode="dependency")
    assert c.dependency_traces == traces


def test_concurrent_subset_forwards_build_once(env):
    """Threads racing the lazy builds (extractor, extraction memo, betas
    memo, counters) under a short switch interval: one extractor, one
    ``DependencySubset`` per id set, one betas entry, and every result
    right."""
    import sys
    import threading

    _, c, _, params, _, feats = _pair(env, "acm_small", "jnp", "rgcn", hidden=4)
    full = c.forward(params, feats).numpy()
    id_sets = [np.array([3, 9]), np.array([9, 3, 3]), np.array([1, 2, 5])]
    results, errors = [], []

    def work(k):
        try:
            ids = id_sets[k % len(id_sets)]
            sub = c.dependency_subset(ids)
            out = c.forward_subset(params, feats, ids, mode="dependency").numpy()
            results.append((k, sub, out))
        except Exception as err:  # noqa: BLE001 — re-raised below in the test thread
            errors.append(err)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(results) == 12
    subs = {}
    for k, sub, out in results:
        ids = id_sets[k % len(id_sets)]
        np.testing.assert_allclose(out, full[ids], atol=LOGIT_ATOL)
        subs.setdefault(tuple(np.unique(ids)), set()).add(id(sub))
    assert all(len(v) == 1 for v in subs.values())  # one build per id set
    assert len(c._beta_memo) == 1
    assert c.dependency_traces == len({s.signature for _, s, _ in results})
