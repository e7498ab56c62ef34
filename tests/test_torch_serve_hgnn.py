"""The port's multi-tenant HGNN serving engine (``repro_torch.serve``) on the
CPU: the analogues of the reference's serving cases in ``test_api.py``,
``test_serve_async.py``, ``test_serve_faults.py`` and
``test_serve_window.py`` — admission, backpressure, the loop, quotas,
deadlines, the breaker, retries, degradation, ``swap_params`` versions,
``swap_graph`` (rows bitwise a cold compile of the mutated graph),
window results bitwise equal to per-request serving, and the chaos
invariant (every admitted future resolves exactly once).

Every blocking wait carries its own timeout and every engine that runs a
loop is stopped in a ``finally``, so a hang fails a test instead of
stalling the suite."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from proptest import seeded_property  # noqa: E402
from repro_torch.api import ExecutorSpec, ServePolicy, Session, device_features  # noqa: E402
from repro_torch.core.hgnn import HGNNConfig  # noqa: E402
from repro_torch.hetero import GraphDelta, make_dataset  # noqa: E402
from repro_torch.pipeline import SemanticGraphCache  # noqa: E402
from repro_torch.serve import (AdmissionError, CircuitOpen,  # noqa: E402
                               DeadlineExceeded, FaultInjector, HGNNRequest,
                               HGNNResponse, HGNNServeEngine, PermanentFault,
                               QuotaExceeded, TenantHandle, TransientFault,
                               is_transient)

TARGETS = ["APA", "PAP", "PSP"]
IMDB_TARGETS = ["AMA", "MAM", "MDM"]
WAIT = 30  # seconds any single future or join may take before the test fails


def _cfg(model="rgcn", target_type="P", **kw):
    kw.setdefault("hidden", 16)
    kw.setdefault("num_layers", 2)
    return HGNNConfig(model=model, num_classes=3, target_type=target_type, **kw)


@pytest.fixture(scope="module")
def served():
    """One segment-sum session on the CPU with a warm compiled model and
    pinned features and params, shared by every engine in this module
    (engines differ only in policy and faults)."""
    graph = make_dataset("ACM", scale=0.15)
    sess = Session(ExecutorSpec(na_executor="jnp", device="cpu"))
    compiled = sess.compile(graph, TARGETS, _cfg())
    params = compiled.init(0)
    feats = device_features(graph, "cpu")
    compiled.forward(params, feats)
    return {"graph": graph, "session": sess, "compiled": compiled,
            "feats": feats, "params": params}


def _engine(served, policy=None, faults=None, names=("acm",)):
    eng = HGNNServeEngine(session=served["session"], policy=policy, faults=faults)
    for name in names:
        eng.register(name, served["graph"], TARGETS, _cfg(),
                     params=served["params"], warm=False)
    return eng


def _req(rid, nodes=(1, 2), name="acm", deadline_ms=None):
    return HGNNRequest(rid, name, nodes=np.asarray(nodes), deadline_ms=deadline_ms)


def _full(served):
    return served["compiled"].forward(served["params"], served["feats"]).numpy()


# ------------------------------------------------------------ registration --
def test_serve_batches_by_fingerprint_across_tenants(served):
    """Two tenants on two graphs in one engine: one forward per
    registration, responses equal the compiled forward row for row."""
    eng = HGNNServeEngine(session=served["session"])
    eng.register("acm", served["graph"], TARGETS, _cfg(), seed=3)
    eng.register("imdb", make_dataset("IMDB", scale=0.2), IMDB_TARGETS,
                 _cfg("rgat", "M"), seed=4)
    rng = np.random.default_rng(0)
    futs = eng.submit([HGNNRequest(0, "acm", nodes=rng.integers(0, 50, size=6)),
                       HGNNRequest(1, "imdb"),
                       HGNNRequest(2, "acm"),
                       HGNNRequest(3, "imdb", nodes=np.array([0, 1])),
                       HGNNRequest(4, "acm", nodes=np.array([7]))])
    responses = eng.step()
    assert [r.rid for r in responses] in ([0, 2, 4, 1, 3], [1, 3, 0, 2, 4])
    by_rid = {r.rid: r for r in responses}
    assert by_rid[0].batched_with == 3 and by_rid[1].batched_with == 2
    direct = {}
    for name in ("acm", "imdb"):
        reg = eng._registered[name]
        direct[name] = reg.compiled.forward(reg.params, reg.features).numpy()
    np.testing.assert_array_equal(by_rid[2].logits, direct["acm"])
    np.testing.assert_array_equal(by_rid[4].logits, direct["acm"][[7]])
    np.testing.assert_array_equal(by_rid[4].predictions, direct["acm"][[7]].argmax(-1))
    np.testing.assert_array_equal(by_rid[1].logits, direct["imdb"])
    np.testing.assert_array_equal(by_rid[3].logits, direct["imdb"][[0, 1]])
    assert all(f.result(timeout=WAIT).latency_us > 0 for f in futs)
    assert eng.step() == []
    st = eng.stats()
    assert st["requests_served"] == 5 and st["forwards"] == 2
    assert st["batching_factor"] == 2.5 and st["latency_us_p50"] > 0
    assert st["session"].hit_rate >= 0.0


def test_register_rejects_duplicates_and_unknown_graphs(served):
    eng = _engine(served)
    with pytest.raises(KeyError, match="not registered"):
        eng.submit(HGNNRequest(9, "dblp"))
    with pytest.raises(ValueError, match="already registered"):
        eng.register("acm", served["graph"], TARGETS, _cfg())
    with pytest.raises(ValueError, match="not both"):
        HGNNServeEngine(session=served["session"], spec=ExecutorSpec(device="cpu"))


def test_register_shares_the_session_frontend(served):
    sess = served["session"]
    before = sess.stats()
    eng = HGNNServeEngine(session=sess)
    eng.register("acm2", served["graph"], TARGETS, _cfg("shgn"), warm=False)
    after = sess.stats()
    assert after.frontend_runs == before.frontend_runs
    assert after.cache_misses == before.cache_misses


def test_unported_graph_deltas_and_device_groups_raise(served):
    """device_group needs a sharded session (the reference's
    ``ValueError``); swap_graph on an unknown registration raises
    ``KeyError``, through the handle and through the deprecated shim,
    which still warns."""
    eng = _engine(served)
    with pytest.raises(ValueError, match="requires a sharded spec"):
        eng.register("pinned", served["graph"], TARGETS, _cfg(), device_group=[0])
    assert eng.registered == ["acm"]
    with pytest.raises(KeyError, match="not registered"):
        TenantHandle(eng, "nope").swap_graph(_tp_delta(served["graph"]))
    with pytest.warns(DeprecationWarning, match="TenantHandle"):
        with pytest.raises(KeyError, match="not registered"):
            eng.swap_graph("nope", _tp_delta(served["graph"]))
    assert TenantHandle(eng, "acm").version == 1


# ----------------------------------------------------- engine: subset path --
def test_engine_subset_and_full_parity_on_one_queue(served):
    eng = HGNNServeEngine(session=served["session"], policy=ServePolicy(subset_threshold=0.5))
    for name in ("sub", "full"):
        eng.register(name, served["graph"], TARGETS, _cfg(), params=served["params"])
    ids = np.array([11, 3, 3, 40], np.int64)
    eng.submit([HGNNRequest(0, "sub", nodes=ids),
                HGNNRequest(1, "sub", nodes=np.array([5, 11])),
                HGNNRequest(2, "full", nodes=ids),
                HGNNRequest(3, "full")])
    by_rid = {r.rid: r for r in eng.step()}
    assert by_rid[0].mode == by_rid[1].mode == "subset"
    assert by_rid[2].mode == by_rid[3].mode == "full"
    np.testing.assert_array_equal(by_rid[0].logits, by_rid[2].logits)
    np.testing.assert_array_equal(by_rid[0].logits, by_rid[3].logits[ids])
    np.testing.assert_array_equal(by_rid[0].predictions, by_rid[2].predictions)
    st = eng.stats()
    assert st["forwards_subset"] == 1 and st["forwards_full"] == 1
    assert st["queue_us_p50"] is not None and st["compute_us_p50"] > 0
    for r in by_rid.values():
        assert r.latency_us == pytest.approx(r.queue_us + r.compute_us, rel=1e-6)


def test_engine_subset_threshold_forces_full(served):
    eng = _engine(served, ServePolicy(subset_threshold=0.0))
    eng.submit(_req(0))
    (resp,) = eng.step()
    assert resp.mode == "full" and eng.stats()["forwards_subset"] == 0


def test_engine_duplicate_ids_in_one_request(served):
    eng = _engine(served)
    ids = np.array([9, 9, 1, 9], np.int64)
    fut = eng.submit(HGNNRequest(0, "acm", nodes=ids))
    (resp,) = eng.step()
    assert resp.mode == "subset"
    np.testing.assert_array_equal(resp.logits, _full(served)[ids])
    assert fut.result(timeout=WAIT) is resp


@pytest.mark.parametrize("executor", ["jnp", "banded"])
def test_serve_dependency_mode_and_fallback(served, executor):
    """Dependency mode serves by the k-hop executor within 1e-4 of the full
    forward; a closure over ``dependency_threshold`` falls back to full."""
    sess = served["session"] if executor == "jnp" else Session(
        ExecutorSpec(device="cpu"), cache=served["session"].cache)
    eng = HGNNServeEngine(session=sess, policy=ServePolicy(
        subset_threshold=0.5, subset_mode="dependency", dependency_threshold=1.0))
    eng.register("acm", served["graph"], TARGETS, _cfg(), seed=3)
    eng.submit([_req(0, [4, 7]), _req(1, [7, 19])])
    responses = {r.rid: r for r in eng.step()}
    assert all(r.mode == "dependency" for r in responses.values())
    reg = eng._registered["acm"]
    direct = reg.compiled.forward(reg.params, reg.features).numpy()
    np.testing.assert_allclose(responses[0].logits, direct[[4, 7]], atol=1e-4)
    np.testing.assert_allclose(responses[1].logits, direct[[7, 19]], atol=1e-4)
    st = eng.stats()
    assert st["forwards_dependency"] == 1 and st["forwards_full"] == 0
    fb = HGNNServeEngine(session=sess, policy=ServePolicy(
        subset_threshold=1.0, subset_mode="dependency", dependency_threshold=0.0))
    fb.register("acm", served["graph"], TARGETS, _cfg(), seed=3, warm=False)
    fb.submit(_req(0, [4, 7]))
    (resp,) = fb.step()
    assert resp.mode == "full" and fb.stats()["forwards_dependency"] == 0
    np.testing.assert_array_equal(resp.logits, direct[[4, 7]])


def test_per_tenant_subset_mode_overrides_the_policy(served):
    """One engine serves a head-mode tenant beside a dependency-mode one;
    pressure degrades only the dependency tenant's group (to head)."""
    inj = FaultInjector()
    eng = HGNNServeEngine(session=served["session"], faults=inj,
                          policy=ServePolicy(max_queue=4, degrade_pressure=1.0))
    for name, mode in (("head", None), ("dep", "dependency")):
        eng.register(name, served["graph"], TARGETS, _cfg(), params=served["params"],
                     warm=False, subset_mode=mode)
    with pytest.raises(ValueError, match="subset_mode"):
        eng.register("bad", served["graph"], TARGETS, _cfg(), subset_mode="tail")
    eng.submit([_req(0, [4, 7], name="head"), _req(1, [4, 7], name="dep")])
    by_rid = {r.rid: r for r in eng.step()}
    assert (by_rid[0].mode, by_rid[1].mode) == ("subset", "dependency")
    np.testing.assert_allclose(by_rid[1].logits, by_rid[0].logits, atol=1e-4)
    assert inj.counts["extract"] == 1 and eng.stats()["degraded_steps"] == 0
    futs = eng.submit([_req(i, [i], name=("head", "dep")[i % 2]) for i in range(4)])
    eng.step()
    assert [f.result(timeout=WAIT).mode for f in futs] == ["subset"] * 4
    assert inj.counts["extract"] == 1 and eng.stats()["degraded_steps"] == 1


def test_empty_submit_and_drained_step_are_noops(served):
    eng = HGNNServeEngine(session=served["session"])
    assert eng.submit([]) == [] and eng.step() == []
    st = eng.stats()
    assert st["requests_served"] == 0 and st["forwards"] == 0 and st["queued"] == 0


# ---------------------------------------------------------------- admission --
def test_submit_validates_nodes_at_admission(served):
    eng = _engine(served)
    n = served["compiled"].num_target
    with pytest.raises(ValueError, match="out of.*bounds"):
        eng.submit(HGNNRequest(0, "acm", nodes=np.array([0, n])))
    with pytest.raises(ValueError, match="out of.*bounds"):
        eng.submit(HGNNRequest(1, "acm", nodes=np.array([-1])))
    with pytest.raises(TypeError, match="integer"):
        eng.submit(HGNNRequest(2, "acm", nodes=np.array([0.25, 1.5])))
    with pytest.raises(ValueError, match="1-D"):
        eng.submit(HGNNRequest(3, "acm", nodes=np.array([[1, 2]])))
    with pytest.raises(ValueError):
        eng.submit([HGNNRequest(4, "acm", nodes=np.array([1])),
                    HGNNRequest(5, "acm", nodes=np.array([n + 3]))])
    assert eng.step() == []


def test_reject_backpressure_and_oversized_batch(served):
    eng = _engine(served, ServePolicy(max_queue=2, backpressure="reject"))
    eng.submit([HGNNRequest(0, "acm"), HGNNRequest(1, "acm")])
    with pytest.raises(AdmissionError, match="queue full"):
        eng.submit(HGNNRequest(2, "acm"))
    with pytest.raises(AdmissionError, match="never fit"):
        eng.submit([HGNNRequest(3, "acm") for _ in range(3)])
    assert eng.stats()["requests_rejected"] == 4
    assert len(eng.step()) == 2


def test_block_backpressure_unblocks_on_drain(served):
    eng = _engine(served, ServePolicy(max_queue=1, backpressure="block"))
    eng.submit(_req(0, [1]))
    t = threading.Thread(target=lambda: eng.submit(_req(1, [2])))
    t.start()
    try:
        time.sleep(0.05)
        assert t.is_alive()  # blocked on the full queue
        eng.step()  # drains -> unblocks the submitter
        t.join(timeout=WAIT)
        assert not t.is_alive()
        assert len(eng.step()) == 1
    finally:
        eng.stop()
        t.join(timeout=WAIT)


# --------------------------------------------------------------- async loop --
def test_async_loop_serves_futures_and_stops(served):
    eng = _engine(served)
    eng.run()
    try:
        with pytest.raises(RuntimeError, match="already running"):
            eng.run()
        futs = eng.submit([_req(i, [i, i + 1]) for i in range(6)])
        responses = [f.result(timeout=WAIT) for f in futs]
        assert all(isinstance(r, HGNNResponse) for r in responses)
        assert [r.rid for r in responses] == list(range(6))
    finally:
        eng.stop()
    assert not eng.running and eng.step() == []
    eng.stop()  # idempotent


def test_stop_drains_pending_queue(served):
    eng = _engine(served)
    futs = eng.submit([_req(i, [i]) for i in range(4)])
    eng.run()
    eng.stop()
    assert all(f.done() for f in futs)
    assert {f.result(timeout=WAIT).rid for f in futs} == {0, 1, 2, 3}


def test_stop_rejects_submitter_blocked_on_backpressure(served):
    eng = _engine(served, ServePolicy(max_queue=1, backpressure="block"))
    f0 = eng.submit(_req(0, [1]))
    outcome = []

    def _blocked():
        try:
            eng.submit(_req(1, [2]))
            outcome.append("enqueued")
        except AdmissionError:
            outcome.append("rejected")

    t = threading.Thread(target=_blocked)
    t.start()
    try:
        time.sleep(0.05)
        assert t.is_alive()
        eng.stop()
        t.join(timeout=WAIT)
        assert not t.is_alive() and outcome == ["rejected"]
        assert f0.result(timeout=WAIT).rid == 0
    finally:
        eng.stop()
        t.join(timeout=WAIT)


def test_group_failure_is_isolated(served):
    eng = HGNNServeEngine(session=served["session"])
    bad = eng.register("bad", served["graph"], TARGETS, _cfg(), params=served["params"])
    eng.register("good", served["graph"], TARGETS, _cfg(), params=served["params"])
    bad.swap_params({"not": "params"})
    f_bad = eng.submit(_req(0, [1], name="bad"))
    f_good = eng.submit(_req(1, [1], name="good"))
    with pytest.raises(KeyError):
        eng.step()
    assert isinstance(f_bad.exception(timeout=WAIT), KeyError)
    assert f_good.result(timeout=WAIT).rid == 1


def test_cancelled_future_does_not_break_the_batch(served):
    eng = _engine(served)
    f0 = eng.submit(_req(0, [1]))
    f1 = eng.submit(_req(1, [2]))
    assert f0.cancel()
    assert len(eng.step()) == 2
    assert f0.cancelled() and f1.result(timeout=WAIT).rid == 1


# --------------------------------------------------------------- param swap --
def test_swap_params_changes_logits_and_version(served):
    eng = _engine(served)
    eng.submit(_req(0, [3]))
    (before,) = eng.step()
    assert before.params_version == 1
    assert TenantHandle(eng, "acm").swap_params(served["compiled"].init(99)) == 2
    eng.submit(_req(1, [3]))
    (after,) = eng.step()
    assert after.params_version == 2
    assert not np.array_equal(before.logits, after.logits)
    with pytest.raises(KeyError, match="not registered"):
        TenantHandle(eng, "nope").swap_params(served["params"])
    with pytest.warns(DeprecationWarning, match="TenantHandle"):
        assert eng.swap_params("acm", served["params"]) == 3


def test_swap_params_version_monotonic_under_racing_submitter(served):
    eng = _engine(served)
    versions, order_lock, futs = [], threading.Lock(), []

    def _record(f):
        with order_lock:
            versions.append(f.result(timeout=WAIT).params_version)

    stop_flag = threading.Event()

    def _submitter():
        rid = 0
        while not stop_flag.is_set():
            fut = eng.submit(_req(rid, [rid % 50]))
            fut.add_done_callback(_record)
            futs.append(fut)
            rid += 1
            time.sleep(0.002)

    eng.run()
    t = threading.Thread(target=_submitter)
    t.start()
    try:
        last = 1
        for seed in range(4):
            time.sleep(0.02)
            last = TenantHandle(eng, "acm").swap_params(served["compiled"].init(seed + 1))
    finally:
        stop_flag.set()
        t.join(timeout=WAIT)
        eng.stop()
    assert not t.is_alive() and last == 5
    assert [f.result(timeout=WAIT).rid for f in futs] == list(range(len(futs)))
    assert len(versions) == len(futs) > 0
    assert versions == sorted(versions) and all(1 <= v <= 5 for v in versions)


def test_tenant_handle_submit_stats_and_name_guard(served):
    eng = HGNNServeEngine(session=served["session"])
    acm = eng.register("acm", served["graph"], TARGETS, _cfg(), params=served["params"])
    assert isinstance(acm, TenantHandle) and repr(acm) == "TenantHandle('acm')"
    fut = acm.submit(HGNNRequest(0, nodes=np.array([1, 2])))
    (resp,) = eng.step()
    assert fut.result(timeout=WAIT) is resp and resp.graph == "acm"
    with pytest.raises(ValueError, match="mixed-tenant"):
        acm.submit(HGNNRequest(1, "other", nodes=np.array([1])))
    st = acm.stats()
    assert st["version"] == 1 and st["fingerprint"] == acm.fingerprint
    assert st["served"] == 1 and st["submitted"] == 1
    assert acm.compiled is served["compiled"]


# --------------------------------------------------------------- graph swap --
def _tp_delta(graph, seed=0, k=3):
    """A cheap off-metapath delta: TP feeds none of TARGETS, so the swap
    migrates every cached product and recomposes nothing."""
    rng = np.random.default_rng(seed)
    tp = graph.relations["TP"]
    return GraphDelta.insert("TP", rng.integers(0, tp.num_src, k),
                             rng.integers(0, tp.num_dst, k))


def _swap_engine(served, executor="jnp", policy=None):
    """An engine over a session of its own (a swap migrates the session
    cache's entries to the new fingerprint; the shared session stays as
    the other tests found it)."""
    sess = Session(ExecutorSpec(na_executor=executor, device="cpu"))
    eng = HGNNServeEngine(session=sess, policy=policy)
    handle = eng.register("acm", served["graph"], TARGETS, _cfg(), params=served["params"])
    return eng, handle


@pytest.mark.parametrize("executor", ["jnp", "banded"])
@pytest.mark.parametrize("grow", [False, True])
def test_swap_graph_bumps_version_and_serves_new_topology(served, executor, grow):
    """An on-metapath delta (with vertex growth: features re-uploaded):
    rows bitwise a cold compile of the mutated graph, the bumped version on
    responses, the handle's fingerprint following the graph."""
    eng, acm = _swap_engine(served, executor)
    fp0 = acm.fingerprint
    ps = served["graph"].relations["PS"]
    rng = np.random.default_rng(11)
    n_p = served["graph"].num_vertices["P"]
    if grow:
        delta = GraphDelta(add_edges={"PS": (np.arange(n_p, n_p + 4),
                                             rng.integers(0, ps.num_dst, 4))},
                           add_vertices={"P": 4})
    else:
        delta = GraphDelta.insert("PS", rng.integers(0, ps.num_src, 5),
                                  rng.integers(0, ps.num_dst, 5))
    feats0 = eng._registered["acm"].features
    assert acm.swap_graph(delta, warm=True) == 2
    assert acm.version == 2 and acm.fingerprint != fp0
    g2 = served["graph"].apply_delta(delta)
    assert acm.fingerprint == g2.fingerprint() == acm.compiled.fingerprint
    feats = eng._registered["acm"].features
    assert (feats is not feats0) == grow
    assert feats["P"].shape[0] == g2.num_vertices["P"]
    fut = acm.submit(HGNNRequest(0))  # nodes=None: full-graph rows
    sub = acm.submit(HGNNRequest(1, nodes=np.array([n_p + 3 if grow else 7, 2])))
    eng.step()
    resp = fut.result(timeout=WAIT)
    assert resp.params_version == 2 and sub.result(timeout=WAIT).params_version == 2
    cold = Session(ExecutorSpec(na_executor=executor, device="cpu")).compile(
        g2, TARGETS, _cfg())
    want = cold.forward(served["params"], device_features(g2, "cpu")).numpy()
    np.testing.assert_array_equal(resp.logits, want)
    np.testing.assert_array_equal(sub.result(timeout=WAIT).logits,
                                  want[[n_p + 3 if grow else 7, 2]])


@pytest.mark.parametrize("executor", ["jnp", "banded"])
def test_swap_graph_zero_new_dependency_traces_off_metapath(served, executor):
    """An off-metapath delta changes no product: a dependency-mode group
    after the swap adds no dependency trace and returns the same rows."""
    eng, acm = _swap_engine(served, executor, ServePolicy(
        subset_mode="dependency", subset_threshold=0.9))
    ids = np.array([3, 1, 4], np.int64)
    acm.submit(HGNNRequest(0, nodes=ids))
    (before,) = eng.step()
    assert before.mode == "dependency"
    t0 = acm.compiled.dependency_traces
    assert t0 > 0
    assert acm.swap_graph(_tp_delta(served["graph"], seed=7)) == 2
    acm.submit(HGNNRequest(1, nodes=ids))
    (after,) = eng.step()
    assert after.mode == "dependency" and after.params_version == 2
    assert acm.compiled.dependency_traces == t0
    np.testing.assert_array_equal(before.logits, after.logits)


def test_swap_graph_mid_stream_futures_resolve_and_versions_monotone(served):
    """swap_graph races the background loop: every future resolves, and
    versions are non-decreasing in service order."""
    eng, acm = _swap_engine(served)
    versions, order_lock, futs = [], threading.Lock(), []

    def _record(f):
        with order_lock:
            versions.append(f.result(timeout=WAIT).params_version)

    stop_flag = threading.Event()

    def _submitter():
        rid = 0
        while not stop_flag.is_set():
            fut = acm.submit(HGNNRequest(rid, nodes=np.array([rid % 50])))
            fut.add_done_callback(_record)
            futs.append(fut)
            rid += 1
            time.sleep(0.002)

    eng.run()
    t = threading.Thread(target=_submitter)
    t.start()
    try:
        graph, last = served["graph"], 1
        for seed in range(2):
            time.sleep(0.05)
            delta = _tp_delta(graph, seed=seed)
            last = acm.swap_graph(delta)
            graph = graph.apply_delta(delta)
    finally:
        stop_flag.set()
        t.join(timeout=WAIT)
        eng.stop()
    assert not t.is_alive() and last == 3 and acm.version == 3
    assert [f.result(timeout=WAIT).rid for f in futs] == list(range(len(futs)))
    assert len(versions) == len(futs) > 0
    assert versions == sorted(versions) and all(1 <= v <= 3 for v in versions)


def test_swap_graph_rejects_stale_base_topology(served):
    """Deltas chain on the registration's current graph; a successor built
    from a superseded base loses the install race with ``RuntimeError``,
    and ``compile_delta`` refuses a graph that is not the model's."""
    eng, acm = _swap_engine(served)
    reg = eng._registered["acm"]
    acm.swap_graph(_tp_delta(served["graph"], seed=1))
    assert acm.swap_graph(_tp_delta(served["graph"], seed=2)) == 3
    with pytest.raises(ValueError, match="fingerprint"):
        eng.session.compile_delta(acm.compiled, served["graph"], _tp_delta(served["graph"]))
    real = eng.session.compile_delta

    def racing(compiled, graph, delta):
        out = real(compiled, graph, delta)
        reg.compiled = out[0]  # another swap installed first
        return out

    eng.session.compile_delta = racing
    with pytest.raises(RuntimeError, match="superseded"):
        acm.swap_graph(_tp_delta(reg.graph, seed=3))
    assert acm.version == 3


# ---------------------------------------------------------- fault injector --
def test_injector_rules_and_validation():
    inj = FaultInjector()
    with pytest.raises(ValueError, match="unknown fault site"):
        inj.inject("gpu", exc=TransientFault("x"))
    with pytest.raises(ValueError, match="unknown fault site"):
        inj.script("gpu", [None])
    with pytest.raises(ValueError, match="latency_ms"):
        inj.inject("forward", latency_ms=-1.0)
    with pytest.raises(ValueError, match="p must be"):
        inj.inject("forward", exc=TransientFault("x"), p=1.5)
    inj.inject("forward", exc=TransientFault("boom"), times=2, after=1)
    inj.fire("forward")
    for _ in range(2):
        with pytest.raises(TransientFault):
            inj.fire("forward")
    inj.fire("forward")
    assert inj.counts["forward"] == 4 and inj.raised["forward"] == 2
    inj.script("extract", [None, PermanentFault("2nd")])
    inj.fire("extract")
    with pytest.raises(PermanentFault):
        inj.fire("extract")
    inj.fire("extract")
    never = FaultInjector(seed=3).inject("forward", exc=TransientFault("x"), p=0.0)
    for _ in range(16):
        never.fire("forward")
    t0 = time.perf_counter()
    FaultInjector().inject("host_transfer", latency_ms=20.0, times=1).fire("host_transfer")
    assert time.perf_counter() - t0 >= 0.015
    inj.reset()
    inj.fire("forward")
    assert inj.counts == {"extract": 0, "forward": 1, "host_transfer": 0}


def test_is_transient_classification():
    assert is_transient(TransientFault("preempted"))
    assert is_transient(TimeoutError("slow")) and is_transient(ConnectionError("reset"))
    assert is_transient(OSError("io"))
    tagged = RuntimeError("custom")
    tagged.transient = True
    assert is_transient(tagged)
    assert not is_transient(PermanentFault("dead"))
    assert not is_transient(TypeError("bad params")) and not is_transient(KeyError("head"))


# ---------------------------------------------------------------- deadlines --
def test_deadline_expired_at_submit_fails_fast(served):
    eng = _engine(served)
    for dl in (0.0, -5.0):
        fut = eng.submit(_req(0, deadline_ms=dl))
        assert fut.done()
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=WAIT)
    s = eng.stats()
    assert s["requests_deadline_exceeded"] == 2 and s["queued"] == 0
    assert s["tenants"]["acm"]["deadline_exceeded"] == 2
    assert eng.step() == []


def test_deadline_expiring_while_queued_sheds_only_stale(served):
    eng = _engine(served, policy=ServePolicy(deadline_ms=10_000.0))
    stale = eng.submit(_req(0, deadline_ms=1.0))
    fresh = eng.submit(_req(1))  # the policy's default deadline
    time.sleep(0.02)
    assert [r.rid for r in eng.step()] == [1]
    with pytest.raises(DeadlineExceeded, match="expired while queued"):
        stale.result(timeout=WAIT)
    assert fresh.result(timeout=WAIT).rid == 1
    assert eng.stats()["requests_deadline_exceeded"] == 1


def test_deadline_expiring_while_computing_still_delivers(served):
    inj = FaultInjector().inject("host_transfer", latency_ms=40.0)
    eng = _engine(served, faults=inj)
    fut = eng.submit(_req(0, deadline_ms=20.0))
    eng.step()
    resp = fut.result(timeout=WAIT)
    assert isinstance(resp, HGNNResponse) and resp.compute_us >= 30_000
    assert eng.stats()["requests_deadline_exceeded"] == 0


# ------------------------------------------------------------------- quotas --
def test_quotas_burst_refill_atomic_and_isolated(served):
    eng = _engine(served, policy=ServePolicy(tenant_rate=0.0), names=("hot", "calm"))
    first = eng.submit(_req(0, name="hot"))
    with pytest.raises(QuotaExceeded):
        eng.submit(_req(1, name="hot"))
    with pytest.raises(QuotaExceeded):
        eng.submit([_req(2, name="calm"), _req(3, name="calm")])  # atomic
    calm = eng.submit(_req(4, name="calm"))  # its one token is still there
    eng.step()
    assert first.result(timeout=WAIT).rid == 0 and calm.result(timeout=WAIT).graph == "calm"
    s = eng.stats()
    assert s["requests_quota_rejected"] == 3
    assert s["tenants"]["hot"]["rejected_quota"] == 1
    assert s["tenants"]["calm"]["rejected_quota"] == 2
    refill = _engine(served, policy=ServePolicy(tenant_rate=100.0, tenant_burst=1))
    refill.submit(_req(0))
    with pytest.raises(QuotaExceeded):
        refill.submit(_req(1))
    time.sleep(0.03)
    fut = refill.submit(_req(2))
    refill.step()
    assert fut.result(timeout=WAIT).rid == 2


# ------------------------------------------------------------- retry ladder --
def test_transient_failure_retries_to_success(served):
    inj = FaultInjector().inject("forward", exc=TransientFault("boom"), times=2)
    eng = _engine(served, faults=inj, policy=ServePolicy(max_retries=3, retry_backoff_ms=1.0))
    fut = eng.submit(_req(0))
    assert len(eng.step()) == 1 and fut.result(timeout=WAIT).rid == 0
    s = eng.stats()
    assert s["retries"] == 2 and s["tenants"]["acm"]["failures"] == 2
    assert s["tenants"]["acm"]["breaker"] == "closed"


def test_permanent_and_exhausted_failures_fail_the_group(served):
    inj = FaultInjector().inject("forward", exc=PermanentFault("dead"), times=1)
    eng = _engine(served, faults=inj, policy=ServePolicy(max_retries=5, retry_backoff_ms=1.0))
    fut = eng.submit(_req(0))
    with pytest.raises(PermanentFault):
        eng.step()
    with pytest.raises(PermanentFault):
        fut.result(timeout=WAIT)
    assert inj.counts["forward"] == 1 and eng.stats()["retries"] == 0
    inj = FaultInjector().inject("forward", exc=TransientFault("flaky"))
    eng = _engine(served, faults=inj, policy=ServePolicy(max_retries=1, retry_backoff_ms=1.0))
    fut = eng.submit(_req(0))
    with pytest.raises(TransientFault):
        eng.step()
    with pytest.raises(TransientFault):
        fut.result(timeout=WAIT)
    assert inj.counts["forward"] == 2


@pytest.mark.parametrize("site", ["extract", "forward", "host_transfer"])
def test_every_site_recovers_through_retry(served, site):
    inj = FaultInjector().inject(site, exc=TransientFault(site), times=1)
    eng = _engine(served, faults=inj, policy=ServePolicy(
        subset_mode="dependency", dependency_threshold=1.0, max_retries=2,
        retry_backoff_ms=1.0))
    fut = eng.submit(_req(0))
    eng.step()
    assert fut.result(timeout=WAIT).rid == 0 and inj.raised[site] == 1


# ---------------------------------------------------------- circuit breaker --
def _breaker_policy(**kw):
    kw.setdefault("breaker_threshold", 2)
    kw.setdefault("breaker_cooldown_ms", 30.0)
    kw.setdefault("max_retries", 0)
    return ServePolicy(**kw)


def _trip(eng, n, start_rid=100):
    for k in range(n):
        eng.submit(_req(start_rid + k))
        with pytest.raises(Exception):
            eng.step()


def test_breaker_opens_probes_and_closes(served):
    inj = FaultInjector().inject("forward", exc=PermanentFault("dead"), times=2)
    eng = _engine(served, faults=inj, policy=_breaker_policy())
    _trip(eng, 2)
    assert eng.stats()["tenants"]["acm"]["breaker"] == "open"
    calls = inj.counts["forward"]
    fut = eng.submit(_req(0))
    with pytest.raises(CircuitOpen):
        eng.step()
    with pytest.raises(CircuitOpen):
        fut.result(timeout=WAIT)
    assert inj.counts["forward"] == calls  # no forward attempted
    time.sleep(0.05)
    fut = eng.submit(_req(1))
    eng.step()
    assert fut.result(timeout=WAIT).rid == 1
    s = eng.stats()
    assert s["tenants"]["acm"]["breaker"] == "closed" and s["breaker_fastfails"] == 1


def test_breaker_probe_failure_reopens(served):
    inj = FaultInjector().inject("forward", exc=PermanentFault("dead"))
    eng = _engine(served, faults=inj, policy=_breaker_policy())
    _trip(eng, 2)
    time.sleep(0.05)
    eng.submit(_req(0))
    with pytest.raises(PermanentFault):
        eng.step()
    assert eng.stats()["tenants"]["acm"]["breaker"] == "open"
    eng.submit(_req(1))
    with pytest.raises(CircuitOpen):
        eng.step()
    assert inj.counts["forward"] == 3


def test_breaker_isolates_failing_tenant_and_swap_resets_it(served):
    eng = _engine(served, names=("bad", "good"), policy=_breaker_policy(
        breaker_threshold=1, breaker_cooldown_ms=60_000.0))
    TenantHandle(eng, "bad").swap_params({"not": "params"})
    f_bad = eng.submit(_req(0, name="bad"))
    f_good = eng.submit(_req(1, name="good"))
    with pytest.raises(KeyError):
        eng.step()
    with pytest.raises(KeyError):
        f_bad.result(timeout=WAIT)
    assert f_good.result(timeout=WAIT).graph == "good"
    assert eng.stats()["tenants"]["bad"]["breaker"] == "open"
    f_bad2 = eng.submit(_req(2, name="bad"))
    f_good2 = eng.submit(_req(3, name="good"))
    with pytest.raises(CircuitOpen):
        eng.step()
    with pytest.raises(CircuitOpen):
        f_bad2.result(timeout=WAIT)
    assert f_good2.result(timeout=WAIT).graph == "good"
    TenantHandle(eng, "bad").swap_params(served["params"])  # heals, resets
    fut = eng.submit(_req(4, name="bad"))
    eng.step()
    assert fut.result(timeout=WAIT).rid == 4
    assert eng.stats()["tenants"]["bad"]["breaker"] == "closed"


def test_swap_params_mid_retry_heals_the_group(served):
    inj = FaultInjector().inject("forward", exc=TransientFault("blip"), times=1)
    eng = _engine(served, faults=inj, policy=ServePolicy(max_retries=3, retry_backoff_ms=30.0))
    eng.run()
    try:
        fut = eng.submit(_req(1))
        TenantHandle(eng, "acm").swap_params(served["params"])  # lands during backoff
        resp = fut.result(timeout=WAIT)
    finally:
        eng.stop()
    assert resp.params_version == 2


# ------------------------------------------------------ degradation ladder --
def test_pressure_degrades_dependency_to_head(served):
    inj = FaultInjector()
    eng = _engine(served, faults=inj, policy=ServePolicy(
        subset_mode="dependency", dependency_threshold=1.0, max_queue=4,
        degrade_pressure=0.75))
    futs = eng.submit([_req(i, [i]) for i in range(4)])
    eng.step()
    assert all(f.result(timeout=WAIT).mode == "subset" for f in futs)
    assert inj.counts["extract"] == 0 and eng.stats()["degraded_steps"] == 1
    fut = eng.submit(_req(9, [3]))
    eng.step()
    assert fut.result(timeout=WAIT).mode == "dependency"
    assert inj.counts["extract"] == 1 and eng.stats()["degraded_steps"] == 1


# ---------------------------------------------------------- chaos property --
@seeded_property(max_examples=10)
def test_every_admitted_future_resolves_exactly_once(served, seed):
    """Under probabilistic faults at every site, mixed deadlines, quotas and
    retries, every future ``submit`` returned resolves once — to a
    response or a classified error, never a silent drop, hang or second
    delivery."""
    rng = np.random.default_rng(seed)
    inj = FaultInjector(seed=seed)
    for site in FaultInjector.SITES:
        inj.inject(site, exc=TransientFault(site), p=float(rng.uniform(0, 0.4)))
    inj.inject("host_transfer", latency_ms=float(rng.uniform(0, 2.0)))
    eng = _engine(served, faults=inj, policy=ServePolicy(
        subset_mode="dependency", dependency_threshold=1.0, max_retries=1,
        retry_backoff_ms=0.5, breaker_threshold=3, breaker_cooldown_ms=5.0,
        tenant_rate=1000.0, tenant_burst=16))
    futs, deliveries = [], []
    deadlines = (None, 0.0, 1.0, 10_000.0)
    for rid in range(int(rng.integers(4, 9))):
        nodes = np.unique(rng.integers(0, 40, size=int(rng.integers(1, 5))))
        fut = eng.submit(_req(rid, nodes=nodes,
                              deadline_ms=deadlines[int(rng.integers(0, len(deadlines)))]))
        fut.add_done_callback(lambda f, rid=rid: deliveries.append(rid))
        futs.append(fut)
    for _ in range(4):
        try:
            eng.step()
        except (TransientFault, CircuitOpen):
            pass  # the futures already carry it
    assert all(f.done() for f in futs), "silent drop: an admitted future hangs"
    assert sorted(deliveries) == list(range(len(futs)))  # each exactly once
    for f in futs:
        exc = f.exception(timeout=WAIT)
        if exc is None:
            assert isinstance(f.result(timeout=WAIT), HGNNResponse)
        else:
            assert isinstance(exc, (DeadlineExceeded, TransientFault, CircuitOpen))


# ---------------------------------------------------------- batching window --
def test_policy_validation():
    for kw, match in ((dict(batch_window_ms=-1.0), "batch_window_ms"),
                      (dict(batch_window_ms=10.0, batch_max_size=0), "batch_max_size"),
                      (dict(batch_max_size=4), "batch_max_size without"),
                      (dict(subset_mode="spam"), "subset_mode"),
                      (dict(dependency_threshold=1.5), "dependency_threshold"),
                      (dict(tenant_burst=3), "tenant_burst without"),
                      (dict(retry_backoff_ms=10.0, retry_backoff_cap_ms=1.0), "cap"),
                      (dict(degrade_pressure=0.0), "degrade_pressure")):
        with pytest.raises(ValueError, match=match):
            ServePolicy(**kw)
    p = ServePolicy(batch_window_ms=25.0, batch_max_size=8, tenant_rate=2.5)
    assert p.batch_max_size == 8 and p.effective_burst == 3


def test_window_deadline_slack_never_held_full_window(served):
    eng = _engine(served, ServePolicy(batch_window_ms=2000.0))
    eng.run()
    try:
        t0 = time.perf_counter()
        fut = eng.submit(_req(0, [1, 2], deadline_ms=1.0))
        try:
            fut.result(timeout=10)
        except DeadlineExceeded:
            pass  # shed and served are both legal
        assert time.perf_counter() - t0 < 1.0 and fut.done()
        assert eng.stats()["tenants"]["acm"]["early_closes"] >= 1
    finally:
        eng.stop()


def test_window_rearm_batches_concurrent_submits(served):
    eng = _engine(served, ServePolicy(batch_window_ms=600.0))
    eng.run()
    try:
        f0 = eng.submit(_req(0, [1, 2, 3]))
        time.sleep(0.15)
        f1 = eng.submit(_req(1, [4, 5]))
        r0, r1 = f0.result(timeout=WAIT), f1.result(timeout=WAIT)
        assert r0.batched_with == 2 and r1.batched_with == 2
        t = eng.stats()["tenants"]["acm"]
        assert t["batches"] == 1 and t["mean_batch_size"] == 2.0
        assert t["window_timeouts"] == 1 and t["early_closes"] == 0
    finally:
        eng.stop()


def test_window_closes_early_on_size(served):
    eng = _engine(served, ServePolicy(batch_window_ms=60_000.0, batch_max_size=2))
    eng.run()
    try:
        futs = eng.submit([_req(0, [1]), _req(1, [2, 3])])
        assert all(f.result(timeout=WAIT).batched_with == 2 for f in futs)
        t = eng.stats()["tenants"]["acm"]
        assert t["early_closes"] == 1 and t["window_timeouts"] == 0
    finally:
        eng.stop()


def test_tenant_batching_stats_hand_computed(served):
    eng = _engine(served, ServePolicy())
    for rids in ((0, 1, 2), (3, 4), (5,)):
        eng.submit([_req(i, [i + 1]) for i in rids])
        eng.step()
    t = eng.stats()["tenants"]["acm"]
    assert t["batches"] == 3 and t["mean_batch_size"] == pytest.approx(2.0)
    eng.submit(_req(6, [7]))
    eng.step(window_close="timeout")
    eng.submit(_req(7, [8]))
    eng.step(window_close="size")
    t = eng.stats()["tenants"]["acm"]
    assert t["batches"] == 5 and t["mean_batch_size"] == pytest.approx(8 / 5)
    assert t["window_timeouts"] == 1 and t["early_closes"] == 1


ROUNDS, ROUND_SIZE = 2, 3


@pytest.fixture(scope="module")
def window_sessions(served):
    cache = SemanticGraphCache()
    return {ex: Session(ExecutorSpec(na_executor=ex, device="cpu"), cache=cache)
            for ex in ("jnp", "banded")}


@pytest.mark.parametrize("executor", ["jnp", "banded"])
@pytest.mark.parametrize("model", ["rgcn", "rgat", "shgn"])
@seeded_property(max_examples=3, seeds=(0, 7, 42))
def test_window_results_bitwise_equal_per_request(served, window_sessions, executor,
                                                  model, seed):
    """The same request stream through a window engine (one forward a
    drain) and through a no-window engine stepped once a request resolves
    every future to bitwise-equal logits and predictions, with the same
    monotone versions across a mid-stream ``swap_params``."""
    sess, graph = window_sessions[executor], served["graph"]
    compiled = sess.compile(graph, TARGETS, _cfg(model))
    params = [compiled.init(seed), compiled.init(seed + 1)]
    rng = np.random.default_rng(seed)
    rounds, rid = [], 0
    for _ in range(ROUNDS):
        batch = []
        for _ in range(ROUND_SIZE):
            batch.append((rid, np.unique(rng.integers(0, 16, size=int(rng.integers(2, 7))))))
            rid += 1
        rounds.append(batch)
    win = HGNNServeEngine(session=sess, policy=ServePolicy(
        batch_window_ms=250.0, batch_max_size=ROUND_SIZE))
    win_h = win.register("acm", graph, TARGETS, _cfg(model), params=params[0], warm=False)
    ref = HGNNServeEngine(session=sess, policy=ServePolicy())
    ref_h = ref.register("acm", graph, TARGETS, _cfg(model), params=params[0], warm=False)
    win.run()
    try:
        win_resp, ref_resp = {}, {}
        for rnd, batch in enumerate(rounds):
            for f in win.submit([_req(r, ids) for r, ids in batch]):
                r = f.result(timeout=WAIT)
                win_resp[r.rid] = r
            for r_id, ids in batch:
                fut = ref.submit(_req(r_id, ids))
                ref.step()
                r = fut.result(timeout=WAIT)
                assert r.batched_with == 1
                ref_resp[r.rid] = r
            if rnd + 1 < ROUNDS:
                assert win_h.swap_params(params[rnd + 1]) == rnd + 2
                assert ref_h.swap_params(params[rnd + 1]) == rnd + 2
    finally:
        win.stop()
    assert sorted(win_resp) == sorted(ref_resp)
    versions = [win_resp[r].params_version for r in sorted(win_resp)]
    assert versions == [ref_resp[r].params_version for r in sorted(ref_resp)]
    assert versions == [1] * ROUND_SIZE + [2] * (len(versions) - ROUND_SIZE)
    for r in sorted(win_resp):
        a, b = win_resp[r], ref_resp[r]
        np.testing.assert_array_equal(a.logits, b.logits)
        np.testing.assert_array_equal(a.predictions, b.predictions)
        assert a.mode == b.mode == "subset"
