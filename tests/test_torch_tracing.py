"""The port's spans and counters (``repro_torch.tracing``) on the CPU: off,
a tiny HGNN step and a tiny MoE LM step leave no record, create no CUDA
event and enter no ``record_function``; on, a step's spans form the tree
``train.step`` -> forward, backward, optimizer, the NA and attention
Functions' backward sit under ``train.backward`` (also when opened on
another thread, as autograd's device thread opens them), each step has
its own identifier, the MoE counters are consistent, and the frontend's
``timings`` keep their keys and come from the stage spans' clock reads."""
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

# PyTorch's CPU build can return a wrong result for the first vectorized
# float op of a fresh process: spend it here (ROADMAP, queue 3)
torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))

from repro_torch import configs, tracing  # noqa: E402
from repro_torch.api import ExecutorSpec, Session, device_features  # noqa: E402
from repro_torch.core.hgnn import HGNNConfig  # noqa: E402
from repro_torch.hetero import make_dataset  # noqa: E402
from repro_torch.kernels import cuda_build  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.pipeline import FrontendPipeline, SemanticGraphCache  # noqa: E402
from repro_torch.train import (adamw_init, make_train_step,  # noqa: E402
                               semi_supervised_masks)
from repro_torch.train.hgnn_step import HGNNTrainState  # noqa: E402
from repro_torch.train.train_step import TrainState, build_train_step  # noqa: E402

TARGETS = ["APA", "PAP"]
LAUNCHES = {"seg_sum_na.launches", "edge_softmax_stats.launches", "spgemm_bsr.launches",
            "flash_attention.launches", "ssd_scan.launches"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for these small ops: under the suite's parallel
    workers a thread pool a process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hgnn():
    """One step of a tiny Simple-HGN on ACM (banded executor, CPU)."""
    graph = make_dataset("ACM", scale=0.05)
    c = Session(ExecutorSpec(device="cpu")).compile(
        graph, TARGETS, HGNNConfig(model="shgn", hidden=8, num_layers=2, target_type="P"))
    feats = device_features(graph, "cpu")
    labels = torch.zeros(c.num_target, dtype=torch.int32)
    mask = semi_supervised_masks(c.num_target, seed=0, device="cpu")["train"]
    step = make_train_step(c.model, c.graphs, warmup=1, total=10)
    params = c.model.init(0, device="cpu")
    box = {"state": HGNNTrainState(params=params, opt=adamw_init(params))}

    def one():
        box["state"], _ = step(box["state"], feats, labels, mask)

    return one


@pytest.fixture(scope="module")
def lm():
    """One step of reduced granite-moe (2 layers, 4 experts top 2, remat
    full), B = 2 x S = 32: one routing group of 64 tokens."""
    torch.manual_seed(0)
    model = LM(configs.reduced(configs.get_config("granite-moe-1b-a400m")), device="cpu",
               remat="full")
    step, _ = build_train_step(model, make_debug_mesh(1, 1, device="cpu"), 2, lr=1e-3)
    params = model.init(0)
    box = {"state": TrainState(params=params, opt=adamw_init(params), residuals=None)}
    tok = torch.randint(0, 500, (2, 33))

    def one():
        box["state"], _ = step(box["state"], tok[:, :-1], tok[:, 1:])

    return one


def _steps(request, kind, n=1):
    """The spans of ``n`` recorded steps of ``kind``'s fixture."""
    one = request.getfixturevalue(kind)
    tracing.reset()
    with tracing.recording():
        for _ in range(n):
            one()
    return tracing.snapshot()


@pytest.mark.parametrize("kind", ["hgnn", "lm"])
def test_off_leaves_no_record_no_event_no_record_function(request, kind, monkeypatch):
    one = request.getfixturevalue(kind)

    def refuse(*a, **k):
        raise AssertionError("touched while recording is off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tracing.reset()
    one()
    snap = tracing.snapshot()
    assert snap["spans"] == []
    assert set(snap["counters"]) == LAUNCHES  # only the kernels' own counters
    assert tracing.span("a") is tracing.span("b", layer=1)  # one shared no-op


@pytest.mark.parametrize("kind", ["hgnn", "lm"])
def test_a_step_is_one_tree_under_train_step(request, kind):
    spans = _steps(request, kind)["spans"]
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["train.step"]
    children = [s["name"] for s in spans if s["parent"] == roots[0]["id"]]
    assert children == ["train.forward", "train.backward", "train.optimizer"]
    by_id = {s["id"]: s for s in spans}
    for s in spans:  # every span reaches the root, and a parent holds its child
        p = s
        while p["parent"] is not None:
            q = by_id[p["parent"]]
            assert q["t0_ns"] <= p["t0_ns"] and p["t1_ns"] <= q["t1_ns"]
            p = q
        assert p is roots[0]
    assert all(s["device_s"] is None for s in spans)  # no CUDA here


@pytest.mark.parametrize("kind,name,count", [("hgnn", "hgnn.na.backward", 2),
                                             ("lm", "lm.attn.backward", 2)])
def test_function_backward_spans_sit_under_train_backward(request, kind, name, count):
    spans = _steps(request, kind)["spans"]
    by_id = {s["id"]: s for s in spans}
    found = [s for s in spans if s["name"] == name]
    # hgnn: PAP's call in each layer (APA's outputs never reach P's head);
    # lm: one a layer
    assert len(found) == count
    assert {by_id[s["parent"]]["name"] for s in found} == {"train.backward"}


def test_a_span_opened_on_a_thread_with_none_open_takes_the_adopting_span():
    tracing.reset()
    with tracing.recording():
        with tracing.span("train.step"):
            with tracing.span("train.backward", adopt=True):
                t = threading.Thread(target=lambda: tracing.span("lm.attn.backward").__enter__()
                                     .__exit__(None, None, None))
                t.start()
                t.join()
            t = threading.Thread(target=lambda: tracing.span("other").__enter__()
                                 .__exit__(None, None, None))
            t.start()
            t.join()
    spans = {s["name"]: s for s in tracing.snapshot()["spans"]}
    assert spans["lm.attn.backward"]["parent"] == spans["train.backward"]["id"]
    assert spans["lm.attn.backward"]["step"] == spans["train.step"]["step"]
    assert spans["other"]["parent"] is None  # no adopting span open: a root
    assert spans["other"]["step"] != spans["train.step"]["step"]


@pytest.mark.parametrize("kind", ["hgnn", "lm"])
def test_each_step_has_its_own_identifier(request, kind):
    spans = _steps(request, kind, n=2)["spans"]
    roots = [s for s in spans if s["name"] == "train.step"]
    assert len(roots) == 2 and roots[0]["step"] != roots[1]["step"]
    for root, other in (roots, roots[::-1]):
        mine = [s for s in spans if root["t0_ns"] <= s["t0_ns"] <= root["t1_ns"]]
        assert mine and all(s["step"] == root["step"] != other["step"] for s in mine)


def test_moe_counters_and_spans(request):
    snap = _steps(request, "lm")
    c = snap["counters"]
    # 2 layers, each routed twice (forward and the remat recompute): 1 group
    # x 4 experts x capacity max(ceil(64 * 2 * 1.25 / 4), 2) = 40 slots a call
    assert c["lm.moe.slots"] == 2 * 2 * 4 * 40
    assert 0 < c["lm.moe.slots_filled"] <= c["lm.moe.slots"]
    assert c["lm.moe.slots_filled"] <= 2 * 2 * 64 * 2  # every token's two slots at most
    calls = {k: v["calls"] for k, v in tracing.totals(snap).items()}
    for name in ("lm.moe.route", "lm.moe.dispatch", "lm.moe.experts", "lm.moe.combine"):
        assert calls[name] == 4
    assert "kernels.k4" not in calls  # it wraps K4's CUDA launch; the CPU runs the plain version


def test_frontend_timings_keep_their_keys_and_come_from_the_spans():
    graph = make_dataset("ACM", scale=0.05)
    res = FrontendPipeline(cache=SemanticGraphCache()).run(graph, TARGETS)
    assert list(res.timings) == ["sgb", "restructure", "pack", "total"]
    assert res.timings["total"] == pytest.approx(sum(
        v for k, v in res.timings.items() if k != "total"))
    tracing.reset()
    with tracing.recording():
        res = FrontendPipeline(cache=SemanticGraphCache()).run(graph, TARGETS)
    spans = tracing.snapshot()["spans"]
    assert list(res.timings) == ["sgb", "restructure", "pack", "total"]
    top = {s["name"]: s for s in spans if s["parent"] is None}
    for key in ("sgb", "restructure", "pack"):
        assert top[f"frontend.{key}"]["host_s"] == res.timings[key]
    stages = [s for s in spans if s["name"].startswith("frontend.restructure.")]
    assert sorted({s["attrs"]["metapath"] for s in stages}) == TARGETS
    assert [s["name"].rsplit(".", 1)[1] for s in stages[:3]] == [
        "decouple", "recouple", "validate"]
    for s in stages:
        assert s["parent"] == top["frontend.restructure"]["id"]
        assert s["attrs"]["edges"] == res.semantic[s["attrs"]["metapath"]].num_edges


def test_counters_totals_timed_and_reset():
    out = {}
    with tracing.timed("off", out, "k"):  # off: still timed, nothing recorded
        pass
    assert out["k"] >= 0
    tracing.reset()
    with tracing.recording():
        tracing.count("n", 2)
        tracing.count("n", 3)
        tracing.count("t", torch.tensor([True, False, True]))
        for _ in range(2):
            with tracing.timed("stage", out, "stage", size=4) as sp:
                sp.set(done=True)
    tracing.count("n", 100)  # off again
    snap = tracing.snapshot()
    assert snap["counters"]["n"] == 5 and snap["counters"]["t"] == 2
    tot = tracing.totals(snap)["stage"]
    assert tot["calls"] == 2 and tot["device_s"] is None
    assert out["stage"] == snap["spans"][-1]["host_s"]
    assert snap["spans"][0]["attrs"] == {"size": 4, "done": True}
    assert snap == tracing.snapshot()  # reading again changes nothing
    tracing.reset()
    assert tracing.snapshot()["spans"] == [] and "n" not in tracing.snapshot()["counters"]


def test_kernel_build_span_names_built_and_cached_stems(monkeypatch):
    info = {"na_kernels": {"built": True}, "flash_attention": {"built": False}}
    monkeypatch.setattr(cuda_build, "_build_all", lambda: info)
    tracing.reset()
    with tracing.recording():
        assert cuda_build.build_all() is info
    (s,) = tracing.snapshot()["spans"]
    assert s["name"] == "kernels.build"
    assert s["attrs"] == {"built": ["na_kernels"], "cached": ["flash_attention"]}


def test_threads_lose_no_span_and_no_count():
    """More threads than cores open nested spans and count at once."""
    n, each = 16, 50

    def work(i):
        for _ in range(each):
            with tracing.span("outer", worker=i):
                with tracing.span("inner"):
                    tracing.count("c", 1)
                    tracing.count("t", torch.ones(2, dtype=torch.int64))

    tracing.reset()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording():
            threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = tracing.snapshot()
    assert snap["counters"]["c"] == n * each and snap["counters"]["t"] == 2 * n * each
    by_id = {s["id"]: s for s in snap["spans"]}
    inner = [s for s in snap["spans"] if s["name"] == "inner"]
    assert len(inner) == n * each and len(by_id) == 2 * n * each
    for s in inner:  # each inner span under its own thread's outer span
        assert by_id[s["parent"]]["name"] == "outer"
        assert by_id[s["parent"]]["step"] == s["step"]
    assert len({s["step"] for s in snap["spans"]}) == n * each
