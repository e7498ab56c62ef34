"""The span metrics: each reader on a hand-built record (and ``None``
where its span or counter is absent), the traced run's profiled passes
with recording off, and the span passes on a CPU-sized cell."""
import pytest

from gbench import harness, spans
from gbench import trace as gtrace
from gbench.trace import TraceRecord

from conftest import context, small_cell

SPANS = {"train.forward": 0.3, "train.backward": 0.6, "train.optimizer": 0.09,
         "hgnn.na": 0.12, "hgnn.na.backward": 0.18, "lm.attn.backward": 0.4,
         "lm.moe.route": 0.05, "lm.moe.dispatch": 0.15, "kernels.k4": 0.02}
SETUP = {"frontend.restructure.recouple": 9.5, "frontend.restructure.decouple": 4.25}
COUNTERS = {"lm.moe.slots_filled": 3, "lm.moe.slots": 4}

# metric -> its value on the record below (3 steps; device seconds over them)
EXPECTED = {
    "step_forward_ms.hgnn_train": 100.0, "step_backward_ms.hgnn_train": 200.0,
    "step_optimizer_ms.hgnn_train": 30.0, "na_ms.hgnn_train": 100.0,
    "restructure_recouple_s": 9.5, "restructure_decouple_s": 4.25,
    "step_backward_ms.lm_train": 200.0, "step_optimizer_ms.lm_train": 30.0,
    "attn_backward_ms.lm_train": 400.0 / 3, "moe_dispatch_ms.lm_train": 200.0 / 3,
    "moe_slot_fill_pct.lm_train": 75.0, "k4_ms.prefill": 20.0 / 3,
    "moe_dispatch_ms.prefill": 200.0 / 3,
}


def _record(spans_=None, setup=None, counters=None):
    facts = {}
    if spans_ is not None:
        facts.update(spans={n: {"calls": 2, "host_s": 2 * d, "device_s": d}
                            for n, d in spans_.items()}, span_steps=3,
                     span_counters=dict(counters or {}))
    if setup is not None:
        facts["setup_spans"] = {n: {"calls": 3, "host_s": s, "device_s": None}
                                for n, s in setup.items()}
    return TraceRecord(steps=3, window_s=1.0, busy_s=0.5, device_ops=[], idle_gaps=[],
                       facts=facts)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_its_spans_and_nothing_without_them(name):
    read = harness.metric_reader(name).read
    assert read(_record(SPANS, SETUP, COUNTERS)) == pytest.approx(EXPECTED[name])
    assert read(_record()) is None  # a program without spans: left out
    assert read(_record({}, {}, {})) is None


def test_a_span_without_device_time_reads_none():
    rec = _record(SPANS)
    rec.facts["spans"]["kernels.k4"]["device_s"] = None
    assert spans.span_ms(rec, "kernels.k4") is None
    assert spans.span_ms(rec, "train.forward") == pytest.approx(100.0)
    assert spans.counter_pct(_record(SPANS, counters={"lm.moe.slots": 0}),
                             "lm.moe.slots_filled", "lm.moe.slots") is None


@pytest.mark.parametrize("cell", ["granite-moe-1b-a400m.train_4k",
                                  "granite-moe-1b-a400m.prefill_2k"])
def test_traced_run_profiles_with_recording_off(cell, monkeypatch):
    from repro_torch import tracing

    seen = []
    original = gtrace.profile_steps

    def watched(*args, **kw):
        assert not tracing._on
        tracing.reset()
        rec = original(*args, **kw)
        seen.append(tracing.snapshot()["spans"])
        return rec

    monkeypatch.setattr(gtrace, "profile_steps", watched)
    res = harness.driver(small_cell(cell).kind).run(context(small_cell(cell), trace=True))
    assert res.trace is not None and seen == [[]]  # the device-trace passes record no span


def test_span_passes_on_cpu_cells():
    import span_passes

    out = span_passes.measure(context(small_cell("granite-moe-1b-a400m.train_4k")), 1, 1)
    m = out["metrics"]
    assert set(m) == set(span_passes.METRICS["lm_train"])
    # no device times on the CPU; the counters read
    assert m["step_backward_ms.lm_train"] is None
    assert 0 < m["moe_slot_fill_pct.lm_train"] <= 100.0
    per = out["spans_per_step"]
    assert per["train.step"]["calls"] == 1 and per["lm.moe.route"]["calls"] == 4
    assert out["setup_spans"]["train.step"]["calls"] == 3  # the set-up's first steps
    assert all(n.startswith(spans.SPAN_PREFIXES) for n, _ in out["idle_by_span"])

    out = span_passes.measure(context(small_cell("shgn-dblp.train")), 1, 1)
    m = out["metrics"]
    assert set(m) == set(span_passes.METRICS["hgnn_train"])
    assert m["restructure_recouple_s"] > 0 and m["restructure_decouple_s"] > 0
    assert m["step_forward_ms.hgnn_train"] is None
    assert out["setup_spans"]["frontend.restructure.recouple"]["calls"] == 3  # 3 metapaths
