"""Metric arithmetic on the CPU: rates and step times over the whole
window, the p95 over all requests, a planted stall, the roofline over
recorded launches, and the FLOP and byte counts by hand."""
import math
import time

import pytest

from gbench import arith, common, readers
from gbench.trace import TraceRecord, gaps, name_gaps, union_seconds


def test_window_counts_every_call_and_all_its_time():
    calls = []

    def call():
        calls.append(time.perf_counter())
        time.sleep(0.01)

    n, seconds = common.window(call, 0.1, "cpu")
    assert n == len(calls) and n >= 5
    # the window covers the last call too: at least n calls of 10 ms
    assert seconds >= n * 0.01
    assert seconds >= 0.1


def test_a_stall_moves_the_rate_and_the_p95():
    def run(stall_every):
        lat, k = [], [0]

        def call():
            t0 = time.perf_counter()
            stalled = stall_every and k[0] % stall_every == stall_every - 1
            time.sleep(0.03 if stalled else 0.002)
            k[0] += 1
            lat.append(time.perf_counter() - t0)

        n, seconds = common.window(call, 0.5, "cpu")
        return n / seconds, common.percentile(lat, 95)

    rate, p95 = run(stall_every=0)
    rate_s, p95_s = run(stall_every=8)  # one request in eight stalls
    assert rate_s < 0.6 * rate  # the stalls' time is in the window
    assert p95_s >= 0.03 > p95  # and in the tail


def test_p95_is_over_all_requests():
    lat = list(range(1, 101))  # 1 .. 100
    assert common.percentile(lat, 95) == 95
    assert common.percentile(lat, 50) == 50
    assert common.percentile([5.0], 95) == 5.0
    stalled = lat[:-10] + [1000] * 10  # ten slow requests of a hundred
    assert common.percentile(stalled, 95) == 1000


def test_p95_of_a_stall_in_a_window():
    # 200 requests of 10 ms, one stall of 2 s: the p95 stays 10 ms but
    # twenty stalls move it
    base = [0.01] * 200
    assert common.percentile(base[:-1] + [2.0], 95) == 0.01
    assert common.percentile(base[:-20] + [2.0] * 20, 95) == 2.0


def _record(ops, steps, facts, window=1.0):
    iv = [(s, s + d) for _, s, d in ops]
    return TraceRecord(steps=steps, window_s=window, busy_s=union_seconds(iv), device_ops=ops,
                       idle_gaps=[], facts=facts)


def test_roofline_uses_each_launchs_own_bound():
    # one step: K2 (bound 1), K1 (bound 2), K1 (bound 4); two steps recorded
    expected = [("K2", 1.0), ("K1", 2.0), ("K1", 4.0)]
    ops = []
    t = 0.0
    for _ in range(2):
        for name, dur in (("softmax_stats_rows_kernel", 2.0), ("seg_sum_rows_kernel", 4.0),
                          ("seg_sum_rows_kernel", 8.0)):
            ops.append((name, t, dur))
            t += dur
    rec = _record(ops, 2, {"na_launches": expected})
    kernels = {"K1": "seg_sum_rows_kernel", "K2": "softmax_stats_rows_kernel"}
    # bounds 2 * (1 + 2 + 4) = 14 over 2 * (2 + 4 + 8) = 28 seconds
    assert readers.roofline_pct(rec, kernels, "na_launches") == pytest.approx(50.0)
    # a lost launch: the rest take their kind's mean bound
    rec = _record(ops[:-1], 2, {"na_launches": expected})
    bound = 2 * 1.0 + 3 * 3.0  # K2 twice at 1; K1 three times at the mean of 2 and 4
    dur = 2 * 2.0 + 4 + 8 + 4
    assert readers.roofline_pct(rec, kernels, "na_launches") == pytest.approx(100 * bound / dur)
    assert readers.roofline_pct(rec, kernels, "missing") is None


def test_launches_idle_and_mfu():
    ops = [("k", 0.0, 0.25), ("Memcpy HtoD", 0.25, 0.05), ("k", 0.5, 0.25), ("Memset (Device)", 0.8, 0.01)]
    rec = _record(ops, 2, {"flops_per_step": 67e12 * 0.1, "peak_flop_per_s": 67e12}, window=1.0)
    assert readers.launches_per_step(rec) == 1.0
    assert rec.busy_s == pytest.approx(0.56)
    assert readers.device_idle_pct(rec) == pytest.approx(44.0)
    assert readers.mfu_pct(rec) == pytest.approx(20.0)
    assert readers.frontend_stage_s(_record(ops, 1, {"frontend": {"sgb": 0.5}}), "sgb") == 0.5
    assert readers.frontend_stage_s(rec, "sgb") is None


def test_gaps_are_named_by_the_host_operation_under_them():
    iv = [(0.0, 1.0), (2.0, 3.0), (5.0, 6.0)]
    assert union_seconds(iv + [(0.5, 1.5)]) == pytest.approx(3.5)
    assert gaps(iv) == [(1.0, 2.0), (3.0, 5.0)]
    named = name_gaps(gaps(iv), [("step", 0.0, 10.0), ("aten::index", 1.2, 1.9),
                                 ("adamw", 3.0, 5.5)])
    assert named == [("adamw", 2.0), ("aten::index", 1.0)]


def test_k1_k2_bytes_and_flops_by_hand():
    # E = 10 edges, 2 blocks, 3 tiles, 4 sources, 5 destinations, D = 8
    nbytes, flops = arith.k1_launch(10, 2, 3, 4, 5, 8)
    assert nbytes == 10 * 8 + 4 * 8 * 4 + 5 * 8 * 4 + (2 * 8 + 2 * 4 + 4 * 4)
    assert flops == 2 * 10 * 8
    nbytes, flops = arith.k2_launch(10, 2, 3, 5)
    assert nbytes == 10 * 6 + 8 + 8 + 16 + 5 * 8
    assert flops == 60
    assert arith.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert arith.bound_s(0.0, 67e12) == pytest.approx(1.0)


def test_na_launch_order_of_a_train_step():
    g = {"edges": 10, "blocks": 2, "tiles": 3, "num_src": 4, "num_dst": 5}
    h = {"edges": 20, "blocks": 2, "tiles": 3, "num_src": 4, "num_dst": 5}
    seq = arith.na_train_launches([g, h], d=8, layers=2)
    kinds = [k for k, _ in seq]
    assert kinds == ["K2", "K1"] * 4 + ["K1", "K1"] * 4
    b = lambda e, d: arith.bound_s(*arith.k1_launch(e, 2, 3, 4, 5, d))  # noqa: E731
    # the backward walks the calls in reverse: layer 1's h first, at width 1 then d
    assert seq[8][1] == b(20, 1) and seq[9][1] == b(20, 8)
    assert seq[-2][1] == b(10, 1) and seq[-1][1] == b(10, 8)


def test_k4_counts_by_hand():
    # B = 1, 2 / 1 heads, S = T = 4, D = 8, causal: 10 live pairs a head
    assert arith.k4_pairs(4, 4, True) == 10
    assert arith.k4_pairs(4, 4, False) == 16
    assert arith.k4_pairs(4, 4, True, window=2) == 3 + 2 * 2
    nbytes, flops = arith.k4_launch(1, 2, 1, 4, 4, 8, 8, True)
    assert flops == 2.0 * 10 * 16 * 2
    assert nbytes == 2.0 * (2 * 4 * 8 + 4 * 8 + 4 * 8 + 2 * 4 * 8)


def test_lm_flops_by_hand():
    cfg = {"d_model": 4, "num_heads": 2, "num_kv_heads": 1, "head_dim": 2, "num_layers": 3,
           "num_experts": 4, "experts_per_token": 2, "moe_d_ff": 3, "vocab_size": 10}
    b, s = 2, 3
    tok = b * s
    proj = 2 * 4 * 2 * (2 * 2 + 2 * 1) * tok
    attn = 2 * 6 * 2 * 2 * 2 * b  # 6 live pairs, q.k and p.v of width 2, 2 heads
    router = 2 * 4 * 4 * tok
    experts = 3 * 2 * 4 * 3 * 2 * tok
    head = 2 * 4 * 10 * s * b
    fwd = 3 * (proj + attn + router + experts) + head
    assert arith.lm_forward_flops(cfg, b, s) == fwd
    assert arith.lm_forward_flops(cfg, b, s, head_rows=1) == fwd - head + 2 * 4 * 10 * b
    assert arith.lm_train_flops(cfg, b, s) == 3 * fwd


def test_hgnn_flops_by_hand():
    nv = {"A": 3, "P": 2}
    dims = {"A": 5, "P": 0}
    g = [{"edges": 7, "num_src": 3, "num_dst": 3, "dst_type": "A"}]
    h, att, c = 4, 2, 2
    fp0 = 2 * 3 * 5 * h + 3 * h, 2 * 2 * 1 * h + 2 * h  # A, P
    na = 2 * 3 * h * h + 2 * 3 * h + 2 * 3 * h + 6 * 7 + 2 * 7 * h
    sf_a = 2 * 3 * h * h + 2 * 2 * 3 * h * att + 2 * 2 * 3 * att + 2 * 2 * 3 * h
    sf_p = 2 * 2 * h * h
    head = 2 * 3 * h * c
    fwd = sum(fp0) + na + sf_a + sf_p + head
    assert arith.hgnn_flops(nv, dims, "A", g, h, 1, att, c, train=False) == fwd
    bwd = fp0[0] + 2 * na + 2 * sf_a + 2 * head
    assert arith.hgnn_flops(nv, dims, "A", g, h, 1, att, c, train=True) == fwd + bwd
    assert math.isfinite(fwd)
