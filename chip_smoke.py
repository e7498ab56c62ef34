"""On-card smoke run of the PyTorch / CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Setup: the card's name and power limit, then every CUDA kernel built
   from ``src/repro_torch/csrc`` with nvcc (one process per source, all
   started together), with the build time.
2. Kernels: on the real packings of ACM PAP and of DBLP APTPA (in-degree
   up to 1,483, most rows empty) at scale 1.0 and D = 64, each NA kernel
   (K1 with unit and with random blocked weights, K2 with random logits)
   against its plain PyTorch version on the card (K2's ``m`` bitwise), two
   kernel runs compared bit for bit, and CUDA-event medians of the kernel,
   the plain version and one library yardstick (``index_add_`` for K1,
   ``scatter_reduce(amax)`` + ``index_add_`` for K2; the port never calls
   them), each beside the shape of the kernels' work list (CTAs, the most
   edges a CTA holds).
3. Model: the banded inference path — ``Session(ExecutorSpec(na_executor=
   "banded")).compile(make_dataset("ACM", seed=0, scale=1.0), ["APA",
   "PAP", "PSP"], cfg)`` at the full width of ``HGNNConfig`` (hidden 64,
   3 layers, SF attention 64) — serves three forwards each for rgcn, rgat
   and shgn with the launch counters set to 0 just before and read just
   after.  Logits must be finite, repeat bit for bit across forwards, match
   the same port run on the CPU (the plain versions, same seed) within
   1e-4, and K1 must launch 9 times per forward (K2 9 times per rgat or
   shgn forward).  One rgat and one rgcn forward are then profiled with
   ``torch.profiler``, with K1 + K2's device time.
4. SGB: ACM, IMDB and DBLP at scale 1.0 under the ``ctt`` planner.  The
   host join and the device composer (K3) must give bitwise-equal products
   and equal per-step costs, K3 must launch once per plan step, and on
   every step K3 must equal its plain version exactly and repeat bit for
   bit.  Per step: the pruning counters and CUDA-event medians of K3, the
   plain version and the library yardstick (``torch.matmul`` of the padded
   float32 operands, then ``> 0``; TF32 off), beside the bound.
5. Device-SGB session: the path ``Session(ExecutorSpec(sgb_backend=
   "device")).compile(DBLP at scale 1.0, ["APA", "APTPA", "APVPA"], cfg)``
   at full width, target type A, three forwards each of rgcn, rgat and
   shgn, counters set to 0 just before the compile and read after the last
   forward.  K3 must launch once per plan step, K1 and K2 9 times per
   forward; logits must be finite, repeat bit for bit and equal a host-SGB
   session's on the same card bit for bit.
6. LM kernels: K4 (flash attention) at smollm-135m's prefill shapes (B = 4,
   9 query and 3 KV heads, head dim 64, S = T = 2048 and 4096, bf16,
   causal) against its plain version within 3e-2 and against the plain
   version in float32 per element (4e-3 + 2^-6 |ref|) and per 128-row
   query tile (relative RMS error at most 1e-2, which a planted fault, one
   key tile dropped from the last rows, must exceed), and in float32 on the
   sweep's softcap, S < T, window and head-dim-128 cases within 2e-5; K5
   (SSD scan) at mamba2-370m's shapes (B = 4, S = 2048 and 4096, 32 heads
   of 64, one group, state 128, chunk 128, float32) within 3e-4.  Each
   kernel repeats bit for bit; CUDA-event medians of kernel, plain version
   and library yardstick (``scaled_dot_product_attention`` with
   ``enable_gqa``; none exists for SSD) beside the bound, and for K4 also
   the kernel's and the library call's time with the card's queue full
   (calls issued behind a device sleep), which leaves out the calls' host
   cost, and their host time to issue a call.  K4 once more at
   ``prefill_32k``'s sequence (B = 1, S = 32,768), against the library
   call and, on three blocks of 256 rows, the float32 plain version, and
   at head dim 128 with minitron-4b's head layout (B = 1, 24 query and
   8 KV heads, S = 4096), and at gemma2-2b's local layer (B = 1, 8 query
   and 4 KV heads of 256, S = 8192, causal, window 4096, softcap 50; the
   library call there is causal attention without window or softcap, a
   yardstick of time only).  The bf16 K4's registers, dynamic shared memory
   and local (spill) bytes are printed as the runtime reports them, at
   head dims 64, 128 and 256.  K5's plain version runs with TF32 off; a
   planted fault (the plain version of the second half of the sequence
   alone, which drops the state carried across the midpoint) must break
   K5's tolerance.
7. LM serving, a functional check and not a load: ``ServeEngine`` on
   full-width smollm-135m with ``launch/serve.py``'s defaults (6 requests,
   4 slots, prompt 6, 8 new tokens, max_len 64), twice: every request
   answered, tokens below the vocab, the same tokens both times.  Its tokens
   per second are printed as a smoke reading; at this size they are mostly
   per-call host overhead.
8. LM prefill: ``LM.forward(params, tokens, last_only=True)`` of
   full-width smollm-135m (30 layers), mamba2-370m (48 layers) and
   gemma2-2b (26 layers, head dim 256), weights from the port's init with
   seed 0, at B = 4, S = 2048, two forwards each with the counters set to
   0 just before and read just after: K4 must launch 30 times (smollm) and
   26 times (gemma2) and K5 48 times per forward, logits must be finite and
   repeat bit for bit; the launches a forward should make follow from the
   config's block pattern.  One forward of each is profiled, with K4's
   share of the device time and K5's, summed over its four passes and
   each pass's own.  Then the
   last-position logits of a B = 2, S = 256 prefill must match the card's
   own token-by-token decode of the same prompt (no kernel on that path)
   within 5e-2: on the first 2 layers for a stack with SSM mixers (see
   ``SSM_DECODE_GATE_LAYERS``; the full depth is printed), at full depth
   for an attention stack (gemma2-2b, whose bf16 logits reach 7.6, within
   its own ``DECODE_LOGIT_TOL``).  An attention stack's prefill also runs
   with the float32 plain attention in place of K4 (a control, printed;
   K4's prefill must be within the same tolerance of it), and with a
   planted fault (one key tile dropped from the second half's rows in
   its first K4 call), which must read above the tolerance against the
   control.
9. Report: one JSON line ``{"kernels": [...]}``, the card line, and last
   the contract line ``{"ok": true, "device": {...}}``.

Needs one CUDA card; exits non-zero without one, or without the repository
beside it.
"""
from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
D = 64
TARGETS = ["APA", "PAP", "PSP"]
MODELS = ("rgcn", "rgat", "shgn")
FORWARDS = 3
NA_PER_FORWARD = 9  # 3 semantic graphs x 3 layers
K1_TOL = 1e-4  # |d| <= tol + tol * |plain|: seg_sum fp32 in test_kernels.py
K2_RTOL = 1e-5  # s relative to max(1, |s|); m is a max, expected exact
LOGIT_ATOL = 1e-4  # reference suite's logits tolerance (test_gfp_banded.py)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
INT8_OP_PER_S = 1979e12  # H100 SXM int8 tensor cores, dense (exact for 0/1)
BF16_FLOP_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
TF32_FLOP_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense
K4_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}  # test_kernels.py:98
# K4 bf16 against its float32 plain version, per element and per 128-row
# query tile.  Sound: the bf16 rounding of P and of the output, about 2e-3
# of a tile's RMS; a dropped key tile at S = 32k moves the last rows by
# about sqrt(128 / S) = 6e-2 of it (PERF.md, section 6).
K4_BF16_ATOL, K4_BF16_RTOL = 4e-3, 2 ** -6
K4_TILE_RMS = 1e-2
K5_TOL = 3e-4  # test_kernels.py:125
LM_LOGIT_TOL = 5e-2  # decode-vs-forward tolerance, test_models_lm.py:80
LM_BATCH, LM_SEQ = 4, 2048  # the prefill phase's batch and sequence
DECODE_BATCH, DECODE_SEQ = 2, 256  # prefill-vs-decode check
# Depth of the gated prefill-vs-decode check for a stack with SSM mixers.
# In random-weight mamba2-370m at bf16 the two paths' rounding differences
# grow with depth, in the JAX reference as in the port: tests/test_torch_lm.py
# ::test_mamba2_prefill_decode_gap_at_depth_tracks_the_reference holds the
# port's gap to the reference's at 8 and 16 layers on the CPU.  Here the gate
# takes the first 2 layers, the depth of the reference suite's own
# decode-vs-forward test, and the full depth is measured and printed.
SSM_DECODE_GATE_LAYERS = 2
# Prefill-vs-decode tolerance of an attention stack at full depth, where it
# is not LM_LOGIT_TOL.  The logits are a bf16 product: at gemma2-2b's
# full-width magnitudes (up to 7.6, a bf16 step of 2^-5) the prefill with
# the float32 plain attention in place of K4 misses decode by three steps
# (0.0936, PERF.md section 6) as K4's does; its tolerance is four steps.
# A planted fault read in the same run must break each stack's tolerance.
DECODE_LOGIT_TOL = {"gemma2-2b": 4 * 2 ** -5}
K4_SHAPES = [(4, 9, 3, 2048, 64), (4, 9, 3, 4096, 64)]  # B, Hq, Hkv, S = T, Dh
K4_DH128 = (1, 24, 8, 4096, 128)  # minitron-4b's head layout
# gemma2-2b's local layer at twice its window: B, Hq, Hkv, S = T, Dh, window, softcap
K4_GEMMA_LOCAL = (1, 8, 4, 8192, 256, 4096, 50.0)
K4_PLAIN_LOGITS = 4 * 9 * 4096 * 4096  # the largest B * Hq * S * T run in full plain
K4_F32_CASES = [  # test_flash_attention_sweep's softcap, S < T, window, Dh 128
    (1, 8, 2, 100, 100, 64, True, None, 50.0),
    (1, 4, 4, 96, 224, 64, True, None, None),
    (2, 4, 2, 128, 128, 64, True, 64, None),
    (1, 2, 1, 64, 64, 128, False, None, None),
]
K5_SHAPES = [(4, 2048, 32, 1, 64, 128, 128), (4, 4096, 32, 1, 64, 128, 128)]  # B,S,H,G,P,N,L
K5_TF32_PRODUCTS = 3  # 3xTF32: each float32 product is three TF32 products
# the kernels one K5 call launches, in order (csrc/ssd_scan.cu)
K5_PASSES = ("ssd_chunk_state_kernel", "ssd_cb_kernel", "ssd_state_pass_kernel",
             "ssd_output_kernel")
LM_ARCHS = ("smollm-135m", "mamba2-370m", "gemma2-2b")  # phase 8's full-width models
PREFILL_32K = 32768
SGB_WORKLOADS = {  # dataset -> SGB targets, composed at scale 1.0
    "ACM": ["APA", "PAP", "PSP"],
    "IMDB": ["MAM", "AMA", "MKM"],
    "DBLP": ["APA", "APTPA", "APVPA"],
}


def require(cond: bool, msg: str) -> None:
    """Fail the run (non-zero exit) unless ``cond`` holds."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_events(prof):
    """``(device us, launches, name)`` of every device kernel a profile saw."""
    rows = []
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue  # CPU ops: their device time is their kernels', counted here
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    return rows


def device_ms(label: str, fn, reps: int = 20):
    """Device time in ms of every kernel one call of ``fn`` launches, the
    mean over ``reps`` warm calls (torch.profiler): the call's host cost
    left out.  Prints the launches the trace recorded beside the time.  A
    trace can miss a launch, so every kernel must show a multiple of
    ``reps``; else, as when it saw no device event, the time is not
    measured (None)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = _device_events(prof)
    counts = sorted({r[1] for r in rows})
    if not rows or any(c % reps for c in counts):
        print(f"device time {label}: not measured (launches a kernel recorded over "
              f"{reps} calls: {counts or 'none'})")
        return None
    ms = sum(r[0] for r in rows) / reps / 1e3
    print(f"device time {label}: {ms:.4f} ms a call; {len(rows)} kernel(s), launches "
          f"recorded over {reps} calls: {counts}")
    return ms


def queued_ms(fn, reps: int = 20) -> float:
    """ms a call of ``fn`` with the card's queue full: CUDA events around
    ``reps`` calls issued while the card sleeps (``torch.cuda._sleep``), so
    the calls run back to back and their host cost is hidden.  Unlike
    ``device_ms`` it needs no trace (which loses the last of a run of long
    kernels) and counts the gaps between launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # about 50 ms: longer than issuing the calls
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def host_us(fn, reps: int = 200) -> float:
    """Host time in us to issue one call of ``fn``, the mean over ``reps``
    calls issued back to back (host clock, no sync between them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def bound(nbytes: float, flops: float):
    """Least time in ms the card could take, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work_shape(pk) -> dict:
    """The row kernels' work list on one packing: CTAs, items, the most
    edges any CTA or item holds, and the skew it meets."""
    from repro_torch.kernels.seg_sum import ITEMS_PER_CTA

    rows = pk.row_edges()
    edges = (rows.items[:, 3] - rows.items[:, 2]).astype(np.int64)
    deg = np.diff(rows.row_ptr)
    return {"ctas": int(edges.size // ITEMS_PER_CTA), "items": int(edges.size),
            "max_cta_edges": int(edges.reshape(-1, ITEMS_PER_CTA).sum(1).max()),
            "max_item_edges": int(edges.max()), "max_in_degree": int(deg.max()),
            "empty_rows": int((deg == 0).sum())}


def na_kernels_on(pk, label: str, dev):
    """K1 and K2 on one packing at D = 64: agreement with the plain
    versions, bitwise repeat, CUDA-event medians of kernel, plain version
    and library yardstick, and the bound."""
    from repro_torch.kernels.edge_softmax import (NEG, edge_softmax_stats,
                                                  softmax_stats_plain)
    from repro_torch.kernels.seg_sum import seg_sum_na, seg_sum_plain

    nb, eb = pk.src_local.shape
    n_edges, tiles = pk.num_edges, pk.num_dst_tiles
    work = work_shape(pk)
    print(f"kernels: {label} packing, {n_edges} edges in {nb} blocks over "
          f"{tiles} dst tiles, D={D}; work list {work}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    h = torch.randn(pk.num_src, D, device=dev, generator=gen)
    w_rand = torch.rand(nb, eb, device=dev, generator=gen)
    logits = torch.randn(nb, eb, device=dev, generator=gen) * 3
    db = pk.device_blocked(dev)
    src_e, dst_e = db["edge_src"], db["edge_dst"]
    blk, slot = db["edge_blk"], db["edge_slot"]
    out = []

    # --- K1 --------------------------------------------------------------
    err = 0.0
    for wl, w in (("unit", None), ("random", w_rand)):
        a = seg_sum_na(pk, h, w)
        b = seg_sum_na(pk, h, w)
        ref = seg_sum_plain(pk, h, w)
        torch.cuda.synchronize()
        e = (a - ref).abs().max().item()
        excess = ((a - ref).abs() - K1_TOL * ref.abs()).max().item()
        print(f"K1 seg_sum {label} ({wl} weights): max|kernel - plain| = {e:.3e}, "
              f"max|plain| = {ref.abs().max().item():.3f} (tolerance {K1_TOL} "
              f"+ {K1_TOL} x |plain|); run-to-run bitwise equal: {torch.equal(a, b)}")
        require(excess <= K1_TOL, f"K1 {label} {wl} weights disagree with the plain version")
        require(torch.equal(a, b), f"K1 {label} {wl} weights not bitwise repeatable")
        err = max(err, e)
    w_e = w_rand[blk, slot]

    def k1_library():
        return torch.zeros(pk.num_dst, D, device=dev).index_add_(
            0, dst_e, h[src_e] * w_e[:, None])

    ref = seg_sum_plain(pk, h, w_rand)
    lib_excess = ((k1_library() - ref).abs() - K1_TOL * ref.abs()).max().item()
    require(lib_excess <= K1_TOL, "K1 library yardstick disagrees")
    k1_ms = median_ms(lambda: seg_sum_na(pk, h, w_rand))
    k1_plain = median_ms(lambda: seg_sum_plain(pk, h, w_rand), reps=10)
    k1_lib = median_ms(k1_library)
    k1_dev = device_ms(f"K1 {label}", lambda: seg_sum_na(pk, h, w_rand))
    k1_lib_dev = device_ms(f"K1 library {label}", k1_library)
    k1_host = host_us(lambda: seg_sum_na(pk, h, w_rand))
    meta = nb * 4 * 2 + nb * 4 + (tiles + 1) * 4  # band, count, tile list
    k1_bytes = n_edges * (2 + 2 + 4) + pk.num_src * D * 4 + pk.num_dst * D * 4 + meta
    k1_bound, k1_by = bound(k1_bytes, 2.0 * n_edges * D)
    out.append({
        "name": "seg_sum_na", "route": "cuda",
        "source": "src/repro_torch/csrc/na_kernels.cu",
        "replaces": "src/repro/kernels/seg_sum.py:516",
        "max_abs_err": err, "ms": k1_ms, "plain_ms": k1_plain,
        "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": k1_lib,
        "bytes": k1_bytes, "shape": f"{label} E={n_edges} nb={nb} tiles={tiles} D={D}",
        "work": work, "device_ms": k1_dev, "library_device_ms": k1_lib_dev,
        "host_us_per_call": k1_host,
    })

    # --- K2 --------------------------------------------------------------
    m1, s1 = edge_softmax_stats(pk, logits)
    m2, s2 = edge_softmax_stats(pk, logits)
    mr, sr = softmax_stats_plain(pk, logits)
    torch.cuda.synchronize()
    em = (m1 - mr).abs().max().item()
    es = (s1 - sr).abs().max().item()
    es_rel = ((s1 - sr).abs() / sr.abs().clamp(min=1.0)).max().item()
    same = torch.equal(m1, m2) and torch.equal(s1, s2)
    print(f"K2 edge_softmax_stats {label}: max|dm| = {em:.3e} (m bitwise equal: "
          f"{torch.equal(m1, mr)}), max|ds| = {es:.3e} (relative {es_rel:.3e}, "
          f"tolerance {K2_RTOL}); run-to-run bitwise equal: {same}")
    require(torch.equal(m1, mr) and es_rel <= K2_RTOL,
            f"K2 {label} disagrees with the plain version")
    require(same, f"K2 {label} not bitwise repeatable")
    l_e = logits[blk, slot]

    def k2_library():
        m = torch.full((pk.num_dst,), NEG, device=dev).scatter_reduce_(
            0, dst_e, l_e, "amax")
        s = torch.zeros(pk.num_dst, device=dev).index_add_(
            0, dst_e, torch.exp(l_e - m[dst_e]))
        return m, s

    _, sl = k2_library()
    require(((sl - sr).abs() / sr.abs().clamp(min=1.0)).max().item() <= K2_RTOL,
            "K2 library yardstick disagrees")
    k2_ms = median_ms(lambda: edge_softmax_stats(pk, logits))
    k2_plain = median_ms(lambda: softmax_stats_plain(pk, logits), reps=10)
    k2_lib = median_ms(k2_library)
    k2_dev = device_ms(f"K2 {label}", lambda: edge_softmax_stats(pk, logits))
    k2_lib_dev = device_ms(f"K2 library {label}", k2_library)
    k2_host = host_us(lambda: edge_softmax_stats(pk, logits))
    k2_bytes = n_edges * (2 + 4) + nb * 4 + nb * 4 + (tiles + 1) * 4 + pk.num_dst * 8
    k2_bound, k2_by = bound(k2_bytes, 6.0 * n_edges)
    out.append({
        "name": "edge_softmax_stats", "route": "cuda",
        "source": "src/repro_torch/csrc/na_kernels.cu",
        "replaces": "src/repro/kernels/edge_softmax.py:32",
        "max_abs_err": max(em, es), "ms": k2_ms, "plain_ms": k2_plain,
        "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": k2_lib,
        "bytes": k2_bytes, "shape": f"{label} E={n_edges} nb={nb} tiles={tiles}",
        "work": work, "device_ms": k2_dev, "library_device_ms": k2_lib_dev,
        "host_us_per_call": k2_host,
    })
    for k in out:
        print(f"{k['name']} {label}: kernel {k['ms']:.4f} ms (device {_ms(k['device_ms'])}, "
              f"host {k['host_us_per_call']:.1f} us a call), plain {k['plain_ms']:.4f} ms, "
              f"library {k['library_ms']:.4f} ms (device {_ms(k['library_device_ms'])}), "
              f"bound {k['bound_ms']:.6f} ms ({k['bound_by']}, {k['bytes']} bytes); "
              f"{work['ctas']} CTAs, at most {work['max_cta_edges']} edges a CTA")
    return out


def phase_kernels(graph, dblp, dev):
    """Phase 2: K1 and K2 against their plain versions on the card, on ACM
    PAP and on DBLP APTPA."""
    from repro_torch.pipeline import FrontendPipeline, PipelineConfig

    res = FrontendPipeline(PipelineConfig(pack=True)).run(graph, TARGETS)
    print("frontend (host, cold): " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in res.timings.items()))
    out = na_kernels_on(res.packed["PAP"], "ACM PAP", dev)
    res = FrontendPipeline(PipelineConfig(pack=True)).run(dblp, ["APTPA"])
    for k, other in zip(out, na_kernels_on(res.packed["APTPA"], "DBLP APTPA", dev)):
        k["max_abs_err"] = max(k["max_abs_err"], other["max_abs_err"])
        k["dblp_aptpa"] = {key: other[key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err",
            "bytes", "shape", "work", "device_ms", "library_device_ms",
            "host_us_per_call")}
    return out


def phase_model(graph):
    """Phase 3: the main path on the card, held against the CPU run."""
    from repro_torch.api import ExecutorSpec, Session, device_features
    from repro_torch.core.hgnn import HGNNConfig
    from repro_torch.kernels.edge_softmax import edge_softmax_stats
    from repro_torch.kernels.seg_sum import seg_sum_na

    sess = Session(ExecutorSpec(na_executor="banded"))
    cpu = Session(ExecutorSpec(na_executor="banded", device="cpu"), cache=sess.cache)
    feats = device_features(graph, "cuda")
    feats_cpu = device_features(graph, "cpu")
    cfgs = {m: HGNNConfig(model=m, hidden=64, num_layers=3, sf_att_dim=64,
                          target_type="P") for m in MODELS}
    compiled = {m: sess.compile(graph, TARGETS, cfgs[m]) for m in MODELS}
    params = {m: compiled[m].init(SEED) for m in MODELS}
    torch.cuda.synchronize()

    seg_sum_na.launches = 0
    edge_softmax_stats.launches = 0
    logits, latency = {}, {}
    for m in MODELS:
        outs, lat = [], []
        for _ in range(FORWARDS):
            k1, k2 = seg_sum_na.launches, edge_softmax_stats.launches
            t0 = time.perf_counter()
            outs.append(compiled[m].forward(params[m], feats))
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            d1 = seg_sum_na.launches - k1
            d2 = edge_softmax_stats.launches - k2
            want2 = 0 if m == "rgcn" else NA_PER_FORWARD
            require(d1 == NA_PER_FORWARD, f"{m}: K1 launched {d1} times in a forward")
            require(d2 == want2, f"{m}: K2 launched {d2} times in a forward")
        logits[m], latency[m] = outs, lat
    launches = {"seg_sum_na": seg_sum_na.launches,
                "edge_softmax_stats": edge_softmax_stats.launches}
    print(f"model: launches over {len(MODELS)} models x {FORWARDS} forwards: {launches}")

    for m in MODELS:
        first = logits[m][0]
        require(first.shape == (compiled[m].num_target, 3), f"{m}: logits shape {first.shape}")
        require(bool(torch.isfinite(first).all()), f"{m}: non-finite logits")
        require(all(torch.equal(first, o) for o in logits[m][1:]),
                f"{m}: logits differ between forwards")
        t0 = time.perf_counter()
        c_cpu = cpu.compile(graph, TARGETS, cfgs[m])
        ref = c_cpu.forward(c_cpu.init(SEED), feats_cpu)
        cpu_s = time.perf_counter() - t0
        err = (first.cpu() - ref).abs().max().item()
        print(f"model {m}: logits {tuple(first.shape)}, max|logit| "
              f"{first.abs().max().item():.4f}, max|cuda - cpu| = {err:.3e} "
              f"(tolerance {LOGIT_ATOL}); forward ms {['%.3f' % x for x in latency[m]]}; "
              f"cpu forward {cpu_s:.1f} s")
        require(err <= LOGIT_ATOL, f"{m}: card logits disagree with the CPU run")

    for m in ("rgat", "rgcn"):
        rows = prof_call(f"{m} forward", lambda: compiled[m].forward(params[m], feats))
        na_ms = sum(r[0] for r in rows if "_rows_kernel" in r[2]) / 1e3
        print(f"profile {m} forward: K1 + K2 device time {na_ms:.3f} ms")
    return launches


def prof_call(label: str, fn) -> list:
    """Device time by kernel name over one warm call of ``fn``
    (torch.profiler); returns ``[(device us, launches, name)]``, largest
    first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = _device_events(prof)
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    if not rows:
        print(f"profile {label}: device time not measured (no device events)")
        return rows
    print(f"profile {label}: wall {wall:.3f} ms, device busy {total / 1e3:.3f} ms "
          f"({100 * total / 1e3 / wall:.1f}% of wall), {sum(r[1] for r in rows)} "
          "kernel launches")
    for dev_us, count, key in rows[:10]:
        print(f"  {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")
    return rows


def kernel_name(key: str) -> str:
    """A device kernel's own name out of the profiler's demangled key
    (``void (anonymous namespace)::ssd_output_kernel<true>(...)``)."""
    m = re.search(r"(\w+)(<[^()]*>)?\(", key)
    return m.group(1) + (m.group(2) or "") if m else key[:60]


def _edges_equal(a, b) -> bool:
    return ((a.num_src, a.num_dst) == (b.num_src, b.num_dst)
            and np.array_equal(a.src, b.src) and np.array_equal(a.dst, b.dst))


def sgb_step(dev, step, left, right):
    """K3 on one plan step's operands: exactness, repeatability and times."""
    from repro_torch.kernels.spgemm_bsr import (TILE, pair_stats, spgemm_bsr,
                                                spgemm_plain, tile_occupancy)

    a, b = left.dense_padded(dev, TILE), right.dense_padded(dev, TILE)
    ao, bo = tile_occupancy(a), tile_occupancy(b)
    mt, kt, nt = a.shape[0] // TILE, a.shape[1] // TILE, b.shape[1] // TILE
    st = pair_stats(ao, bo, mt, kt, nt)
    out, occ = spgemm_bsr(a, b, ao, bo)
    again, occ2 = spgemm_bsr(a, b, ao, bo)
    plain, plain_occ = spgemm_plain(a, b, ao, bo)
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    lib = (torch.matmul(a32, b32) > 0).to(torch.uint8)
    torch.cuda.synchronize()
    err = (out.to(torch.int32) - plain.to(torch.int32)).abs().max().item()
    require(torch.equal(out, plain) and torch.equal(occ, plain_occ),
            f"K3 differs from its plain version on {step!r}")
    require(torch.equal(out, again) and torch.equal(occ, occ2),
            f"K3 not bitwise repeatable on {step!r}")
    require(torch.equal(lib, plain), f"library yardstick differs on {step!r}")
    reps = 5 if st["tile_pairs_live"] > 20000 else 20
    ms = median_ms(lambda: spgemm_bsr(a, b, ao, bo), reps=reps)
    plain_ms = median_ms(lambda: spgemm_plain(a, b, ao, bo), reps=reps)
    lib_ms = median_ms(lambda: torch.matmul(a32, b32) > 0, reps=reps)
    ops = 2.0 * st["macs_live"]
    nbytes = (int(ao.sum()) + int(bo.sum())) * TILE * TILE + out.numel() \
        + 4 * (ao.numel() + bo.numel() + occ.numel())
    t_ops, t_bytes = ops / INT8_OP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "step": repr(step), "shape": f"{tuple(a.shape)}x{tuple(b.shape)}",
        "pairs_live": st["tile_pairs_live"], "pairs_total": st["tile_pairs_total"],
        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "err": err,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "ops": ops, "bytes": nbytes,
        "fp32_cuda_core_ms": ops / FP32_FLOP_PER_S * 1e3,
    }


def phase_sgb(make_dataset, dev):
    """Phase 4: host against device SGB (K3) at scale 1.0, and K3 per step."""
    from repro_torch.core import sgb
    from repro_torch.kernels.spgemm_bsr import spgemm_bsr

    rows = {}
    for name, targets in SGB_WORKLOADS.items():
        graph = make_dataset(name, seed=SEED, scale=1.0)
        plan = sgb.make_plan(graph, targets, planner="ctt")
        host = sgb.execute_plan(graph, plan)
        spgemm_bsr.launches = 0
        t0 = time.perf_counter()
        device = sgb.execute_plan(graph, plan, backend="device", device=dev)
        dev_s = time.perf_counter() - t0
        require(spgemm_bsr.launches == len(plan.steps),
                f"{name}: K3 launched {spgemm_bsr.launches} times for "
                f"{len(plan.steps)} steps")
        require(device.cost == host.cost, f"{name}: SGB costs differ")
        require([c for _, c in device.per_step] == [c for _, c in host.per_step],
                f"{name}: per-step SGB costs differ")
        for mp in {st.out for st in plan.steps} | set(targets):
            require(_edges_equal(device.graphs[mp], host.graphs[mp]),
                    f"{name}: device and host SGB differ on {mp}")
        ds = device.device_stats
        print(f"sgb {name}: {len(plan.steps)} steps, products bitwise equal to "
              f"the host join, MACs {device.cost.macs}; device_stats {ds} "
              f"(pruned {1 - ds['tile_pairs_live'] / ds['tile_pairs_total']:.4f}); "
              f"host {host.wall_seconds * 1e3:.1f} ms, device {dev_s * 1e3:.1f} ms")
        rows[name] = []
        for st, cost in device.per_step:
            r = sgb_step(dev, st, host.graphs[st.left], host.graphs[st.right])
            r["edges_out"] = cost.bytes_written // 8
            rows[name].append(r)
            print(f"  {r['step']} {r['shape']}: live pairs {r['pairs_live']}/"
                  f"{r['pairs_total']} (pruned {1 - r['pairs_live'] / r['pairs_total']:.4f}), "
                  f"out edges {r['edges_out']}; K3 {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms; "
                  f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}; fp32 CUDA cores "
                  f"{r['fp32_cuda_core_ms']:.4f} ms); |K3 - plain| {r['err']}")
    return rows


def phase_device_session(make_dataset, dev):
    """Phase 5: the device-SGB session on full-width DBLP, held bitwise to
    a host-SGB session on the same card."""
    from repro_torch.api import ExecutorSpec, Session, device_features
    from repro_torch.core.hgnn import HGNNConfig
    from repro_torch.kernels.edge_softmax import edge_softmax_stats
    from repro_torch.kernels.seg_sum import seg_sum_na
    from repro_torch.kernels.spgemm_bsr import spgemm_bsr

    graph = make_dataset("DBLP", seed=SEED, scale=1.0)
    targets = SGB_WORKLOADS["DBLP"]
    feats = device_features(graph, dev)
    cfgs = {m: HGNNConfig(model=m, hidden=64, num_layers=3, sf_att_dim=64,
                          target_type="A") for m in MODELS}
    sess = Session(ExecutorSpec(sgb_backend="device", device=str(dev)))
    torch.cuda.synchronize()

    seg_sum_na.launches = edge_softmax_stats.launches = spgemm_bsr.launches = 0
    t0 = time.perf_counter()
    compiled = {m: sess.compile(graph, targets, cfgs[m]) for m in MODELS}
    compile_s = time.perf_counter() - t0
    params = {m: compiled[m].init(SEED) for m in MODELS}
    logits, latency = {}, {}
    for m in MODELS:
        outs, lat = [], []
        for _ in range(FORWARDS):
            t0 = time.perf_counter()
            outs.append(compiled[m].forward(params[m], feats))
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        logits[m], latency[m] = outs, lat
    launches = {"spgemm_bsr": spgemm_bsr.launches, "seg_sum_na": seg_sum_na.launches,
                "edge_softmax_stats": edge_softmax_stats.launches}
    res = compiled["rgcn"].frontend
    steps = len(res.sgb.per_step)
    print(f"device session DBLP: launches over compile + {len(MODELS)} models x "
          f"{FORWARDS} forwards: {launches}; compile {compile_s * 1e3:.1f} ms; "
          "cold frontend " + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in res.timings.items())
          + "; semantic graph edges "
          + str({mp: rel.num_edges for mp, rel in res.semantic.items()}))
    require(res.sgb.backend == "device", "the device session ran host SGB")
    require(launches["spgemm_bsr"] == steps, f"K3 launched {launches['spgemm_bsr']} "
            f"times for {steps} plan steps")
    require(launches["seg_sum_na"] == NA_PER_FORWARD * FORWARDS * len(MODELS),
            f"K1 launched {launches['seg_sum_na']} times")
    require(launches["edge_softmax_stats"] == NA_PER_FORWARD * FORWARDS * 2,
            f"K2 launched {launches['edge_softmax_stats']} times")

    host = Session(ExecutorSpec(device=str(dev)))
    for m in MODELS:
        first = logits[m][0]
        require(first.shape == (graph.num_vertices["A"], 3), f"{m}: logits shape {first.shape}")
        require(bool(torch.isfinite(first).all()), f"{m}: non-finite logits")
        require(all(torch.equal(first, o) for o in logits[m][1:]),
                f"{m}: logits differ between forwards")
        c_host = host.compile(graph, targets, cfgs[m])
        same = torch.equal(first, c_host.forward(c_host.init(SEED), feats))
        print(f"device session {m}: logits {tuple(first.shape)}, max|logit| "
              f"{first.abs().max().item():.4f}, bitwise equal to the host-SGB "
              f"session: {same}; forward ms {['%.3f' % x for x in latency[m]]}")
        require(same, f"{m}: device-SGB logits differ from the host-SGB session's")
    hres = host.frontend(graph, targets)
    print("host session DBLP: cold frontend " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in hres.timings.items()))
    return launches


def _randn(gen, shape, dev, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def k4_blocks(s: int) -> list:
    """Query-row blocks ``(first row, rows)`` of a causal S = T shape that
    K4 is held to its float32 plain version on: all rows up to S = 4096,
    else 256 rows at the start, the middle and the end (each block's keys
    end at its last row, so the plain version of a block is exact)."""
    if s <= 4096:
        return [(0, s)]
    return [(0, 256), (s // 2 - 128, 256), (s - 256, 256)]


def tile_rms(out, ref) -> torch.Tensor:
    """Per (batch, head, 128-row query tile): ||out - ref|| / ||ref||."""
    import torch.nn.functional as F

    b, h, s, dh = ref.shape
    n = -(-s // 128)

    def per_tile(x):
        return F.pad(x, (0, 0, 0, n * 128 - s)).reshape(b, h, n, -1).sum(-1)
    return (per_tile((out.float() - ref).square()) / per_tile(ref.square())).sqrt()


def plain_rows(q, k, v, first, window=None, softcap=None, drop=None):
    """float32 plain attention of the query rows ``q`` (key positions
    ``first`` on; S = T, causal) over all of ``k`` and ``v``, with the key
    range ``drop`` masked out where given: the output of a kernel that
    skipped that key tile."""
    from repro_torch.kernels.flash_attention import NEG

    rows, dh, t = q.shape[2], q.shape[3], k.shape[2]
    g = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    logits = (q.float() @ kf.transpose(-1, -2)) * dh ** -0.5
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(first, first + rows, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    live = kpos <= qpos
    if window is not None:
        live &= kpos > qpos - window
    if drop is not None:
        live[:, drop] = False
    p = torch.softmax(logits.masked_fill(~live, NEG), dim=-1)
    return p @ v.float().repeat_interleave(g, dim=1)


def k4_gate_f32(q, k, v, out, lib, window=None, softcap=None):
    """K4's bf16 causal output ``out`` on ``k4_blocks`` against the float32
    plain version: the largest ``|out - ref| / (K4_BF16_ATOL + K4_BF16_RTOL
    |ref|)`` (at most 1) and the largest per-tile relative RMS error (at
    most K4_TILE_RMS); the library output's tile reading (None where it
    computes another function); and the tile reading of a planted fault:
    the last 256 rows with one interior key tile (of the kernel's tile
    width at this head dim) dropped from the keys every one of them sees,
    the fault the kernel's tile plan could make, which the gate must
    reject."""
    from repro_torch.kernels.flash_attention import attention_plain, kernel_info

    s, dh = q.shape[2], q.shape[3]
    kw = dict(causal=True, window=window, softcap=softcap)
    elem = rms = lib_rms = 0.0
    for a, r in k4_blocks(s):
        ref = attention_plain(q[:, :, a:a + r].float(), k[:, :, :a + r].float(),
                              v[:, :, :a + r].float(), **kw)
        got = out[:, :, a:a + r].float()
        elem = max(elem, ((got - ref).abs() / (K4_BF16_ATOL + K4_BF16_RTOL * ref.abs()))
                   .max().item())
        rms = max(rms, tile_rms(got, ref).max().item())
        if lib is not None:
            lib_rms = max(lib_rms, tile_rms(lib[:, :, a:a + r], ref).max().item())
    bk = kernel_info(dh)["block_k"]  # keys per tile of the loaded kernel
    first = s - 256
    lo = max(0, s - window) if window is not None else 0  # every last row sees keys lo..first
    d0 = (lo + first) // 2 // bk * bk  # a tile in the middle of them
    qb = q[:, :, first:]
    fault = plain_rows(qb, k, v, first, window, softcap, drop=slice(d0, d0 + bk))
    fault_rms = tile_rms(fault, plain_rows(qb, k, v, first, window, softcap)).max().item()
    return elem, rms, (lib_rms if lib is not None else None), fault_rms


def k4_shape(dev, gen, b, hq, hkv, s, dh, window=None, softcap=None):
    """K4 at one bf16 causal prefill shape (S = T): agreement with the plain
    version and the library call, repeatability, times and bound.  With a
    window or softcap the library call (which takes neither) is causal
    attention at the same shape, a yardstick of time that is not compared."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_plain, flash_attention

    kw = dict(causal=True, window=window, softcap=softcap)
    same_fn = window is None and softcap is None
    q = _randn(gen, (b, hq, s, dh), dev, torch.bfloat16)
    k = _randn(gen, (b, hkv, s, dh), dev, torch.bfloat16)
    v = _randn(gen, (b, hkv, s, dh), dev, torch.bfloat16)
    out = flash_attention(q, k, v, **kw)
    again = flash_attention(q, k, v, **kw)
    lib = F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    plain = attention_plain(q, k, v, **kw) if b * hq * s * s <= K4_PLAIN_LOGITS else None
    torch.cuda.synchronize()
    ref = plain if plain is not None else lib
    err = (out.float() - ref.float()).abs().max().item()
    lib_err = ((lib.float() - ref.float()).abs().max().item()
               if plain is not None and same_fn else 0.0)
    tol = K4_TOL[torch.bfloat16]
    label = f"S={s} Dh={dh}" + ("" if same_fn else f" window={window} softcap={softcap}")
    require(err <= tol, f"K4 disagrees with its {'plain version' if plain is not None else 'library yardstick'} "
            f"at B={b} {label}: {err}")
    require(lib_err <= tol, f"K4 library yardstick disagrees at {label}: {lib_err}")
    require(torch.equal(out, again), f"K4 not bitwise repeatable at {label}")
    elem, rms, lib_rms, fault_rms = k4_gate_f32(q, k, v, out, lib if same_fn else None,
                                                window, softcap)
    print(f"K4 {label} against the float32 plain version on rows {k4_blocks(s)}: "
          f"max|d| / ({K4_BF16_ATOL} + {K4_BF16_RTOL}|ref|) = {elem:.3f} (at most 1); "
          f"largest 128-row tile ||d|| / ||ref|| = {rms:.3e} (library "
          f"{'not the same function' if lib_rms is None else f'{lib_rms:.3e}'}; "
          f"at most {K4_TILE_RMS}); planted fault (one key tile dropped from the last "
          f"256 rows) reads {fault_rms:.3e}, {fault_rms / K4_TILE_RMS:.1f}x the limit")
    require(elem <= 1.0, f"K4 disagrees with its float32 plain version at {label}: {elem}")
    require(rms <= K4_TILE_RMS, f"K4 tile error {rms} over {K4_TILE_RMS} at {label}")
    require(fault_rms > K4_TILE_RMS, f"K4 gate would pass a dropped key tile at {label}")
    reps = 30 if s <= 4096 else 5
    ms = median_ms(lambda: flash_attention(q, k, v, **kw), reps=reps)
    lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), reps=reps)
    plain_ms = (median_ms(lambda: attention_plain(q, k, v, **kw), reps=5)
                if plain is not None else None)
    q_ms = queued_ms(lambda: flash_attention(q, k, v, **kw), reps=reps)
    lib_q_ms = queued_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), reps=reps)
    host = host_us(lambda: flash_attention(q, k, v, **kw), reps=4 * reps)
    lib_host = host_us(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), reps=4 * reps)
    w = window or s  # live (q, k) pairs: row i sees min(i + 1, w) keys
    live_pairs = w * (w + 1) // 2 + (s - w) * w
    flops = 4.0 * dh * live_pairs * hq * b
    nbytes = 2 * (2 * b * hq * s * dh + 2 * b * hkv * s * dh)  # q, o, k, v in bf16
    t_ops, t_bytes = flops / BF16_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    row = {"shape": f"B={b} Hq={hq} Hkv={hkv} S=T={s} Dh={dh} bf16 causal"
                    + ("" if same_fn else f" window={window} softcap={softcap}"),
           "max_abs_err": err, "against": "plain" if ref is not lib else "library",
           "f32_elem_ratio": elem, "f32_tile_rms": rms, "fault_tile_rms": fault_rms,
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "library_fn": ("scaled_dot_product_attention, causal, enable_gqa" if same_fn else
                          "scaled_dot_product_attention, causal, enable_gqa, no window or "
                          "softcap: not the same function, timed as a yardstick"),
           "queued_ms": q_ms, "library_queued_ms": lib_q_ms,
           "host_us_per_call": host, "library_host_us_per_call": lib_host,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes,
           "fp32_cuda_core_ms": flops / FP32_FLOP_PER_S * 1e3}
    print(f"K4 {row['shape']}: max|kernel - {row['against']}| = {err:.3e} (tolerance "
          f"{tol}), |library - plain| = {lib_err:.3e}; run-to-run bitwise equal; "
          f"kernel {ms:.4f} ms, plain {plain_ms if plain_ms is None else round(plain_ms, 4)} ms, "
          f"library {lib_ms:.4f} ms{'' if same_fn else ' (causal only)'}, bound "
          f"{row['bound_ms']:.5f} ms ({row['bound_by']}; "
          f"fp32 CUDA cores {row['fp32_cuda_core_ms']:.4f} ms); queue full kernel "
          f"{q_ms:.4f} ms, library {lib_q_ms:.4f} ms; host issue "
          f"kernel {host:.1f} us, library {lib_host:.1f} us a call")
    return row


def k5_shape(dev, gen, b, s, h, g, p, n, chunk):
    """K5 at one mamba2 prefill shape: agreement, repeatability, a planted
    fault, times of the kernel and of the plain version, each pass's device
    time, and the bound."""
    from repro_torch.kernels.ssd_scan import ssd_plain, ssd_scan

    x = _randn(gen, (b, s, h, p), dev)
    a = -_randn(gen, (b, s, h), dev).abs() * 0.1
    bc = _randn(gen, (b, s, g, n), dev, scale=0.3)
    cc = _randn(gen, (b, s, g, n), dev, scale=0.3)
    y = ssd_scan(x, a, bc, cc, chunk=chunk)
    again = ssd_scan(x, a, bc, cc, chunk=chunk)
    torch.backends.cuda.matmul.allow_tf32 = False  # the yardstick in full float32
    print(f"K5 plain version: torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    plain = ssd_plain(x, a, bc, cc, chunk=chunk)
    # planted fault: the second half alone, without the state carried into it
    half = s // 2
    fault = ssd_plain(x[:, half:], a[:, half:], bc[:, half:], cc[:, half:], chunk=chunk)
    torch.cuda.synchronize()
    err = (y - plain).abs().max().item()
    fault_err = (fault - plain[:, half:]).abs().max().item()
    print(f"K5 S={s}: planted fault (no state across the midpoint) reads "
          f"{fault_err:.3e}, {fault_err / K5_TOL:.1f}x the tolerance {K5_TOL}; the kernel "
          f"reads {err:.3e}, {K5_TOL / max(err, 1e-30):.1f}x below it")
    require(err <= K5_TOL, f"K5 disagrees with its plain version at S={s}: {err}")
    require(torch.equal(y, again), f"K5 not bitwise repeatable at S={s}")
    require(fault_err > K5_TOL, f"K5 gate would pass a dropped state at S={s}")
    ms = median_ms(lambda: ssd_scan(x, a, bc, cc, chunk=chunk))
    plain_ms = median_ms(lambda: ssd_plain(x, a, bc, cc, chunk=chunk), reps=5)
    traced = {kernel_name(r[2]): r[0] / 1e3
              for r in prof_call(f"K5 S={s}", lambda: ssd_scan(x, a, bc, cc, chunk=chunk))}
    passes = {name: traced.get(name) for name in K5_PASSES}  # None: lost by the trace
    nc = s // chunk
    live = chunk * (chunk + 1) // 2  # s <= t pairs of a chunk
    # C B^T counted once per group; the rest per head
    flops = (b * h * nc * (2.0 * live * p + 4.0 * chunk * p * n)
             + b * g * nc * 2.0 * live * n)
    nbytes = 4 * (2 * b * s * h * p + b * s * h + 2 * b * s * g * n)
    t_ops = K5_TF32_PRODUCTS * flops / TF32_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"shape": f"B={b} S={s} H={h} G={g} P={p} N={n} chunk={chunk} f32",
           "max_abs_err": err, "max_abs_plain": plain.abs().max().item(),
           "fault_err": fault_err,
           "ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "pass_device_ms": passes,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes,
           "fp32_cuda_core_ms": flops / FP32_FLOP_PER_S * 1e3}
    print(f"K5 {row['shape']}: max|kernel - plain| = {err:.3e} (tolerance {K5_TOL}, "
          f"max|plain| {row['max_abs_plain']:.3f}); run-to-run bitwise equal; kernel "
          f"{ms:.4f} ms (3xTF32 tensor cores; device time a pass: "
          f"{', '.join(f'{k} {_ms(v)}' for k, v in passes.items())}), plain "
          f"{plain_ms:.4f} ms, library none (no single call), bound "
          f"{row['bound_ms']:.5f} ms ({row['bound_by']}; {flops / 1e9:.2f} GFLOP as "
          f"{K5_TF32_PRODUCTS} TF32 products at {TF32_FLOP_PER_S / 1e12:.0f} TFLOP/s "
          f"{t_ops:.5f} ms, bytes {t_bytes:.5f} ms; float32 CUDA cores "
          f"{row['fp32_cuda_core_ms']:.4f} ms)")
    return row


def phase_lm_kernels(dev):
    """Phase 6: K4 and K5 against their plain versions at the LM shapes."""
    from repro_torch.kernels.flash_attention import (attention_plain, flash_attention,
                                                     kernel_info)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    k4_rows = [k4_shape(dev, gen, *shape) for shape in K4_SHAPES]
    f32_err = 0.0
    for b, hq, hkv, s, t, dh, causal, window, cap in K4_F32_CASES:
        q = _randn(gen, (b, hq, s, dh), dev)
        k = _randn(gen, (b, hkv, t, dh), dev)
        v = _randn(gen, (b, hkv, t, dh), dev)
        kw = dict(causal=causal, window=window, softcap=cap)
        out, again = flash_attention(q, k, v, **kw), flash_attention(q, k, v, **kw)
        err = (out - attention_plain(q, k, v, **kw)).abs().max().item()
        print(f"K4 f32 B={b} Hq={hq} Hkv={hkv} S={s} T={t} Dh={dh} {kw}: "
              f"max|kernel - plain| = {err:.3e} (tolerance {K4_TOL[torch.float32]})")
        require(err <= K4_TOL[torch.float32], f"K4 f32 case {kw} S={s} T={t} disagrees")
        require(torch.equal(out, again), "K4 f32 not bitwise repeatable")
        f32_err = max(f32_err, err)
    k4_rows.append(k4_shape(dev, gen, 1, 9, 3, PREFILL_32K, 64))
    k4_rows.append(k4_shape(dev, gen, *K4_DH128))
    b, hq, hkv, s, dh, window, cap = K4_GEMMA_LOCAL
    k4_rows.append(k4_shape(dev, gen, b, hq, hkv, s, dh, window=window, softcap=cap))
    for dh in (64, 128, 256):
        info = kernel_info(dh)
        print(f"K4 bf16 kernel, head dim {dh}: {info['registers']} registers a thread, "
              f"{info['shared_bytes']} bytes of dynamic shared memory, "
              f"{info['local_bytes']} bytes of local memory a thread, "
              f"{info['threads']} threads a CTA")
    k5_rows = [k5_shape(dev, gen, *shape) for shape in K5_SHAPES]
    return k4_rows, f32_err, k5_rows


def launches_per_forward(cfg) -> dict:
    """K4 and K5 launches one cache-less forward makes: one per attention
    (``attn`` / ``local``) or ``ssm`` mixer of the block pattern, per group."""
    def count(kinds):
        return cfg.num_groups * sum(mixer in kinds for mixer, _ in cfg.block_pattern)
    return {"flash_attention": count(("attn", "local")), "ssd_scan": count(("ssm",))}


def _lm(arch, dev):
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    model = LM(get_config(arch), device=dev)
    return model, model.init(SEED)


def phase_lm_serving(dev, model, params):
    """Phase 7: the continuous-batching engine on full-width smollm-135m."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.serve import serve

    vocab = model.cfg.vocab_size
    runs = []
    for _ in range(2):
        flash_attention.launches = ssd_scan.launches = 0
        done, secs, _ = serve(model.cfg.name, device=str(dev), params=params)
        toks = sum(len(v) for v in done.values())
        runs.append(done)
        print(f"serve {model.cfg.name}: {len(done)} requests, {toks} tokens in "
              f"{secs * 1e3:.1f} ms ({toks / secs:.1f} tok/s, a smoke reading, not a "
              "load); K4 launches "
              f"{flash_attention.launches}, K5 launches {ssd_scan.launches} "
              "(the engine decodes token by token: no kernel)")
    done = runs[0]
    require(sorted(done) == list(range(6)), f"served {sorted(done)} of 6 requests")
    require(all(len(v) == 8 for v in done.values()), "a request got fewer than 8 tokens")
    require(all(0 <= t < vocab for v in done.values() for t in v), "token beyond the vocab")
    require(runs[0] == runs[1], "two serving runs gave different tokens")
    print(f"serve tokens: {done}")


def cut_depth(model, params, layers: int):
    """The model cut to its first ``layers`` layers, rounded up to whole
    block-pattern groups, on the full model's weights (views of the stacked
    groups)."""
    from repro_torch.models import LM

    groups = -(-layers // len(model.cfg.block_pattern))

    def cut(tree):
        return {k: cut(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[:groups]

    cfg = dataclasses.replace(model.cfg, num_layers=groups * len(model.cfg.block_pattern))
    return LM(cfg, device=model.device), dict(params, blocks=[cut(b) for b in params["blocks"]])


def prefill_vs_decode(model, params, prompt, label: str):
    """max |last-position logits of the prefill - of the token-by-token
    decode| over the real vocab, and the prefill's and the decode's last
    logits; checks that decoding launches no kernel."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan

    cfg = model.cfg
    b, s = prompt.shape
    pre = model.forward(params, prompt, last_only=True)[0][:, 0]
    cache = model.init_cache(b, s)
    flash_attention.launches = ssd_scan.launches = 0
    t0 = time.perf_counter()
    for i in range(s):
        step, cache, _ = model.forward(params, prompt[:, i:i + 1], cache=cache, cache_pos=i)
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) * 1e3 / s
    v = cfg.vocab_size
    err = (step[:, 0, :v] - pre[:, :v]).abs().max().item()
    print(f"prefill vs decode {cfg.name} ({label}, {cfg.num_layers} layers): B={b} S={s}, "
          f"max|decode - prefill| of the last logits = {err:.4e} (tolerance "
          f"{LM_LOGIT_TOL}), max|logit| {pre[:, :v].abs().max().item():.4f}; decode "
          f"{dec_ms:.3f} ms per token step (a smoke reading); kernel launches while "
          f"decoding: K4 {flash_attention.launches}, K5 {ssd_scan.launches}")
    require(flash_attention.launches == 0 and ssd_scan.launches == 0,
            "the decode path launched a prefill kernel")
    if label == "full depth":  # rewrites the last position with the same token
        prof_call(f"{cfg.name} decode step B={b}", lambda: model.forward(
            params, prompt[:, -1:], cache=cache, cache_pos=s - 1))
    return err, pre, step[:, 0]


def prefill_with(model, params, prompt, attention):
    """Last-position logits of a prefill whose attention calls
    ``attention`` in place of K4."""
    from repro_torch.kernels import ops

    kernel = ops.flash_attention
    ops.flash_attention = attention
    try:
        return model.forward(params, prompt, last_only=True)[0][:, 0]
    finally:
        ops.flash_attention = kernel


def dropped_tile_attention():
    """K4 with a planted fault in its first call: the rows of the second
    half lose one key tile (of the kernel's width) from the middle of the
    first half, the fault a wrong tile plan would make."""
    from repro_torch.kernels.flash_attention import flash_attention, kernel_info

    calls = []

    def attention(q, k, v, causal=True, window=None, softcap=None):
        out = flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
        if not calls:
            s = q.shape[2]
            bk = kernel_info(q.shape[3])["block_k"]
            first = s // 2
            d0 = first // 2 // bk * bk
            out = out.clone()
            out[:, :, first:] = plain_rows(q[:, :, first:], k, v, first, window, softcap,
                                           drop=slice(d0, d0 + bk)).to(out.dtype)
        calls.append(q.shape)
        return out

    return attention


def phase_lm_prefill(dev, models):
    """Phase 8: full-width prefill through K4 / K5, and prefill vs decode."""
    from repro_torch.kernels.flash_attention import attention_plain, flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan

    gen = torch.Generator(device=dev).manual_seed(SEED)
    launches = {}
    for arch, (model, params) in models.items():
        cfg = model.cfg
        tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ), generator=gen,
                               device=dev)
        torch.cuda.synchronize()
        flash_attention.launches = ssd_scan.launches = 0
        outs, lat = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            outs.append(model.forward(params, tokens, last_only=True)[0])
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        counts = {"flash_attention": flash_attention.launches,
                  "ssd_scan": ssd_scan.launches}
        launches[arch] = counts
        per = launches_per_forward(cfg)
        print(f"prefill {arch}: B={LM_BATCH} S={LM_SEQ}, launches over 2 forwards "
              f"{counts}; forward ms {['%.3f' % x for x in lat]} "
              f"({LM_BATCH * LM_SEQ / (min(lat) / 1e3):.0f} tokens/s); logits "
              f"{tuple(outs[0].shape)}, max|logit| "
              f"{outs[0][..., :cfg.vocab_size].abs().max().item():.4f}")
        for name, n in per.items():
            require(counts[name] == 2 * n, f"{arch}: {name} launched {counts[name]} "
                    f"times in 2 forwards, want {2 * n}")
        require(bool(torch.isfinite(outs[0][..., :cfg.vocab_size]).all()),
                f"{arch}: non-finite logits")
        require(torch.equal(outs[0], outs[1]), f"{arch}: logits differ between forwards")
        rows = prof_call(f"{arch} prefill B={LM_BATCH} S={LM_SEQ}",
                         lambda: model.forward(params, tokens, last_only=True))
        busy = sum(r[0] for r in rows)
        for label, key in (("K4", "fa_forward"), ("K5", "ssd_")):  # K5: its four passes
            mine = [r for r in rows if key in r[2]]
            us = sum(r[0] for r in mine)
            if us and busy:
                print(f"profile {arch} prefill: {label} {us / 1e3:.3f} ms, "
                      f"{100 * us / busy:.1f}% of the device time, over "
                      f"{sum(r[1] for r in mine)} launches")
                if label == "K5":
                    traced = {kernel_name(r[2]): r for r in mine}
                    for name in K5_PASSES:
                        r = traced.get(name)
                        print(f"  K5 {name}: " + ("not measured (not in the trace)"
                              if r is None else f"{r[0] / 1e3:.3f} ms x{r[1]}, "
                              f"{100 * r[0] / busy:.1f}% of the device time"))

    for arch, (model, params) in models.items():
        cfg = model.cfg
        prompt = torch.randint(0, cfg.vocab_size, (DECODE_BATCH, DECODE_SEQ),
                               generator=gen, device=dev)
        err, pre, dec = prefill_vs_decode(model, params, prompt, "full depth")
        if any(mixer == "ssm" for mixer, _ in cfg.block_pattern):
            err, _, _ = prefill_vs_decode(*cut_depth(model, params, SSM_DECODE_GATE_LAYERS),
                                          prompt, "gated cut")
            require(err <= LM_LOGIT_TOL, f"{arch}: prefill and decode logits differ by {err}")
            continue
        v = cfg.vocab_size
        tol = DECODE_LOGIT_TOL.get(arch, LM_LOGIT_TOL)
        control = prefill_with(model, params, prompt, attention_plain)[:, :v]
        fault = prefill_with(model, params, prompt, dropped_tile_attention())[:, :v]
        plain_err = (dec[:, :v] - control).abs().max().item()
        k4_err = (pre[:, :v] - control).abs().max().item()
        fault_err = (fault - control).abs().max().item()
        print(f"prefill vs decode {arch} (full depth, tolerance {tol}; control: prefill "
              f"attention by the float32 plain version in place of K4, max|logit| "
              f"{control.abs().max().item():.4f}): max|decode - control| = "
              f"{plain_err:.4e}; max|K4 prefill - control| = {k4_err:.4e}; planted "
              f"fault (one key tile dropped in the first K4 call) max|fault - control| = "
              f"{fault_err:.4e}, {fault_err / tol:.1f}x the tolerance, the K4 readings "
              f"{tol / max(err, k4_err):.2f}x below it")
        require(err <= tol, f"{arch}: prefill and decode logits differ by {err}")
        require(k4_err <= tol,
                f"{arch}: K4's prefill and the plain attention's differ by {k4_err}")
        require(fault_err > tol, f"{arch}: the decode gate would pass a dropped key tile")
    return launches


def main() -> int:
    """Run every phase; the last line of stdout is the contract line."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.hetero import make_dataset
    from repro_torch.kernels import cuda_build

    card = card_line()
    print(f"setup: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, numpy {np.__version__}, card {card}")
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    print(f"setup: built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for stem, info in built.items():
        for line in str(info["log"]).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {stem}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # PyTorch's CPU build can get the first vectorized float op of a fresh
    # process wrong (seen with exp, about one process in 30); a throwaway
    # call keeps the CPU reference run below exact
    torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))
    dev = torch.device("cuda")

    graph = make_dataset("ACM", seed=SEED, scale=1.0)
    kernels = phase_kernels(graph, make_dataset("DBLP", seed=SEED, scale=1.0), dev)
    launches = phase_model(graph)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        require(k["launches"] > 0, f"{k['name']} never launched on the banded path")
    sgb_rows = phase_sgb(make_dataset, dev)
    session_launches = phase_device_session(make_dataset, dev)
    for k in kernels:
        k["launches_device_sgb_path"] = session_launches[k["name"]]
    dblp = sgb_rows["DBLP"]  # the plan the device-SGB session runs
    t_ops = sum(r["ops"] for r in dblp) / INT8_OP_PER_S * 1e3
    t_bytes = sum(r["bytes"] for r in dblp) / HBM_BYTES_PER_S * 1e3
    kernels.append({
        "name": "spgemm_bsr", "route": "cuda",
        "source": "src/repro_torch/csrc/spgemm_kernels.cu",
        "replaces": "src/repro/kernels/spgemm_bsr.py:28",
        "launches": session_launches["spgemm_bsr"],
        "max_abs_err": max(r["err"] for rows in sgb_rows.values() for r in rows),
        "ms": sum(r["ms"] for r in dblp), "plain_ms": sum(r["plain_ms"] for r in dblp),
        "bound_ms": sum(r["bound_ms"] for r in dblp),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": sum(r["library_ms"] for r in dblp),
        "bytes": sum(r["bytes"] for r in dblp),
        "shape": f"DBLP scale 1.0 ctt plan, {len(dblp)} steps (times summed)",
    })
    require(kernels[-1]["launches"] > 0, "spgemm_bsr never launched on the device-SGB path")

    k4_rows, k4_f32_err, k5_rows = phase_lm_kernels(dev)
    models = {arch: _lm(arch, dev) for arch in LM_ARCHS}
    phase_lm_serving(dev, *models["smollm-135m"])
    lm_launches = phase_lm_prefill(dev, models)
    for name, rows, src, line in (
            ("flash_attention", k4_rows, "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:30"),
            ("ssd_scan", k5_rows, "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:29")):
        top = rows[1]  # B = 4, S = 4096
        err = max(r["max_abs_err"] for r in rows)
        if name == "flash_attention":
            err = max(err, k4_f32_err)
        by_model = {arch: counts[name] for arch, counts in lm_launches.items() if counts[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
            "replaces": line, "launches": sum(by_model.values()),
            "launches_by_model": by_model,
            "max_abs_err": err, "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "bytes": top["bytes"],
            "shape": top["shape"], "shapes": rows,
        })
        require(kernels[-1]["launches"] > 0, f"{name} never launched on an LM prefill")
    for k in kernels:
        k["kernel_ms"] = k["ms"]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
