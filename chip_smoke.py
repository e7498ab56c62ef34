"""On-card smoke run of the PyTorch / CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Setup: the card's name and power limit, then every CUDA kernel built
   from ``src/repro_torch/csrc`` with nvcc (one process per source, all
   started together), with the build time.
2. Kernels: on the real ACM packing of semantic graph PAP at scale 1.0 and
   D = 64, each kernel (K1 with unit and with random blocked weights, K2
   with random logits) against its plain PyTorch version on the card, two
   kernel runs compared bit for bit, and CUDA-event medians of the kernel,
   the plain version and one library yardstick (``index_add_`` for K1,
   ``scatter_reduce(amax)`` + ``index_add_`` for K2; the port never calls
   them).
3. Model: the port's main path — ``Session(ExecutorSpec(na_executor=
   "banded")).compile(make_dataset("ACM", 1.0), ["APA", "PAP", "PSP"], cfg)``
   at the full width of ``HGNNConfig`` (hidden 64, 3 layers, SF attention
   64) — serves three forwards each for rgcn, rgat and shgn with the launch
   counters set to 0 just before and read just after.  Logits must be
   finite, repeat bit for bit across forwards, match the same port run on
   the CPU (the plain versions, same seed) within 1e-4, and K1 must launch
   9 times per forward (K2 9 times per rgat or shgn forward).  One rgat
   forward is then profiled with ``torch.profiler``.
4. Report: one JSON line ``{"kernels": [...]}``, the card line, and last
   the contract line ``{"ok": true, "device": {...}}``.

Needs one CUDA card; exits non-zero without one, or without the repository
beside it.
"""
from __future__ import annotations

import json
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


def bound(nbytes: float, flops: float):
    """Least time in ms the card could take, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(graph, dev):
    """Phase 2: K1 and K2 against their plain versions on the card."""
    from repro_torch.kernels.edge_softmax import (NEG, edge_softmax_stats,
                                                  softmax_stats_plain)
    from repro_torch.kernels.seg_sum import seg_sum_na, seg_sum_plain
    from repro_torch.pipeline import FrontendPipeline, PipelineConfig

    res = FrontendPipeline(PipelineConfig(pack=True)).run(graph, TARGETS)
    print("frontend (host, cold): " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in res.timings.items()))
    pk = res.packed["PAP"]
    nb, eb = pk.src_local.shape
    n_edges, tiles = pk.num_edges, pk.num_dst_tiles
    print(f"kernels: ACM PAP packing, {n_edges} edges in {nb} blocks over "
          f"{tiles} dst tiles, D={D}")
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
    for label, w in (("unit", None), ("random", w_rand)):
        a = seg_sum_na(pk, h, w)
        b = seg_sum_na(pk, h, w)
        ref = seg_sum_plain(pk, h, w)
        torch.cuda.synchronize()
        e = (a - ref).abs().max().item()
        excess = ((a - ref).abs() - K1_TOL * ref.abs()).max().item()
        print(f"K1 seg_sum ({label} weights): max|kernel - plain| = {e:.3e}, "
              f"max|plain| = {ref.abs().max().item():.3f} (tolerance {K1_TOL} "
              f"+ {K1_TOL} x |plain|); run-to-run bitwise equal: {torch.equal(a, b)}")
        require(excess <= K1_TOL, f"K1 {label} weights disagree with the plain version")
        require(torch.equal(a, b), f"K1 {label} weights not bitwise repeatable")
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
    meta = nb * 4 * 2 + nb * 4 + (tiles + 1) * 4  # band, count, tile list
    k1_bytes = n_edges * (2 + 2 + 4) + pk.num_src * D * 4 + pk.num_dst * D * 4 + meta
    k1_bound, k1_by = bound(k1_bytes, 2.0 * n_edges * D)
    out.append({
        "name": "seg_sum_na", "route": "cuda",
        "source": "src/repro_torch/csrc/na_kernels.cu",
        "replaces": "src/repro/kernels/seg_sum.py:516",
        "max_abs_err": err, "ms": k1_ms, "plain_ms": k1_plain,
        "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": k1_lib,
        "bytes": k1_bytes, "shape": f"E={n_edges} nb={nb} tiles={tiles} D={D}",
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
    print(f"K2 edge_softmax_stats: max|dm| = {em:.3e}, max|ds| = {es:.3e} "
          f"(relative {es_rel:.3e}, tolerance {K2_RTOL}); run-to-run bitwise "
          f"equal: {same}")
    require(em <= K2_RTOL and es_rel <= K2_RTOL,
            "K2 disagrees with the plain version")
    require(same, "K2 not bitwise repeatable")
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
    k2_bytes = n_edges * (2 + 4) + nb * 4 + nb * 4 + (tiles + 1) * 4 + pk.num_dst * 8
    k2_bound, k2_by = bound(k2_bytes, 6.0 * n_edges)
    out.append({
        "name": "edge_softmax_stats", "route": "cuda",
        "source": "src/repro_torch/csrc/na_kernels.cu",
        "replaces": "src/repro/kernels/edge_softmax.py:32",
        "max_abs_err": max(em, es), "ms": k2_ms, "plain_ms": k2_plain,
        "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": k2_lib,
        "bytes": k2_bytes, "shape": f"E={n_edges} nb={nb} tiles={tiles}",
    })
    for k in out:
        print(f"{k['name']}: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"library {k['library_ms']:.4f} ms, bound {k['bound_ms']:.6f} ms "
              f"({k['bound_by']}, {k['bytes']} bytes)")
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

    prof_forward(compiled["rgat"], params["rgat"], feats)
    return launches


def prof_forward(compiled, params, feats) -> None:
    """Device time by kernel name over one rgat forward (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    compiled.forward(params, feats)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        compiled.forward(params, feats)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue  # CPU ops: their device time is their kernels', counted below
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    if not rows:
        print("profile rgat forward: device time not measured (no device events)")
        return
    print(f"profile rgat forward: wall {wall:.3f} ms, device busy {total / 1e3:.3f} ms "
          f"({100 * total / 1e3 / wall:.1f}% of wall)")
    for dev_us, count, key in rows[:10]:
        print(f"  {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")


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
    kernels = phase_kernels(graph, dev)
    launches = phase_model(graph)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["kernel_ms"] = k["ms"]
        require(k["launches"] > 0, f"{k['name']} never launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
