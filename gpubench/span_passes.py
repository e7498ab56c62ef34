"""The program's own spans over one cell's steps (not run by ``run.py``).

    python3 gpubench/span_passes.py --workload <cell> --seed <n> \\
        [--blocks 3] [--steps <k>] [--out chiprun_out/spans.jsonl]

The cell's set-up (as its kind builds it: inputs and weights from the
seed, the program, its first steps) runs under
``repro_torch.tracing.recording()``, so the frontend's stage spans are
kept.  Then ``--blocks`` times in turn: ``--steps`` steps (the cell's
``trace_steps`` by default) with recording off, and the same number with
it on and no profiler (``gbench.spans.recorded``); the host seconds a step
of the two give what recording costs, and the last recorded block is
pass (a).  Pass (b) profiles one call with the host and the device,
recording on, and names the device's idle time by program span.  The span
metrics' readers (``gpubench/metrics/``) then read the record.  One JSON
line goes to standard output (and to ``--out``).  Run on the card.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

# the span metrics of each kind
METRICS = {
    "hgnn_train": ("step_forward_ms.hgnn_train", "step_backward_ms.hgnn_train",
                   "step_optimizer_ms.hgnn_train", "na_ms.hgnn_train",
                   "restructure_recouple_s", "restructure_decouple_s"),
    "lm_train": ("step_backward_ms.lm_train", "step_optimizer_ms.lm_train",
                 "attn_backward_ms.lm_train", "moe_dispatch_ms.lm_train",
                 "moe_slot_fill_pct.lm_train"),
    "lm_prefill": ("k4_ms.prefill", "moe_dispatch_ms.prefill"),
}


def _hgnn_train(ctx, drv):
    import torch

    from gbench import hgnn_inputs

    inp = hgnn_inputs.make(ctx.cell.config, ctx.seed, ctx.device)
    _, step, state = drv.build_program(ctx, inp)
    labels, mask = inp.labels.to(torch.int32), inp.masks["train"]
    _, state = drv.first_steps(step, state, inp.features, labels, mask, drv.CHECK_STEPS)
    box = {"state": state}

    def one():
        box["state"], _ = step(box["state"], inp.features, labels, mask)
    return one


def _lm_train(ctx, drv):
    from gbench import lm_inputs

    cfg, spec = ctx.cell.config, ctx.cell.spec
    stream = lm_inputs.TokenStream(cfg["vocab_size"], spec["batch"], spec["seq"], ctx.seed,
                                   ctx.device)
    _, step, state = drv.build_program(ctx, lm_inputs.params(cfg, ctx.seed, ctx.device))
    _, state = drv.first_steps(step, state, stream.take(drv.CHECK_STEPS))
    box = {"state": state}

    def one():
        tok, tgt = stream.next()
        box["state"], _ = step(box["state"], tok, tgt)
    return one


def _lm_prefill(ctx, drv):
    from gbench import lm_inputs

    cfg, spec = ctx.cell.config, ctx.cell.spec
    client = drv.Client(ctx, lm_inputs.params(cfg, ctx.seed, ctx.device))
    warm = lm_inputs.TokenStream(cfg["vocab_size"], spec["batch"], spec["seq"], ctx.seed + 1,
                                 ctx.device)
    for _ in range(spec["warm_requests"]):
        client.prefill(warm.next()[0])
    return lambda: client.prefill(warm.next()[0])


BUILD = {"hgnn_train": _hgnn_train, "lm_train": _lm_train, "lm_prefill": _lm_prefill}


def measure(ctx, blocks: int, steps: int) -> dict:
    """Everything above for the cell of ``ctx``, as one dict."""
    from gbench import common, harness, spans
    from gbench.trace import TraceRecord
    from reference import precision
    from repro_torch import tracing

    kind = ctx.cell.kind
    drv = harness.driver(kind)
    precision.strict_float32()

    def sync():
        common.sync(ctx.device)

    tracing.reset()
    with tracing.recording():
        one = BUILD[kind](ctx, drv)
        sync()
    setup_s = time.perf_counter() - ctx.t_start
    facts = {"setup_spans": tracing.totals(tracing.snapshot())}
    off, on = [], []
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(steps):
            one()
        sync()
        off.append((time.perf_counter() - t0) / steps)
        rec = spans.recorded(one, steps, sync)
        on.append(rec["span_window_s"] / steps)
    facts.update(rec)
    by_span, by_op = spans.idle_by_span(one, sync)
    record = TraceRecord(steps=steps, window_s=rec["span_window_s"], busy_s=0.0,
                         device_ops=[], idle_gaps=[], facts=facts)
    metrics = {name: harness.metric_reader(name).read(record) for name in METRICS[kind]}
    per_step = {name: {"calls": t["calls"] / steps, "host_ms": 1e3 * t["host_s"] / steps,
                       "device_ms": (None if t["device_s"] is None
                                     else 1e3 * t["device_s"] / steps)}
                for name, t in facts["spans"].items()}
    out = {"workload": ctx.cell.name, "seed": ctx.seed, "setup_s": setup_s,
           "steps": steps, "host_ms_off": [1e3 * x for x in off],
           "host_ms_on": [1e3 * x for x in on],
           "recording_cost_pct": 100.0 * (statistics.median(on) / statistics.median(off) - 1),
           "metrics": metrics, "spans_per_step": per_step,
           "counters": facts["span_counters"],
           "setup_spans": facts["setup_spans"],
           "idle_by_span": by_span[:12], "idle_by_op": by_op[:12],
           "idle_s": sum(s for _, s in by_op)}
    phases = [spans.span_ms(record, n) for n in ("train.forward", "train.backward",
                                                 "train.optimizer")]
    if all(p is not None for p in phases):
        out["phases_over_step_pct"] = 100.0 * sum(phases) / (1e3 * on[-1])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH_DIR), str(ROOT / "src")]
    import torch

    from gbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    ctx = harness.RunContext(cell=cell, root=ROOT, seed=args.seed, seconds=0.0, trace=True,
                             device="cuda", t_start=T_START)
    out = measure(ctx, args.blocks, args.steps or cell.spec["trace_steps"])
    out["device"] = torch.cuda.get_device_name(0)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
