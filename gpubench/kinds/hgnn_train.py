"""Driver of ``hgnn_train`` cells: full-graph semi-supervised HGNN
training steps back to back.

Set-up makes the inputs from the seed (``gbench.hgnn_inputs``), compiles
the model through the port's ``Session`` (its frontend: SGB, the Graph
Restructurer, packing), builds the port's train step
(``train/hgnn_step.py::make_train_step``, AdamW at a constant learning
rate) and drives that same step object through the cell's first steps,
which also warm every shape.  The window then runs the step until
``--seconds`` have passed, and ends in one synchronise.  Afterwards the
plain reference (``reference/hgnn_ref.py``) recomposes the semantic
graphs and follows the first three steps from the same inputs.
"""
from __future__ import annotations

import gc
import statistics
import time

import torch

from gbench import arith, common, compare, hgnn_inputs, hgnn_port
from gbench import trace as tracing
from gbench.harness import DriverResult, RunContext
from reference import hgnn_ref, precision
from reference.tree import leaf_paths, leaves, rebuild

B1 = 0.9  # the port's AdamW first-moment decay: the first gradient is mu / (1 - B1)
CHECK_STEPS = 3


# faults planted under the timed path, for control.py and the tests (run.py
# plants none): the step returns the state it was given; half of the
# training rows left out of the loss, the mean taken over the rest; one
# logit of one row the loss reads raised by 1, every call
FAULTS = ("frozen_state", "half_batch", "altered_answer")


def halve(mask: torch.Tensor) -> torch.Tensor:
    """``mask`` with every other of its set rows cleared."""
    rows = torch.nonzero(mask > 0)[:, 0]
    out = mask.clone()
    out[rows[1::2]] = 0
    return out


def alter_output(fn, row: int):
    """``fn`` whose output's first logit of row ``row`` is raised by 1."""
    def altered(*args, **kw):
        out = fn(*args, **kw)
        bump = torch.zeros_like(out)
        bump[row, 0] = 1.0
        return out + bump
    return altered


def plant(fault, step, compiled, mask):
    """``(step, mask)`` with ``fault`` planted under the step."""
    if fault is None:
        return step, mask
    if fault == "frozen_state":
        def frozen(state, *args):
            _, loss = step(state, *args)
            return state, loss
        return frozen, mask
    if fault == "half_batch":
        return step, halve(mask)
    if fault == "altered_answer":
        row = int(torch.nonzero(mask > 0)[0, 0])
        compiled.model.execute = alter_output(compiled.model.execute, row)
        return step, mask
    raise ValueError(f"unknown fault {fault!r}; have {FAULTS}")


def build_program(ctx: RunContext, inp):
    """The port's compiled model and train step over the cell's inputs:
    ``(compiled, step, state)``."""
    from repro_torch.train.hgnn_step import HGNNTrainState, make_train_step
    from repro_torch.train.optim import adamw_init

    spec = ctx.cell.spec
    compiled = hgnn_port.compile_model(ctx.cell.config, inp, ctx.device)
    params = rebuild(inp.params, [t.clone() for t in leaves(inp.params)])
    state = HGNNTrainState(params=params, opt=adamw_init(params))
    # a constant learning rate: no warmup, and a cosine whose end lies past
    # any run (its factor rounds to 1 in float32)
    step = make_train_step(compiled.model, compiled.graphs, lr=spec["lr"], warmup=0,
                           total=10 ** 12, weight_decay=spec["weight_decay"])
    return compiled, step, state


def first_steps(step, state, feats, labels, mask, n: int):
    """Drive ``step`` through ``n`` steps from ``state``; the program's
    readings (step losses, the first gradient's and the change's per-leaf
    norms) and the state after them."""
    p0 = [t.clone() for t in leaves(state.params)]
    losses, grad_norms = [], None
    for k in range(n):
        state, loss = step(state, feats, labels, mask)
        losses.append(loss)
        if k == 0:
            grad_norms = compare.norms([m / (1 - B1) for m in leaves(state.opt.mu)])
    change = compare.norms([p - q for p, q in zip(leaves(state.params), p0)])
    return {"losses": [float(x) for x in losses], "grad_norms": grad_norms,
            "change_norms": change}, state


def reference_readings(inp, target: str, mask, lr: float, wd: float, mode: str) -> dict:
    ref = hgnn_ref.train(inp.params, inp.features[target], inp.semantic, target, inp.labels,
                         mask, steps=CHECK_STEPS, lr=lr, mode=mode, wd=wd)
    p0 = leaves(inp.params)
    return {"losses": ref["losses"], "grad_norms": compare.norms(ref["grads"]),
            "change_norms": compare.norms([p - q for p, q in zip(ref["params"], p0)])}


def look(prog: dict, ref: dict, params) -> dict:
    """Where the gaps come from: the three leaves with the widest gaps of
    the change (``worst``) and of the first gradient (``worst_grad``), as
    (path, gap, the reference's gradient norm over the median leaf's),
    and the median leaf's change gap."""
    keep = compare.moved(ref["grad_norms"])
    gaps = compare.leaf_gaps(prog["change_norms"], ref["change_norms"], keep)
    grad_gaps = compare.leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    med_g = statistics.median([g for g in ref["grad_norms"] if g > 0])
    paths = leaf_paths(params)
    kept = [i for i, k in enumerate(keep) if k]
    worst = sorted(kept, key=lambda i: -gaps[i])[:3]
    worst_grad = sorted(range(len(paths)), key=lambda i: -grad_gaps[i])[:3]
    return {"worst": [[paths[i], gaps[i], ref["grad_norms"][i] / med_g] for i in worst],
            "worst_grad": [[paths[i], grad_gaps[i], ref["grad_norms"][i] / med_g]
                           for i in worst_grad],
            "median_gap": statistics.median(gaps[i] for i in kept),
            "left_out": [paths[i] for i, k in enumerate(keep) if not k and ref["grad_norms"][i] > 0]}


def calibrate(ctx: RunContext, controls=("tf32",), fault_list=FAULTS) -> dict:
    """Readings that the limits are set from, for one seed, with no
    window: the program's numbers against the reference, each control's
    (the reference at a lower precision in the program's place) and each
    planted fault's."""
    spec, cfg = ctx.cell.spec, ctx.cell.config
    dev = ctx.device
    precision.strict_float32()
    target = cfg["model"]["target_type"]
    inp = hgnn_inputs.make(cfg, ctx.seed, dev)
    compiled, step0, state0 = build_program(ctx, inp)
    labels = inp.labels.to(torch.int32)
    mask = inp.masks["train"]
    semantic = hgnn_port.semantic_edges(compiled)
    out = {"sgb_edges_diff": hgnn_port.sgb_edges_diff(semantic, inp.semantic,
                                                      inp.num_vertices[target])}
    ref = reference_readings(inp, target, mask, spec["lr"], spec["weight_decay"], "float32")
    execute = compiled.model.execute
    for fault in (None,) + tuple(fault_list):
        # the step is functional: every pass starts from the same state
        step, fmask = plant(fault, step0, compiled, mask)
        prog, _ = first_steps(step, state0, inp.features, labels, fmask, CHECK_STEPS)
        compiled.model.execute = execute
        out["program" if fault is None else f"fault:{fault}"] = compare.train_checks(prog, ref)
        if fault is None:
            out["look"] = look(prog, ref, inp.params)
    for mode in controls:
        ctrl = reference_readings(inp, target, mask, spec["lr"], spec["weight_decay"], mode)
        out[f"control:{mode}"] = compare.train_checks(ctrl, ref)
    return out


def run(ctx: RunContext) -> DriverResult:
    spec, cfg = ctx.cell.spec, ctx.cell.config
    dev = ctx.device
    precision.strict_float32()
    target = cfg["model"]["target_type"]
    inp = hgnn_inputs.make(cfg, ctx.seed, dev)
    common.sync(dev)
    common.fresh_peak(dev)
    compiled, step, state = build_program(ctx, inp)
    labels = inp.labels.to(torch.int32)
    mask = inp.masks["train"]
    step, mask = plant(ctx.fault, step, compiled, mask)
    prog, state = first_steps(step, state, inp.features, labels, mask, CHECK_STEPS)
    common.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"set-up {setup_s:.3f} s; frontend {compiled.frontend.timings}")

    box = {"state": state}

    def one_step():
        box["state"], _ = step(box["state"], inp.features, labels, mask)

    record = None
    if ctx.trace:
        from repro_torch.kernels.edge_softmax import edge_softmax_stats
        from repro_torch.kernels.seg_sum import seg_sum_na

        sizes = hgnn_port.graph_sizes(compiled)
        model = cfg["model"]
        facts = {
            "frontend": dict(compiled.frontend.timings),
            "na_launches": arith.na_train_launches(sizes, model["hidden"], model["num_layers"]),
            "flops_per_step": arith.hgnn_flops(
                inp.num_vertices, inp.feature_dims, target, sizes, model["hidden"],
                model["num_layers"], model["sf_att_dim"], model["num_classes"], train=True),
            "peak_flop_per_s": arith.FP32_FLOP_PER_S,
        }
        record = tracing.profile_steps(
            one_step, spec["trace_steps"], lambda: common.sync(dev), facts,
            {"K1": lambda: seg_sum_na.launches, "K2": lambda: edge_softmax_stats.launches})
        ctx.log(f"traced {record.steps} steps: window {record.window_s:.6f} s, busy "
                f"{record.busy_s:.6f} s; port counters a step {record.facts['counters_per_step']}")
    steps, window = common.window(one_step, ctx.seconds, dev)
    peak = common.peak_bytes(dev)
    ctx.log(f"window {window:.6f} s, {steps} steps")

    semantic = hgnn_port.semantic_edges(compiled)
    del box, state, step, compiled
    gc.collect()
    common.fresh_peak(dev)
    ref = reference_readings(inp, target, inp.masks["train"], spec["lr"],
                             spec["weight_decay"], "float32")
    checks = {"sgb_edges_diff": hgnn_port.sgb_edges_diff(semantic, inp.semantic,
                                                         inp.num_vertices[target])}
    checks.update(compare.train_checks(prog, ref))
    limits = spec["limits"]
    return DriverResult(
        attempted=steps, failed=0,
        end_to_end={"setup_s": setup_s, "hgnn_epoch_ms": window / steps * 1e3},
        memory_peak_bytes=peak,
        checks={k: (v, limits[k]) for k, v in checks.items() if k in limits},
        trace=record)
