"""Driver of ``lm_train`` cells: LM train steps back to back.

Set-up draws the weights on the card from the seed (``gbench.lm_inputs``),
builds the port's model and step (``train/train_step.py::
build_train_step`` on ``launch/mesh.py::make_debug_mesh(1, 1)``, AdamW at
a constant learning rate) and drives that step object through its first
three steps on new token rows, which also warm every shape.  The window
runs the step on new rows until ``--seconds`` have passed and ends in one
synchronise.  Afterwards the plain reference (``reference/lm_ref.py``)
follows the first three steps from the same weights and rows.
"""
from __future__ import annotations

import gc
import time


from gbench import arith, common, compare, lm_inputs
from gbench import trace as tracing
from gbench.harness import DriverResult, RunContext
from reference import lm_ref, precision
from reference.tree import leaves

B1 = 0.9  # the port's AdamW first-moment decay: the first gradient is mu / (1 - B1)
CHECK_STEPS = 3
FAULTS = ("frozen_state", "half_batch")


def build_program(ctx: RunContext, params):
    """``(model, step, state)`` of the port over ``params``."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.lm import LM, padded_vocab
    from repro_torch.train.optim import adamw_init
    from repro_torch.train.train_step import TrainState, build_train_step

    cfg, spec = ctx.cell.config, ctx.cell.spec
    arch = common.arch_config(cfg)
    if padded_vocab(arch) != cfg["padded_vocab"]:
        raise ValueError(f"the port pads the vocabulary to {padded_vocab(arch)}, "
                         f"the configuration to {cfg['padded_vocab']}")
    model = LM(arch, device=ctx.device, remat=spec["remat"])
    step, _ = build_train_step(model, make_debug_mesh(1, 1, device=ctx.device), spec["batch"],
                               lr=spec["lr"], microbatches=spec["microbatches"])
    return model, step, TrainState(params=params, opt=adamw_init(params), residuals=None)


def plant(fault, step, batch):
    """``(step, batch)`` with ``fault`` planted under the step."""
    if fault is None:
        return step, batch
    if fault == "frozen_state":
        def frozen(state, tok, tgt):
            _, m = step(state, tok, tgt)
            return state, m
        return frozen, batch
    if fault == "half_batch":
        tok, tgt = batch
        half = tok.shape[0] // 2
        return step, (tok[:half], tgt[:half])
    raise ValueError(f"unknown fault {fault!r}; have {FAULTS}")


def first_steps(step, state, batches, fault=None):
    """The program's readings over ``batches``: step losses, the first
    gradient's per-leaf norms (as AdamW got it), and the change's after
    the last step; and the state then."""
    p0 = leaves(state.params)
    losses, grad_norms = [], None
    for k, batch in enumerate(batches):
        s, (tok, tgt) = plant(fault, step, batch)
        state, m = s(state, tok, tgt)
        losses.append(m["loss"])
        if k == 0:
            grad_norms = compare.norms([t / (1 - B1) for t in leaves(state.opt.mu)])
    change = compare.norms([p.float() - q.float() for p, q in zip(leaves(state.params), p0)])
    return {"losses": [float(x) for x in losses], "grad_norms": grad_norms,
            "change_norms": change}, state


def reference_readings(ctx: RunContext, mode: str) -> dict:
    cfg, spec = ctx.cell.config, ctx.cell.spec
    params = lm_inputs.params(cfg, ctx.seed, ctx.device)
    stream = lm_inputs.TokenStream(cfg["vocab_size"], spec["batch"], spec["seq"], ctx.seed, ctx.device)
    out = lm_ref.train(params, stream.take(CHECK_STEPS), cfg, spec["lr"], mode=mode)
    del params
    return out


def calibrate(ctx: RunContext, controls=("fp8",), fault_list=FAULTS) -> dict:
    """For one seed, with no window: the program's numbers against the
    reference, each control's and each planted fault's."""
    cfg, spec = ctx.cell.config, ctx.cell.spec
    precision.strict_float32()
    out = {}
    for fault in (None,) + tuple(fault_list):
        params = lm_inputs.params(cfg, ctx.seed, ctx.device)
        stream = lm_inputs.TokenStream(cfg["vocab_size"], spec["batch"], spec["seq"], ctx.seed,
                                       ctx.device)
        _, step, state = build_program(ctx, params)
        prog, state = first_steps(step, state, stream.take(CHECK_STEPS), fault)
        del step, state, params
        gc.collect()
        common.fresh_peak(ctx.device)
        out["program" if fault is None else f"fault:{fault}"] = prog
    ref = reference_readings(ctx, "float32")
    steps = spec.get("loss_steps")
    for mode in controls:
        ctrl = reference_readings(ctx, mode)
        out[f"control:{mode}"] = compare.train_checks(ctrl, ref, steps)
        out[f"control:{mode}"]["loss_gap_by_step"] = compare.loss_gaps(ctrl["losses"], ref["losses"])
    for key in [k for k in out if k == "program" or k.startswith("fault:")]:
        by_step = compare.loss_gaps(out[key]["losses"], ref["losses"])
        out[key] = compare.train_checks(out[key], ref, steps)
        out[key]["loss_gap_by_step"] = by_step
    return out


def run(ctx: RunContext) -> DriverResult:
    cfg, spec, dev = ctx.cell.config, ctx.cell.spec, ctx.device
    precision.strict_float32()
    params = lm_inputs.params(cfg, ctx.seed, dev)
    stream = lm_inputs.TokenStream(cfg["vocab_size"], spec["batch"], spec["seq"], ctx.seed, dev)
    model, step, state = build_program(ctx, params)
    del params
    prog, state = first_steps(step, state, stream.take(CHECK_STEPS), ctx.fault)
    gc.collect()
    common.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"set-up {setup_s:.3f} s; first losses {prog['losses']}")
    box = {"state": state}
    del state

    def one_step():
        tok, tgt = stream.next()
        box["state"], _ = step(box["state"], tok, tgt)

    record = None
    if ctx.trace:
        from repro_torch.kernels.flash_attention import flash_attention

        b, s = spec["batch"], spec["seq"]
        per_step = cfg["num_layers"] * (2 if spec["remat"] == "full" else 1)
        bound = arith.k4_bound_s(b, cfg["num_heads"], cfg["num_kv_heads"], s, s,
                                 cfg["head_dim"], cfg["head_dim"], True)
        facts = {"k4_launches": [("K4", bound)] * per_step,
                 "flops_per_step": arith.lm_train_flops(cfg, b, s),
                 "peak_flop_per_s": arith.BF16_FLOP_PER_S}
        record = tracing.profile_steps(one_step, spec["trace_steps"], lambda: common.sync(dev),
                                       facts, {"K4": lambda: flash_attention.launches})
        ctx.log(f"traced {record.steps} steps: window {record.window_s:.6f} s, busy "
                f"{record.busy_s:.6f} s; port counters a step {record.facts['counters_per_step']}")
    steps, seconds = common.window(one_step, ctx.seconds, dev)
    peak = common.peak_bytes(dev)
    ctx.log(f"window {seconds:.6f} s, {steps} steps")
    del box, step, model
    gc.collect()
    common.fresh_peak(dev)
    ref = reference_readings(ctx, "float32")
    checks = compare.train_checks(prog, ref, spec.get("loss_steps"))
    limits = spec["limits"]
    tokens = steps * spec["batch"] * spec["seq"]
    return DriverResult(
        attempted=steps, failed=0,
        end_to_end={"setup_s": setup_s, "train_tokens_per_s": tokens / seconds},
        memory_peak_bytes=peak,
        checks={k: (v, limits[k]) for k, v in checks.items() if k in limits},
        trace=record)
