"""Driver of ``lm_prefill`` cells: one closed-loop client sending batches
of prompts to the port's ``LM.forward(..., last_only=True)``, each batch
sent when the last one's logits have reached the host.

Set-up draws the weights on the card from the seed and warms the batch's
shape.  Each request's prompts are new token rows from the seed's stream;
its latency runs from its submission to its logits on the host.  After the
window a sample of the finished requests, drawn from the seed, is
recomputed by the plain reference (``reference/lm_ref.py``) and the
last-position logits compared.
"""
from __future__ import annotations

import random
import time

import torch

from gbench import arith, common, lm_inputs
from gbench import trace as tracing
from gbench.harness import DriverResult, RunContext
from reference import lm_ref, precision

FAULTS = ("altered_answer",)


def logit_max_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap of a served logit from the reference's, in units of
    the reference row's standard deviation, over every row and entry."""
    got, ref = got.float(), ref.float()
    return float(((got - ref).abs().amax(-1) / ref.std(-1).clamp(min=1e-30)).max())


class Client:
    """The closed-loop client over the port's forward."""

    def __init__(self, ctx: RunContext, params, fault=None):
        from repro_torch.models.lm import LM

        cfg, spec = ctx.cell.config, ctx.cell.spec
        self.model = LM(common.arch_config(cfg), device=ctx.device, remat="none")
        self.params, self.cfg, self.device = params, cfg, ctx.device
        self.stream = lm_inputs.TokenStream(cfg["vocab_size"], spec["batch"], spec["seq"],
                                            ctx.seed, ctx.device)
        self.prompts, self.answers, self.latency = [], [], []
        self.fault = fault

    def prefill(self, tok: torch.Tensor) -> torch.Tensor:
        logits, _, _ = self.model.forward(self.params, tok, last_only=True)
        out = logits[:, -1, : self.cfg["vocab_size"]].to("cpu")
        if self.fault == "altered_answer":  # one served logit altered where it is produced
            out = out.clone()
            out[0, 0] += 1.0
        return out

    def request(self) -> None:
        tok, _ = self.stream.next()
        t0 = time.perf_counter()
        out = self.prefill(tok)
        self.latency.append(time.perf_counter() - t0)
        self.prompts.append(tok)
        self.answers.append(out)


def reference_logits(params, prompts, cfg, mode: str) -> torch.Tensor:
    with torch.no_grad():
        logits, _ = lm_ref.forward(params, prompts, cfg, mode, last_only=True)
    return logits[:, -1].to("cpu")


def sample(n_done: int, k: int, seed: int):
    return sorted(random.Random(seed).sample(range(n_done), min(k, n_done)))


def calibrate(ctx: RunContext, controls=("fp8",), fault_list=FAULTS) -> dict:
    """For one seed: the program's, each control's and each fault's
    widest logit gap over ``check_requests`` requests."""
    cfg, spec = ctx.cell.config, ctx.cell.spec
    precision.strict_float32()
    params = lm_inputs.params(cfg, ctx.seed, ctx.device)
    out = {}
    client = Client(ctx, params)
    for _ in range(spec["check_requests"]):
        client.request()
    refs = [reference_logits(params, p, cfg, "float32") for p in client.prompts]
    out["program"] = {"logit_max_err": max(logit_max_err(a, r) for a, r in zip(client.answers, refs))}
    for fault in fault_list:
        client.fault = fault
        got = [client.prefill(p) for p in client.prompts]
        out[f"fault:{fault}"] = {"logit_max_err": max(logit_max_err(a, r) for a, r in zip(got, refs))}
    for mode in controls:
        got = [reference_logits(params, p, cfg, mode) for p in client.prompts]
        out[f"control:{mode}"] = {"logit_max_err": max(logit_max_err(a, r) for a, r in zip(got, refs))}
    return out


def run(ctx: RunContext) -> DriverResult:
    cfg, spec, dev = ctx.cell.config, ctx.cell.spec, ctx.device
    precision.strict_float32()
    params = lm_inputs.params(cfg, ctx.seed, dev)
    client = Client(ctx, params, ctx.fault)
    warm = lm_inputs.TokenStream(cfg["vocab_size"], spec["batch"], spec["seq"],
                                 ctx.seed + 1, dev)
    for _ in range(spec["warm_requests"]):
        client.prefill(warm.next()[0])
    common.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"set-up {setup_s:.3f} s")
    record = None
    if ctx.trace:
        from repro_torch.kernels.flash_attention import flash_attention

        b, s = spec["batch"], spec["seq"]
        bound = arith.k4_bound_s(b, cfg["num_heads"], cfg["num_kv_heads"], s, s,
                                 cfg["head_dim"], cfg["head_dim"], True)
        facts = {"k4_launches": [("K4", bound)] * cfg["num_layers"],
                 "flops_per_step": arith.lm_forward_flops(cfg, b, s, head_rows=1),
                 "peak_flop_per_s": arith.BF16_FLOP_PER_S}
        record = tracing.profile_steps(lambda: client.prefill(warm.next()[0]),
                                       spec["trace_steps"], lambda: common.sync(dev), facts,
                                       {"K4": lambda: flash_attention.launches})
        ctx.log(f"traced {record.steps} requests: window {record.window_s:.6f} s, busy "
                f"{record.busy_s:.6f} s; port counters a request {record.facts['counters_per_step']}")
    n, seconds = common.window(client.request, ctx.seconds, dev)
    peak = common.peak_bytes(dev)
    lat = client.latency
    ctx.log(f"window {seconds:.6f} s, {n} requests; latency ms p50 "
            f"{common.percentile(lat, 50) * 1e3:.3f} p95 {common.percentile(lat, 95) * 1e3:.3f} "
            f"max {max(lat) * 1e3:.3f}")
    picked = sample(n, spec["check_requests"], ctx.seed)
    err = max(logit_max_err(client.answers[i],
                            reference_logits(params, client.prompts[i], cfg, "float32"))
              for i in picked)
    return DriverResult(
        attempted=n, failed=0,
        end_to_end={"setup_s": setup_s,
                    "prefill_tokens_per_s": n * spec["batch"] * spec["seq"] / seconds,
                    "request_p95_ms": common.percentile(lat, 95) * 1e3},
        memory_peak_bytes=peak,
        checks={"logit_max_err": (err, spec["limits"]["logit_max_err"])},
        trace=record)
