"""Reductions shared by the per-layer metric readers
(``gpubench/metrics/<metric>.py``).  Each takes the traced run's
``TraceRecord`` and returns a number, or ``None`` when the trace holds
nothing to read: the harness then leaves the metric out."""
from __future__ import annotations

import sys
from typing import Dict, Optional

from gbench.trace import TraceRecord

NOT_KERNELS = ("Memcpy", "Memset")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def launches_per_step(rec: TraceRecord) -> Optional[float]:
    """Device kernels the profiler recorded, per profiled step (copies and
    fills left out)."""
    n = sum(1 for name, _, _ in rec.device_ops if not name.startswith(NOT_KERNELS))
    return n / rec.steps if n else None


def roofline_pct(rec: TraceRecord, kernels: Dict[str, str], key: str) -> Optional[float]:
    """Share of the roofline, in %, of the kernels ``{label: name
    pattern}`` over the launches the profiler recorded: the sum of the
    recorded launches' bounds over the sum of their device time.
    ``rec.facts[key]`` lists ``(label, bound seconds)`` of one step's
    launches in launch order.  Where a kernel's recorded launches are a
    whole number of steps' worth, each launch takes the bound of its place
    in the step; otherwise (the profiler lost some) each takes the mean
    bound of its kind.  The counts are printed beside the port's counters."""
    expected = rec.facts.get(key)
    if not expected:
        return None
    bound = dur = 0.0
    counters = rec.facts.get("counters_per_step", {})
    for label, pattern in kernels.items():
        launches = [op for op in rec.device_ops if pattern in op[0]]
        per_step = [b for k, b in expected if k == label]
        if not launches or not per_step:
            continue
        n, m = len(launches), len(per_step)
        exact = n == m * rec.steps
        _log(f"{label} ({pattern}): {n} launches recorded over {rec.steps} steps, "
             f"{m} expected a step; the port's counter {counters.get(label, 'n/a')} a step"
             + ("" if exact else "; bounds taken at the mean"))
        bound += sum(per_step * rec.steps) if exact else n * sum(per_step) / m
        dur += sum(d for _, _, d in launches)
    return 100.0 * bound / dur if dur > 0 else None


def mfu_pct(rec: TraceRecord) -> Optional[float]:
    """Counted FLOPs of the profiled steps over their window times the
    stated peak, in %."""
    flops = rec.facts.get("flops_per_step")
    if not flops or rec.window_s <= 0:
        return None
    return 100.0 * flops * rec.steps / rec.window_s / rec.facts["peak_flop_per_s"]


def device_idle_pct(rec: TraceRecord) -> Optional[float]:
    """Share of the traced window in which no operation ran on the
    device, in %."""
    if rec.window_s <= 0 or rec.busy_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - rec.busy_s / rec.window_s)


def frontend_stage_s(rec: TraceRecord, stage: str) -> Optional[float]:
    """Seconds of one stage of the program's cold frontend
    (``FrontendResult.timings``), as the program reported it at set-up."""
    t = rec.facts.get("frontend", {}).get(stage)
    return float(t) if t is not None else None
