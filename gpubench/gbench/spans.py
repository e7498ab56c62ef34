"""The program's own spans and counters (``repro_torch.tracing``) over a
cell's steps, and the reductions that the span metrics' readers share.

Two passes, each after the profiled passes of ``gbench.trace``, which run
with recording off:

- ``recorded``: recording on over ``steps`` calls with no profiler; every
  span's device time comes from its CUDA event pair.  It fills
  ``facts["spans"]`` (per span name: calls, host seconds, device seconds
  over the pass), ``facts["span_steps"]`` and ``facts["span_counters"]``.
- ``idle_by_span``: one call profiled with the host and the device,
  recording on; each idle stretch of the device is named by the innermost
  program span open on the host at its midpoint, beside the innermost
  host operation as ``gbench.trace`` names it.

``facts["setup_spans"]`` holds the totals of a snapshot taken over the
set-up under ``recording()`` (the frontend's stage spans).

A reader returns ``None`` where the record holds nothing to read: a run
of a program without these spans, or a CPU run (no device times).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

from gbench.trace import TraceRecord, _profile, _split, gaps, name_gaps

SPAN_PREFIXES = ("train.", "hgnn.", "lm.", "kernels.", "frontend.")


def recorded(step: Callable[[], None], steps: int, sync: Callable[[], None]) -> Dict:
    """Pass (a): ``steps`` calls of ``step`` with recording on and no
    profiler; their host seconds and the spans' facts."""
    from repro_torch import tracing

    tracing.reset()
    with tracing.recording():
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync()
        window = time.perf_counter() - t0
    snap = tracing.snapshot()
    tracing.reset()
    return {"spans": tracing.totals(snap), "span_steps": steps, "span_window_s": window,
            "span_counters": snap["counters"]}


def idle_by_span(step: Callable[[], None], sync: Callable[[], None]
                 ) -> Tuple[List[Tuple[str, float]], List[Tuple[str, float]]]:
    """Pass (b): one call after a warm one, profiled with the host and the
    device, recording on: ``(idle seconds by innermost program span, idle
    seconds by innermost host operation)``, most first."""
    import torch
    from torch.profiler import ProfilerActivity

    from repro_torch import tracing

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if torch.cuda.is_available() else [])
    tracing.reset()
    with tracing.recording():
        events, _ = _profile(step, 1, sync, activities)
    tracing.reset()
    dev, host = _split(events)
    idle = gaps([(s, s + d) for _, s, d in dev])
    spans = [op for op in host if op[0].startswith(SPAN_PREFIXES)]
    return name_gaps(idle, spans), name_gaps(idle, host)


def span_ms(rec: TraceRecord, *names: str) -> Optional[float]:
    """Device ms per step of the spans ``names`` (summed over their calls)
    in pass (a); ``None`` if none was recorded or one has no device time."""
    spans = rec.facts.get("spans") or {}
    found = [spans[n] for n in names if n in spans]
    if not found or any(t["device_s"] is None for t in found):
        return None
    return 1e3 * sum(t["device_s"] for t in found) / rec.facts["span_steps"]


def setup_span_s(rec: TraceRecord, name: str) -> Optional[float]:
    """Host seconds of the set-up's spans ``name``, summed over their calls
    (a restructure stage over every metapath)."""
    t = (rec.facts.get("setup_spans") or {}).get(name)
    return t["host_s"] if t else None


def counter_pct(rec: TraceRecord, part: str, whole: str) -> Optional[float]:
    """100 * counter ``part`` / counter ``whole`` in pass (a)."""
    c = rec.facts.get("span_counters") or {}
    if not c.get(whole) or part not in c:
        return None
    return 100.0 * c[part] / c[whole]
