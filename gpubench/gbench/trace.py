"""The traced run: ``torch.profiler`` over a fixed number of steps or
requests inside the window, reduced to what the per-layer metric readers
and the result's ``breakdown`` need.  No chrome trace is written.  The
profiler's own step annotations, which it also lays over the device's
timeline, are not device operations and are left out.

``TraceRecord`` holds the reduction: every device operation of the
profiled steps in start order, the device's busy seconds (the union of
their intervals), the traced window on the host clock, the longest idle
gaps named by the host operation under them (from one more call traced
with the host's operations), and the kind's own facts
(launch bounds, FLOPs, counters, frontend stage times) for the readers.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

TOP = 10  # entries in each list of the breakdown


@dataclasses.dataclass
class TraceRecord:
    steps: int  # profiled steps or requests
    window_s: float  # host seconds of the profiled steps, synchronised
    busy_s: float  # union of the device operations' intervals
    device_ops: List[Tuple[str, float, float]]  # (name, start s, seconds), start order
    idle_gaps: List[Tuple[str, float]]  # (host operation under the gap, seconds), longest first
    facts: Dict = dataclasses.field(default_factory=dict)

    def kernels(self, *patterns: str) -> List[Tuple[str, float, float]]:
        """The device operations whose name holds any of ``patterns``."""
        return [op for op in self.device_ops if any(p in op[0] for p in patterns)]

    def breakdown(self) -> Dict:
        """The result's ``breakdown``: the device operations that took most
        time (summed by name) and the longest idle gaps."""
        by_name: Dict[str, float] = {}
        for name, _, dur in self.device_ops:
            by_name[name] = by_name.get(name, 0.0) + dur
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:160], s] for n, s in top],
                "idle_gaps": [[n[:160], s] for n, s in self.idle_gaps[:TOP]]}


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur = 0.0, None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total


def gaps(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The idle ``(start, end)`` stretches between the intervals' union."""
    out, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def name_gaps(idle: List[Tuple[float, float]], host_ops: List[Tuple[str, float, float]]
              ) -> List[Tuple[str, float]]:
    """Idle seconds summed by the host operation under each idle
    stretch's midpoint (the innermost: of the host operations covering it,
    the one that started last), most first."""
    import heapq

    ops = sorted(host_ops, key=lambda op: op[1])
    heap: List[Tuple[float, float, str]] = []  # (-start, end, name)
    by_name: Dict[str, float] = {}
    i = 0
    for s, e in sorted(idle, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (s + e)
        while i < len(ops) and ops[i][1] <= mid:
            heapq.heappush(heap, (-ops[i][1], ops[i][2], ops[i][0]))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "host: no operation recorded"
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    return sorted(by_name.items(), key=lambda kv: -kv[1])


def _profile(step, steps: int, sync, activities):
    """``(events, host seconds of the active steps)`` of ``steps`` calls
    of ``step`` after one warm call, under the profiler."""
    from torch.profiler import profile, schedule

    kept = []  # the events, taken when the trace is ready (the profiler then clears them)
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=steps),
                 on_trace_ready=lambda p: kept.append(p.events())) as prof:
        step()
        sync()
        prof.step()
        t0 = time.perf_counter()
        for i in range(steps):
            step()
            if i == steps - 1:
                sync()
                window = time.perf_counter() - t0
            prof.step()
    if not kept:
        raise RuntimeError("the profiler returned no trace")
    return kept[-1], window


def _split(events):
    """``(device operations, host operations)``: ``(name, start s, seconds)``
    and ``(name, start s, end s)``."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for ev in events:
        tr = ev.time_range
        annotation = getattr(ev, "is_user_annotation", False) or ev.name.startswith("ProfilerStep")
        if ev.device_type == DeviceType.CUDA and not annotation:
            dev.append((ev.name, tr.start * 1e-6, (tr.end - tr.start) * 1e-6))
        elif ev.device_type == DeviceType.CPU:
            host.append((ev.name, tr.start * 1e-6, tr.end * 1e-6))
    dev.sort(key=lambda op: op[1])
    return dev, host


def profile_steps(step: Callable[[], None], steps: int, sync: Callable[[], None],
                  facts: Optional[Dict] = None,
                  counters: Optional[Dict[str, Callable[[], int]]] = None) -> TraceRecord:
    """Profile ``steps`` calls of ``step`` and reduce them.  The device's
    operations, busy time and window come from a trace of the device
    alone, which costs the host little; the idle gaps are then named from
    one more call traced with the host's operations too (recording them
    slows the host, so that trace's gaps are longer than the window's).
    ``sync`` waits for the device.  ``counters`` (the port's launch
    counters by kernel) are read around the tracing; their launches a call
    go into ``facts["counters_per_step"]``."""
    import torch
    from torch.profiler import ProfilerActivity

    # (a build without CUDA, as in the CPU tests, traces the host instead)
    first = ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
    counters = counters or {}
    before = {k: read() for k, read in counters.items()}
    events, window = _profile(step, steps, sync, [first])
    dev, _ = _split(events)
    iv = [(s, s + d) for _, s, d in dev]
    events, _ = _profile(step, 1, sync, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    named_dev, host = _split(events)
    named_iv = [(s, s + d) for _, s, d in named_dev]
    facts = dict(facts or {})
    calls = steps + 3  # a warm call and the steps, then a warm call and one named
    facts["counters_per_step"] = {k: (read() - before[k]) / calls for k, read in counters.items()}
    return TraceRecord(steps=steps, window_s=window, busy_s=union_seconds(iv),
                       device_ops=dev, idle_gaps=name_gaps(gaps(named_iv), host), facts=facts)
