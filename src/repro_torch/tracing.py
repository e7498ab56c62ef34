"""Spans and counters inside the port: time by layer without the profiler.

    from repro_torch import tracing

    tracing.reset()
    with tracing.recording():
        state, loss = step(state, features, labels, mask)
    snap = tracing.snapshot()  # {"spans": [...], "counters": {...}}
    tracing.totals(snap)       # {name: {"calls", "host_s", "device_s"}}

A span (``span(name, **attrs)``) records its name, its host start and end
(``time.perf_counter_ns``), its parent, the step it belongs to (every span
under one root span shares the root's step number: one train step, one
request) and its attributes.  On a machine with CUDA it also records a
pair of pooled ``torch.cuda.Event``s on the current stream, so its device
time, the time it held the stream with idle included, reads without the
profiler; and it enters ``torch.profiler.record_function(name)``, so it
lies on the profiler's clock beside the device's operations.  Spans nest
per thread.  A span opened on a thread with none open (autograd's device
thread runs a backward and a remat recompute there) takes the innermost
open span opened with ``adopt=True`` (``train.backward``) as its parent.

``count(name, value)`` adds to a counter; a tensor is summed on its
device and read once, by ``snapshot()``, which also reports the kernels'
own launch counters (``seg_sum_na.launches`` and the others).

Off, the default, ``span`` returns one shared no-op context after one
flag check and ``count`` returns at once: no events, no
``record_function``, no records.  ``recording()`` is the only switch.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch

_on = False
_cuda = False  # whether spans record CUDA events (set when recording starts)
_local = threading.local()  # .stack: the thread's open spans
_lock = threading.Lock()
_records: List["_Span"] = []
_counters: Dict[str, Any] = {}
_adopting: List["_Span"] = []  # open spans that adopt spans of threads with none open
_pool: List[tuple] = []  # free (start, end) event pairs
_ids = itertools.count()
_steps = itertools.count()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        """Nothing to annotate when recording is off."""


_NOOP = _Noop()


class _Span:
    __slots__ = ("id", "name", "parent", "step", "attrs", "t0", "t1", "events",
                 "device_s", "adopt", "_rf")

    def __init__(self, name: str, adopt: bool, attrs: Dict):
        self.name, self.adopt, self.attrs = name, adopt, attrs
        self.t1 = self.events = self.device_s = None

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else (_adopting[-1] if _adopting else None)
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.step = parent.step if parent is not None else next(_steps)
        stack.append(self)
        if self.adopt:
            _adopting.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if _cuda:
            try:
                self.events = _pool.pop()
            except IndexError:  # none free (another thread may have taken the last)
                self.events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
            self.events[0].record()
        _records.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self._rf.__exit__(None, None, None)
        _stack().remove(self)
        if self.adopt:
            _adopting.remove(self)
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)


def _stack() -> List[_Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, adopt: bool = False, **attrs):
    """A context that records one span while recording is on."""
    if not _on:
        return _NOOP
    return _Span(name, adopt, attrs)


@contextlib.contextmanager
def timed(name: str, out: Dict[str, float], key: str, **attrs):
    """``span(name)`` that also writes its host seconds into ``out[key]``,
    recording or not, from the same two clock reads."""
    if not _on:
        t0 = time.perf_counter_ns()
        yield _NOOP
        out[key] = (time.perf_counter_ns() - t0) * 1e-9
        return
    with _Span(name, False, attrs) as s:
        yield s
    out[key] = (s.t1 - s.t0) * 1e-9


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a tensor summed on its device) to the
    counter ``name`` while recording is on."""
    if not _on:
        return
    if isinstance(value, torch.Tensor):
        value = value.detach().sum()
    with _lock:
        prev = _counters.get(name)
        _counters[name] = value if prev is None else prev + value


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the ``with`` block."""
    global _on, _cuda
    before = _on
    _cuda = torch.cuda.is_available()
    _on = True
    try:
        yield
    finally:
        _on = before


def _launch_counters() -> Dict[str, int]:
    from repro_torch.kernels.edge_softmax import edge_softmax_stats
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.seg_sum import seg_sum_na
    from repro_torch.kernels.spgemm_bsr import spgemm_bsr
    from repro_torch.kernels.ssd_scan import ssd_scan

    return {f"{f.__name__}.launches": f.launches
            for f in (seg_sum_na, edge_softmax_stats, spgemm_bsr, flash_attention, ssd_scan)}


def snapshot() -> Dict[str, Any]:
    """Every closed span and every counter as plain data, after one
    synchronise: ``{"spans": [{"id", "name", "parent", "step", "host_s",
    "device_s", "t0_ns", "t1_ns", "attrs"}], "counters": {name: value}}``.
    ``device_s`` is ``None`` without CUDA events."""
    done = [r for r in list(_records) if r.t1 is not None]
    pending = [r for r in done if r.events is not None]
    if pending:
        torch.cuda.synchronize()
    for r in pending:
        r.device_s = r.events[0].elapsed_time(r.events[1]) * 1e-3
        _pool.append(r.events)
        r.events = None
    with _lock:
        counters = {k: v.item() if isinstance(v, torch.Tensor) else v
                    for k, v in _counters.items()}
    counters.update(_launch_counters())
    return {"spans": [{"id": r.id, "name": r.name, "parent": r.parent, "step": r.step,
                       "host_s": (r.t1 - r.t0) * 1e-9, "device_s": r.device_s,
                       "t0_ns": r.t0, "t1_ns": r.t1, "attrs": dict(r.attrs)} for r in done],
            "counters": counters}


def totals(snap: Dict[str, Any]) -> Dict[str, Dict[str, Optional[float]]]:
    """A snapshot's spans summed by name: calls, host seconds and device
    seconds (``None`` if any of them has no device time)."""
    out: Dict[str, Dict[str, Optional[float]]] = {}
    for s in snap["spans"]:
        t = out.setdefault(s["name"], {"calls": 0, "host_s": 0.0, "device_s": 0.0})
        t["calls"] += 1
        t["host_s"] += s["host_s"]
        t["device_s"] = (None if t["device_s"] is None or s["device_s"] is None
                         else t["device_s"] + s["device_s"])
    return out


def reset() -> None:
    """Drop every record and counter (the kernels' launch counters stay)."""
    with _lock:
        _counters.clear()
    for r in _records:
        if r.events is not None and r.t1 is not None:
            _pool.append(r.events)
            r.events = None
    _records.clear()
