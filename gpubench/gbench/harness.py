"""The general part of a run: find a cell's files by name, call its kind's
driver, reduce what it measured to the cell's metrics, decide `correct`,
and print the result line.

A cell is found through ``BENCHMARK.json``: its ``workloads`` entry names
the configuration (whose ``file`` is read) and the cell's own file is
``gpubench/workloads/<cell>.json``, whose ``kind`` names the driver
``gpubench/kinds/<kind>.py``.  Each per-layer metric is the reader
``gpubench/metrics/<metric>.py``.  Adding a cell, a configuration, a
kind or a metric is adding files and ``BENCHMARK.json`` entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent  # gpubench/
# top-level modules the run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


@dataclasses.dataclass
class Cell:
    """One cell's files, read: its ``BENCHMARK.json`` entry, the
    configuration and the cell file, and the metric entries it reports."""

    name: str
    entry: Dict
    config: Dict
    spec: Dict  # the cell file: kind, traffic parameters, limits
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def kind(self) -> str:
        return self.spec["kind"]


@dataclasses.dataclass
class RunContext:
    """What a driver gets: the cell, the run's arguments, the device, the
    process start on the host clock, and (for the control script and
    tests only) a fault to plant."""

    cell: Cell
    root: Path
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    fault: Optional[str] = None
    log: Callable[[str], None] = lambda msg: print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class DriverResult:
    """What a driver returns.  ``end_to_end`` holds every end-to-end value
    the kind measures, by metric name; ``trace`` the traced run's
    reduction (``gbench.trace.TraceRecord``) with the kind's own facts
    (launch bounds, FLOPs) for the metric readers; ``checks`` each number
    compared as ``{name: (value, limit)}``."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    memory_peak_bytes: int
    checks: Dict[str, tuple]
    trace: Any = None


def benchmark_json(root: Path) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _listed(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` with its files."""
    bench = benchmark_json(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[entry["config"]]["file"]) as f:
        config = json.load(f)
    with open(BENCH_DIR / "workloads" / f"{name}.json") as f:
        spec = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _listed(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _listed(m, name) and m["moves"] in e2e_names]
    return Cell(name, entry, config, spec, e2e, per_layer)


def load_file(path: Path, name: str) -> ModuleType:
    """Import the module at ``path`` (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str) -> ModuleType:
    """The driver module of ``kind``: ``gpubench/kinds/<kind>.py``."""
    return load_file(BENCH_DIR / "kinds" / f"{kind}.py", f"gpubench_kind_{kind}")


def metric_reader(name: str) -> ModuleType:
    """The reader of per-layer metric ``name``: ``gpubench/metrics/<name>.py``."""
    return load_file(BENCH_DIR / "metrics" / f"{name}.py",
                     "gpubench_metric_" + name.replace(".", "_"))


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names in ``sys.modules`` (whole names, the part before
    the first dot) that the run must not have loaded."""
    mods = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in mods}
    return sorted(t for t in tops if t in FORBIDDEN)


def metrics(cell: Cell, res: DriverResult, trace: bool, log) -> Dict[str, Dict]:
    """The cell's reported metrics: its end-to-end metrics from the
    driver (untraced run), or its per-layer metrics from their readers
    (traced run); a reader that finds nothing leaves its metric out."""
    out: Dict[str, Dict] = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] not in res.end_to_end:
                raise RuntimeError(f"kind {cell.kind!r} measured no {m['name']}")
            out[m["name"]] = {"value": float(res.end_to_end[m["name"]]), "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        value = metric_reader(m["name"]).read(res.trace)
        if value is None:
            log(f"metric {m['name']}: nothing to read, left out")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(cell: Cell, res: DriverResult, trace: bool, device_info: Dict,
                log) -> Dict:
    """The result object; ``checks`` comes last."""
    checks = {k: {"value": float(v), "limit": float(lim)} for k, (v, lim) in res.checks.items()}
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": correct, "attempted": int(res.attempted), "failed": int(res.failed),
            "metrics": metrics(cell, res, trace, log), "device": dict(device_info)}
    line["device"]["memory_peak_bytes"] = int(res.memory_peak_bytes)
    if trace and res.trace is not None:
        line["device"]["busy_s"] = float(res.trace.busy_s)
        line["device"]["window_s"] = float(res.trace.window_s)
        line["breakdown"] = res.trace.breakdown()
    line["checks"] = checks
    return line
