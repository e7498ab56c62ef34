"""Adding a cell, a configuration and a per-layer metric is adding files
and ``BENCHMARK.json`` entries: the harness finds them by name, and no
file it already has changes."""
import hashlib
import json
import shutil
import subprocess
import sys

from conftest import BENCH_DIR, ROOT

NEW_METRIC = '''"""Profiled steps of the traced window (an example reader)."""


def read(rec):
    return rec.steps
'''

SCRIPT = """
import json, sys, time
root = sys.argv[1]
sys.path[:0] = [root + "/gpubench", {src!r}]
from pathlib import Path
from gbench import harness
cell = harness.load_cell(Path(root), "shgn-small.train")
ctx = harness.RunContext(cell=cell, root=Path(root), seed=3, seconds=0.2, trace=True,
                         device="cpu", t_start=time.perf_counter(), log=lambda m: None)
res = harness.driver(cell.kind).run(ctx)
line = harness.result_line(cell, res, True, {{"platform": "cpu", "kind": "cpu", "count": 1}},
                           lambda m: None)
print(json.dumps({{"per_layer": [m["name"] for m in cell.per_layer], "line": line}}))
"""


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_config_and_metric_are_files_only(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "gpubench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = _digests(tmp_path / "gpubench")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH_DIR / "configs" / "shgn-dblp.json").read_text())
    cfg["name"], cfg["graph"]["scale"] = "shgn-small", 0.1
    (tmp_path / "gpubench" / "configs" / "shgn-small.json").write_text(json.dumps(cfg))
    spec = json.loads((BENCH_DIR / "workloads" / "shgn-dblp.train.json").read_text())
    spec["trace_steps"] = 1
    (tmp_path / "gpubench" / "workloads" / "shgn-small.train.json").write_text(json.dumps(spec))
    (tmp_path / "gpubench" / "metrics" / "steps_profiled.hgnn_train.py").write_text(NEW_METRIC)
    bench["configs"].append({"name": "shgn-small", "source": "a test", "file":
                             "gpubench/configs/shgn-small.json", "reduced": ["scale"], "why": "test"})
    bench["workloads"].append({"name": "shgn-small.train", "config": "shgn-small",
                               "traffic": "train", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "hgnn_epoch_ms":
            m["workloads"].append("shgn-small.train")
    bench["per_layer"].append({"name": "steps_profiled.hgnn_train", "unit": "steps",
                               "better": "higher", "source": "device_trace", "layer": "device",
                               "moves": "hgnn_epoch_ms", "workloads": ["shgn-small.train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run([sys.executable, "-c", SCRIPT.format(src=str(ROOT / "src")),
                          str(tmp_path)], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["per_layer"] == ["steps_profiled.hgnn_train"]
    assert got["line"]["metrics"]["steps_profiled.hgnn_train"]["value"] == 1
    assert got["line"]["correct"] is True, got["line"]["checks"]
    after = _digests(tmp_path / "gpubench")
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"configs/shgn-small.json", "workloads/shgn-small.train.json",
                                        "metrics/steps_profiled.hgnn_train.py"}
