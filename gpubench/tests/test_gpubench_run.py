"""The command as the driver runs it: no result without a card, none in a
checkout that holds only the benchmark, and (on the card) one cell's
whole run."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import BENCH_DIR, ROOT

CMD = ["gpubench/run.py", "--workload", "shgn-dblp.train", "--seed", "4294967311",
       "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, *CMD], cwd=cwd, capture_output=True, text=True,
                          timeout=900, env=env)


def test_without_a_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this process sees a card")
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_one_cell_runs_on_the_card(cuda_card):
    out = _run(ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert set(line["metrics"]) == {"setup_s", "hgnn_epoch_ms"}
