"""Shared set-up of the benchmark's own tests: the harness's directories
on ``sys.path`` and small copies of the cells for the CPU.

Run them from the repository root:

    python -m pytest -q gpubench/tests          # CPU
    python -m pytest -q -m cuda gpubench/tests  # on the card
"""
import copy
import sys
import time
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
for p in (str(BENCH_DIR), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# the CPU's first vectorised float op in a fresh process can read wrong
# (see the port's numeric tests): spend it here
import torch  # noqa: E402

torch.exp(torch.zeros(8))
torch.set_num_threads(4)  # the default pool swings a step tenfold on a shared host

# small copies of the cells, for the CPU
SMALL_HGNN = {"scale": 0.1}
SMALL_LM = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                num_experts=4, experts_per_token=2, moe_d_ff=32, padded_vocab=512,
                vocab_size=500, moe_group_size=64)
SMALL_LM_TRAFFIC = dict(batch=2, seq=64)


def small_cell(name: str):
    """The cell ``name`` of the repository's ``BENCHMARK.json`` cut to a
    CPU size: the HGNN graph at scale 0.1, the LM at 2 layers of width
    64, B = 2, S = 64."""
    from gbench import harness

    cell = harness.load_cell(ROOT, name)
    cell = copy.deepcopy(cell)
    if "graph" in cell.config:
        cell.config["graph"].update(SMALL_HGNN)
    else:
        cell.config.update(SMALL_LM)
        cell.spec.update(SMALL_LM_TRAFFIC)
        if "check_requests" in cell.spec:
            cell.spec["check_requests"] = 3
    return cell


def context(cell, seed=2 ** 31 + 17, seconds=0.3, trace=False, fault=None):
    from gbench import harness

    return harness.RunContext(cell=cell, root=ROOT, seed=seed, seconds=seconds, trace=trace,
                              device="cpu", t_start=time.perf_counter(), fault=fault,
                              log=lambda msg: None)


@pytest.fixture
def cuda_card():
    """Skip unless the process sees a CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
