"""The port stands alone: importing every ``repro_torch`` module (or
``chip_smoke.py``) loads neither JAX nor the JAX package, and a CUDA
session refuses to start without a CUDA device instead of running on the
CPU."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
bad = sorted(k for k in sys.modules
             if k in ("jax", "repro") or k.startswith(("jax.", "repro.")))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_import_closure_is_free_of_jax_and_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, env=env, timeout=100, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for mod in ("repro_torch.api.session", "repro_torch.api.spec",
                "repro_torch.core.hgnn.models", "repro_torch.core.restructure",
                "repro_torch.core.sgb", "repro_torch.hetero.datasets",
                "repro_torch.kernels.seg_sum", "repro_torch.kernels.edge_softmax",
                "repro_torch.kernels.ops", "repro_torch.kernels.cuda_build",
                "repro_torch.kernels.spgemm_bsr",
                "repro_torch.kernels.flash_attention", "repro_torch.kernels.ssd_scan",
                "repro_torch.models.config", "repro_torch.models.layers",
                "repro_torch.models.lm", "repro_torch.configs",
                "repro_torch.configs.smollm_135m", "repro_torch.configs.mamba2_370m",
                "repro_torch.serve.engine", "repro_torch.launch.serve",
                "repro_torch.core.subgraph", "repro_torch.serve",
                "repro_torch.serve.hgnn", "repro_torch.serve.faults",
                "repro_torch.pipeline.frontend", "repro_torch.pipeline.cache",
                "repro_torch.hetero.delta", "repro_torch.train",
                "repro_torch.train.optim", "repro_torch.train.hgnn_step",
                "repro_torch.train.checkpoint", "repro_torch.train.tree",
                "repro_torch.distributed", "repro_torch.distributed.hgnn",
                "repro_torch.launch.mesh", "repro_torch.core.buffersim",
                "repro_torch.train.train_step", "repro_torch.train.data",
                "repro_torch.train.compress", "repro_torch.train.fault_tolerance",
                "repro_torch.train._lm_pspecs", "repro_torch.launch.train",
                "repro_torch.kernels.cp_attention", "repro_torch.launch.dryrun"):
        assert mod in res["imported"]


def test_chip_smoke_is_free_of_jax_and_repro():
    """``chip_smoke.py`` runs where JAX may be absent: none of its imports,
    at module level or inside a phase, names ``jax`` or ``repro``, and
    importing it loads neither."""
    path = SRC.parent / "chip_smoke.py"
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots and not roots & {"jax", "repro"}
    probe = ("import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
             "print(json.dumps(sorted(k for k in sys.modules "
             "if k.split('.')[0] in ('jax', 'repro'))))")
    out = subprocess.run([sys.executable, "-c", probe, str(path.parent)],
                         capture_output=True, text=True, timeout=100, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_cuda_session_raises_without_cuda(monkeypatch):
    from repro_torch.api import ExecutorSpec, Session

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session(ExecutorSpec(na_executor="banded"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session()  # the default device is "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session(ExecutorSpec(sgb_backend="device"))  # no CPU fallback for SGB
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session(ExecutorSpec(na_executor="jnp"))  # nor for the segment-sum executor
    Session(ExecutorSpec(na_executor="banded", device="cpu"))  # explicit CPU runs


def test_cuda_session_raises_here_when_no_card():
    """On a machine without a card the default spec refuses to start."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.api import ExecutorSpec, Session

    with pytest.raises(RuntimeError):
        Session(ExecutorSpec(na_executor="banded"))
