"""The port's dry run (``launch/dryrun.py``) on the CPU against the JAX
package's.

The reference's ``_microbatches``, ``_analytic_adamw`` and
``analytic_hbm_bytes`` need only a mesh's shape, so they run on a stand-in
mesh, with no JAX compile.  They are taken from the reference's source by
name: importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host
devices, which must not reach this process's JAX.  Also: the G = 1 / G = 2
extrapolation of the FLOP count against a direct count at a config's full
depth, and the CLI writing its JSON on the CPU.
"""
import ast
import dataclasses
import json
import types
from pathlib import Path
from typing import Dict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import Mesh as RefMesh  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.models.config import ArchConfig as RefArchConfig  # noqa: E402
from repro.models.config import ShapeSpec as RefShapeSpec  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeSpec  # noqa: E402

REF_SOURCE = Path(__file__).resolve().parents[1] / "src" / "repro" / "launch" / "dryrun.py"
VERBATIM = ("_microbatches", "_analytic_adamw", "analytic_hbm_bytes")
MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 1, "model": 1}]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these small ops: under the suite's parallel
    workers a thread pool a process oversubscribes the cores and each small
    op waits on its pool (restored after each test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_functions() -> Dict:
    """The reference's functions of ``VERBATIM``, executed from its source
    in a namespace of their own."""
    tree = ast.parse(REF_SOURCE.read_text())
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in VERBATIM]
    ns = {"np": np, "Dict": Dict, "Mesh": RefMesh, "ArchConfig": RefArchConfig,
          "ShapeSpec": RefShapeSpec}
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(REF_SOURCE), "exec"), ns)
    return {name: ns[name] for name in VERBATIM}


def _stand_in(shape: dict):
    return types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


@pytest.mark.parametrize("mesh_shape", MESHES, ids=["16x16", "2x16x16", "1x1"])
def test_verbatim_functions_equal_the_reference_for_every_cell(mesh_shape):
    ref = _reference_functions()
    mesh = _stand_in(mesh_shape)
    n = 0
    for name, rcfg in sorted(ref_configs.ARCHS.items()):
        pcfg = configs.get_config(name)
        assert dryrun._analytic_adamw(pcfg) == ref["_analytic_adamw"](rcfg)
        for rspec in ref_configs.cells(rcfg):
            pspec = SHAPES[rspec.name]
            mb = ref["_microbatches"](rcfg, rspec, mesh)
            assert dryrun._microbatches(pcfg, pspec, mesh) == mb
            for cache in (0.0, 3.5e9):
                assert dryrun.analytic_hbm_bytes(pcfg, pspec, mesh, mb, cache) == \
                    ref["analytic_hbm_bytes"](rcfg, rspec, mesh, mb, cache)
            n += 1
    assert n == sum(len(configs.cells(c)) for c in configs.ARCHS.values()) == 31


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", ["smollm-135m", "granite-moe-1b-a400m", "mamba2-370m",
                                  "jamba-v0.1-52b"])
def test_extrapolated_flop_count_equals_a_direct_count(name, kind):
    """X(1) + (G - 1)(X(2) - X(1)) at G = 3 against the count at 3 groups,
    on a reduced config (meta tensors: no memory)."""
    cfg = configs.reduced(configs.get_config(name))
    cfg = dataclasses.replace(cfg, num_layers=3 * len(cfg.block_pattern))
    spec = ShapeSpec("t", 128, 2, kind)
    x1, x2, x3 = (dryrun.count_flops(cfg, spec, g, 2) for g in (1, 2, 3))
    assert x1 > 0 and x2 > x1
    assert x1 + 2 * (x2 - x1) == x3


def test_state_bytes_follow_the_partition_specs():
    """On a 1 x 1 mesh a rank holds every leaf whole; on 16 x 16 each leaf
    shrinks by its shard count."""
    cfg = configs.get_config("smollm-135m")
    whole = dryrun.state_bytes_per_rank(cfg, dryrun.meta_mesh(shape=(1, 1)))
    sharded = dryrun.state_bytes_per_rank(cfg, dryrun.meta_mesh())
    from repro_torch.models.lm import init_params
    from repro_torch.train import tree_leaves

    leaves = tree_leaves(init_params(0, cfg, device="meta"))
    assert whole["params"] == sum(x.numel() * x.element_size() for x in leaves)
    assert whole["moments"] == 8 * sum(x.numel() for x in leaves)
    assert whole["grad_accumulator"] == 4 * sum(x.numel() for x in leaves)
    # every matrix shards over 'model' or 'data' (x16) or both (x256)
    assert whole["params"] / 256 <= sharded["params"] < whole["params"] / 16


@pytest.mark.parametrize("mb", [1, 2, 4])
def test_collective_bytes_are_a_hand_count(mb):
    """Reduced smollm (B 8, S 32) and granite-moe (B 8, S 64), D 64, two
    layer groups.  On a (1, 2) mesh no leaf is split over a data axis, so
    only the 'model' collectives remain.  A pass carries one microbatch,
    T / mb tokens of 2 D bytes, and a train step makes 3 mb passes, so the
    activation terms are the same at every mb:

      * all-reduce (ring over 2 sends its result once): 3 mb passes x
        (layers' sharded out-projections + the embedding) x T / mb x 2 D:
        smollm 3 x (2 x 2 + 1) x 256 x 128 = 491,520; granite, whose FFN is
        MoE, 3 x (2 + 1) x 512 x 128 = 589,824;
      * all-to-all (ring over 2 sends half): 2 a pass x 3 mb passes x 2
        layers x T / mb x top-2 x 1.25 x 2 D / 2 = 983,040 for granite.

    On (2, 2) the weights' all-gathers and the gradients' reduce-scatters
    happen once a pass and once a microbatch: they grow as mb."""
    want = {"smollm-135m": (32, 491_520, 0), "granite-moe-1b-a400m": (64, 589_824, 983_040)}
    for name, (seq, all_reduce, all_to_all) in want.items():
        cfg = configs.reduced(configs.get_config(name))
        spec = ShapeSpec("t", seq, 8, "train")
        got = dryrun.collective_bytes_analytic(cfg, spec, dryrun.meta_mesh(shape=(1, 2)), mb)
        assert got == {"all-gather": 0.0, "all-reduce": all_reduce, "reduce-scatter": 0.0,
                       "all-to-all": all_to_all, "collective-permute": 0.0}
        one, this = (dryrun.collective_bytes_analytic(cfg, spec, dryrun.meta_mesh(shape=(2, 2)), m)
                     for m in (1, mb))
        assert this["all-gather"] == mb * one["all-gather"] > 0
        assert this["reduce-scatter"] == mb * one["reduce-scatter"] > 0
        assert this["all-to-all"] == one["all-to-all"] == all_to_all / 2


@pytest.mark.parametrize("calibrate", [False, True])
def test_cli_writes_the_cell_on_the_cpu(tmp_path, calibrate):
    args = ["--arch", "smollm-135m", "--shape", "train_4k", "--out", str(tmp_path)]
    dryrun.main(args + ([] if calibrate else ["--no-calibrate"]))
    res = json.loads((tmp_path / "smollm-135m_train_4k_single.json").read_text())
    assert res["status"] == "ok" and res["mesh"] == "16x16" and res["chips"] == 256
    assert res["proof"]["microbatches"] == 16
    assert 0 < res["proof"]["peak_hbm_gib_estimate"] < 80
    if calibrate:
        roof = res["roofline"]
        assert res["calibration"]["microbatch_factor"] == 16
        assert roof["flops_per_chip"] > 0 and roof["dominant"] in (
            "t_compute_s", "t_memory_s", "t_collective_s")
        assert roof["t_compute_s"] == roof["flops_per_chip"] / 989e12
        assert roof["t_memory_s"] == roof["hbm_bytes_per_chip_analytic"] / 3.35e12
        assert set(roof["collectives_analytic"]) == set(dryrun._COLLECTIVES)
    else:
        assert "roofline" not in res
    dryrun.main(args + ["--multi-pod"])
    multi = json.loads((tmp_path / "smollm-135m_train_4k_multi.json").read_text())
    assert multi["status"] == "ok" and multi["mesh"] == "2x16x16"
    assert multi["microbatches"] == 8
