"""The port's public surface covers the JAX package's, name by name.

Both source trees are parsed as text with ``ast`` (nothing is imported).
A public name of ``src/repro`` is a module-level function or class whose
name does not start with ``_``, and each public method, property or
dataclass field of such a class (``__init__`` included).  Each one needs a
counterpart in the same module of ``src/repro_torch`` (under its own name
or the one ``RENAMED`` gives), or an entry in ``OMITTED`` with its reason.
Each keyword argument of a reference signature must be taken by its
same-named counterpart, unless ``OMITTED_ARGS`` lists it with its reason
(a renamed counterpart takes other inputs by design).

The audit table in ``ROADMAP.md`` (queue 1) is this file's rendering, so
the two cannot drift: ``python tests/test_torch_surface.py`` prints it.
"""
import ast
from pathlib import Path
from typing import Dict, Optional, Tuple

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_DEVICE = "the tensor's device picks the implementation (CUDA kernel or plain version)"
_XLA_SHARDING = "an XLA sharding constraint; the port's ranks hold whole tensors"
_RAW_BLOCKS = ("the shard_map entry over raw block arrays; the port's sharded executor "
               "builds merged PackedEdges streams (distributed.hgnn.merged_stream) "
               "and calls the PackedEdges entry")
_LOWERING = ("XLA lowering and compile of a dry-run cell; the port counts on meta "
             "tensors (roofline_cell)")

# reference name -> the port's counterpart under another name
RENAMED: Dict[str, str] = {
    "kernels.seg_sum.banded_matvec_vjp": "kernels.seg_sum.BandedMatvec",
    "kernels.ops.attention_packed_vjp": "kernels.ops.AttentionPacked",
    "kernels.seg_sum.PackedEdges.device_edge_map":
        "kernels.seg_sum.PackedEdges.device_blocked",
    "kernels.seg_sum.PackedEdges.device_flat_edges":
        "kernels.seg_sum.PackedEdges.device_blocked",
    "launch.dryrun.collective_bytes": "launch.dryrun.collective_bytes_analytic",
}

# reference name (or whole module) -> why the port has no counterpart
OMITTED: Dict[str, str] = {
    "kernels.ref": "its oracles sit beside each kernel as its plain version",
    "api.spec.ExecutorSpec.kernel_backend": _DEVICE,
    "api.spec.ExecutorSpec.na_kernel_backend": _DEVICE,
    "pipeline.frontend.PipelineConfig.kernel_backend": _DEVICE,
    "kernels.ops.constrain_batch": _XLA_SHARDING,
    "kernels.ops.constrain_vocab": _XLA_SHARDING,
    "kernels.seg_sum.seg_sum_blocks": _RAW_BLOCKS,
    "kernels.edge_softmax.edge_softmax_stats_blocks": _RAW_BLOCKS,
    "launch.dryrun.input_specs": _LOWERING,
    "launch.dryrun.build_cell_fn": _LOWERING,
    "launch.dryrun.lower_compile": _LOWERING,
}

# keyword argument, anywhere ("*") or of one reference name -> why the
# port's counterpart does not take it
OMITTED_ARGS: Dict[Tuple[str, str], str] = {
    ("*", "backend"): _DEVICE,
    ("*", "interpret"): _DEVICE,
    ("*", "kernel_backend"): _DEVICE,
    ("*", "key"): "a JAX PRNG key; the port takes an integer seed (torch.Generator)",
    ("*", "na_backend"): "the reference's older name of na_executor, which the port takes",
    ("models.lm.LM.__init__", "unroll_layers"): "it only serves XLA cost analysis",
    ("train.data.SyntheticTokens.sharded_batch", "pspec"):
        "a JAX PartitionSpec; the port shards over its mesh's ranks",
    ("kernels.flash_attention.flash_attention", "bq"):
        "K4's tiles are fixed per head-dim pair (flash_attention.kernel_pair)",
    ("kernels.flash_attention.flash_attention", "bk"):
        "K4's tiles are fixed per head-dim pair (flash_attention.kernel_pair)",
    ("kernels.ops.attention", "bq"):
        "K4's tiles are fixed per head-dim pair (flash_attention.kernel_pair)",
    ("kernels.ops.attention", "bk"):
        "K4's tiles are fixed per head-dim pair (flash_attention.kernel_pair)",
    ("kernels.ops.na_attention_packed", "dst"): "unused in the reference (del dst)",
    ("core.subgraph.na_mean_subset_banded", "packed"):
        "the slice's own PackedEdges rides in dg['packed']",
    ("core.subgraph.na_attention_subset_banded", "packed"):
        "the slice's own PackedEdges rides in dg['packed']",
    ("distributed.hgnn.ShardedHGNNExecutor.__init__", "mesh"):
        "a JAX Mesh; the port's ranks are its devices argument",
}


def _args(fn) -> Tuple[str, ...]:
    a = fn.args
    return tuple(x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
                 if x.arg not in ("self", "cls"))


def modules(package: str) -> Dict[str, Path]:
    """Module name relative to the package -> its file."""
    out = {}
    root = SRC / package
    for path in sorted(root.rglob("*.py")):
        parts = path.relative_to(root).with_suffix("").parts
        out[".".join(parts[:-1] if parts[-1] == "__init__" else parts) or package] = path
    return out


def surface(package: str) -> Dict[str, Optional[Tuple[str, ...]]]:
    """Public name -> its argument names (None for a class or a field),
    keyed ``module.name`` or ``module.Class.member`` relative to the
    package."""
    out: Dict[str, Optional[Tuple[str, ...]]] = {}
    for mod, path in modules(package).items():
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not node.name.startswith("_"):
                    out[f"{mod}.{node.name}"] = _args(node)
            elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
                out[f"{mod}.{node.name}"] = None
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        if not sub.name.startswith("_") or sub.name == "__init__":
                            out[f"{mod}.{node.name}.{sub.name}"] = _args(sub)
                    elif (isinstance(sub, ast.AnnAssign) and isinstance(sub.target, ast.Name)
                          and not sub.target.id.startswith("_")):
                        out[f"{mod}.{node.name}.{sub.target.id}"] = None
    return out


def _omission(name: str) -> Optional[str]:
    for key, why in OMITTED.items():
        if name == key or name.startswith(key + "."):
            return why
    return None


def _arg_omission(name: str, arg: str) -> Optional[str]:
    return OMITTED_ARGS.get((name, arg)) or OMITTED_ARGS.get(("*", arg))


def audit():
    """``(rows, missing, missing_args)``: per reference name its port
    counterpart or the reason it has none, and what the port lacks."""
    ref, port = surface("repro"), surface("repro_torch")
    rows, missing, missing_args = [], [], []
    for name, args in ref.items():
        why = _omission(name)
        if why is not None:
            rows.append((name, None, why))
            continue
        twin = RENAMED.get(name, name)
        if twin not in port:
            missing.append(name)
            continue
        rows.append((name, twin, None))
        if twin == name and args is not None and port[twin] is not None:
            for arg in args:
                if arg not in port[twin] and _arg_omission(name, arg) is None:
                    missing_args.append((name, arg))
    return rows, missing, missing_args


def render_table() -> str:
    """The audit as a markdown table, one row per reference module."""
    rows, _, _ = audit()
    by_mod: Dict[str, list] = {}
    # longest module path first, so a name binds to its own module
    mods = sorted(modules("repro"), key=lambda m: -m.count("."))
    for name, twin, why in rows:
        mod = next(m for m in mods if name.startswith(m + ".")
                   and name[len(m) + 1:].count(".") <= 1)
        by_mod.setdefault(mod, []).append((name[len(mod) + 1:], twin, why))
    lines = ["| `repro` module | names, with their `repro_torch` counterpart where it is "
             "named otherwise, or the reason there is none |", "|---|---|"]
    for mod, items in sorted(by_mod.items()):
        cells = []
        for short, twin, why in items:
            if why is not None:
                cells.append(f"`{short}`: none, {why}")
            elif twin != f"{mod}.{short}":
                cells.append(f"`{short}` → `{twin}`")
            else:
                cells.append(f"`{short}`")
        lines.append(f"| `{mod}` | " + ", ".join(cells) + " |")
    args = sorted(OMITTED_ARGS.items())
    lines += ["", "| keyword argument (`*`: of every signature) | why the port does "
              "not take it |", "|---|---|"]
    lines += [f"| `{name}({arg}=)` | {why} |" if name != "*" else f"| `*({arg}=)` | {why} |"
              for (name, arg), why in args]
    return "\n".join(lines)


def test_every_reference_name_has_a_counterpart_or_a_reason():
    _, missing, _ = audit()
    assert missing == []


def test_every_reference_keyword_is_taken_or_has_a_reason():
    _, _, missing_args = audit()
    assert missing_args == []


@pytest.mark.parametrize("table", ["RENAMED", "OMITTED", "OMITTED_ARGS"])
def test_allow_lists_hold_no_stale_entry(table):
    """Every entry names something the reference has, and every renamed
    counterpart exists in the port."""
    ref, port = surface("repro"), surface("repro_torch")
    mods = modules("repro")
    if table == "RENAMED":
        for name, twin in RENAMED.items():
            assert name in ref and twin in port, (name, twin)
    elif table == "OMITTED":
        for name in OMITTED:
            assert name in ref or name in mods, name
    else:
        for name, arg in OMITTED_ARGS:
            if name == "*":
                assert any(a is not None and arg in a for a in ref.values()), arg
            else:
                assert arg in (ref[name] or ()), (name, arg)


def test_roadmap_holds_the_audit_table():
    """``ROADMAP.md`` queue 1 carries this audit verbatim, reasons
    included."""
    assert render_table() in (ROOT / "ROADMAP.md").read_text()


def test_guard_catches_a_missing_name_and_a_missing_keyword(monkeypatch):
    """A counterpart taken away, or one of its keywords dropped, fails the
    guard."""
    port = surface("repro_torch")
    gone = dict(port)
    del gone["hetero.graph.HetGraph.enumerate_metapaths"]
    gone["train.hgnn_step.make_train_step"] = tuple(
        a for a in port["train.hgnn_step.make_train_step"] if a != "clip_norm")
    real = surface
    monkeypatch.setitem(globals(), "surface",
                        lambda pkg: gone if pkg == "repro_torch" else real(pkg))
    _, missing, missing_args = audit()
    assert missing == ["hetero.graph.HetGraph.enumerate_metapaths"]
    assert missing_args == [("train.hgnn_step.make_train_step", "clip_norm")]


if __name__ == "__main__":
    print(render_table())
