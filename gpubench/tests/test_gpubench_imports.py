"""What the benchmark imports, by whole top-level module names (the part
before the first dot): nothing of JAX, of the JAX package or of the old
``benchmarks/``, and, in the reference, nothing of the port."""
import ast
from pathlib import Path

import pytest

from conftest import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value.split(".", 1)[0]


CHIP_FILES = sorted(p for p in BENCH_DIR.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", CHIP_FILES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_or_jax_package(path):
    found = set(_imports(path)) & FORBIDDEN
    assert not found, f"{path} imports {found}"


def test_whole_names_are_compared():
    # the port's name begins with the JAX package's: only whole names match
    assert "repro_torch" not in FORBIDDEN and "repro" in FORBIDDEN
    from gbench.harness import forbidden_modules

    assert forbidden_modules({"repro_torch.api": 1, "reprox": 1, "torch": 1}) == []
    assert forbidden_modules({"repro.core.sgb": 1, "jax": 1}) == ["jax", "repro"]


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    found = set(_imports(path)) & (FORBIDDEN | {"repro_torch", "gbench", "tests"})
    assert not found, f"{path} imports {found}"


def test_a_cpu_run_loads_no_jax(tmp_path):
    import subprocess
    import sys

    code = (
        "import sys, time; sys.path[:0] = [{b!r}, {s!r}]\n"
        "from gbench import harness\n"
        "from conftest import context, small_cell\n"
        "ctx = context(small_cell('granite-moe-1b-a400m.prefill_2k'))\n"
        "harness.driver('lm_prefill').run(ctx)\n"
        "print(harness.forbidden_modules())\n"
    ).format(b=str(BENCH_DIR), s=str(BENCH_DIR.parent / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=BENCH_DIR / "tests", timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
