"""Run one cell of the port's benchmark once and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout of the repository.  The run needs as many
CUDA cards as the cell asks for and exits non-zero, printing no result,
without them.  Set-up (inputs, weights, the program's set-up, warm steps)
is timed from the start of this process to the start of the measured
window; the window lasts ``--seconds``; the comparison with the plain
reference runs after it.  The last line of standard output is the result
object; the numbers compared, each with its limit, are the last lines of
standard error.  Kernel builds and caches stay under ``build/`` in the
checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def _environment() -> None:
    """Fixed cache directories inside the checkout, few host threads."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "4")
    for p in (str(BENCH_DIR), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from gbench import harness

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    cell = harness.load_cell(ROOT, args.workload)
    import torch

    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    ctx = harness.RunContext(cell=cell, root=ROOT, seed=args.seed, seconds=args.seconds,
                             trace=bool(args.trace), device="cuda", t_start=T_START, log=log)
    res = harness.driver(cell.kind).run(ctx)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    line = harness.result_line(cell, res, ctx.trace, info, log)
    found = harness.forbidden_modules()
    if found:
        log(f"the run loaded {found}: the benchmark may not import JAX or the JAX package")
        return 3
    for name, c in line["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})"
            f" {'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # the run's boundary: report, print no result
        traceback.print_exc()
        code = 1
    sys.exit(code)
