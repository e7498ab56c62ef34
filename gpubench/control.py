"""Readings that a cell's correctness limits are set from (not run by
``run.py``): for each seed, the program's numbers against the plain
reference, the control's (the reference in the program's place at the
next lower precision) and each planted fault's, from one process.

    python3 gpubench/control.py --workload <cell> --seeds 1 2 3 ... \\
        [--fault-seeds 3] [--out chiprun_out/control.jsonl]

The controls and the faults are the kind's own (its ``calibrate``) and
run on the first ``--fault-seeds`` seeds (3 by default).  Each seed's
readings are one JSON line on standard output (and in ``--out``).  Run
on the card, at the cell's own size.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH_DIR), str(ROOT / "src")]
    from gbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    drv = harness.driver(cell.kind)
    out = open(args.out, "a") if args.out else None
    try:
        for i, seed in enumerate(args.seeds):
            kw = {} if i < args.fault_seeds else {"controls": (), "fault_list": ()}
            ctx = harness.RunContext(cell=cell, root=ROOT, seed=seed, seconds=0.0, trace=False,
                                     device="cuda", t_start=time.perf_counter())
            t0 = time.perf_counter()
            rec = {"workload": args.workload, "seed": seed, **drv.calibrate(ctx, **kw),
                   "seconds": time.perf_counter() - t0}
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
