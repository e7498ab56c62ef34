"""LM training from the command line: the JAX package's
``repro.launch.train`` on the port (the same flags, ``--device`` in place
of ``--backend``).

Examples::

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --steps 10
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --reduced \\
      --steps 20 --batch 8 --seq 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
      --reduced --steps 10 --compress --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.lm import LM
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import SyntheticTokens
from repro_torch.train.fault_tolerance import FaultTolerantRunner
from repro_torch.train.optim import warmup_cosine
from repro_torch.train.train_step import build_train_step, init_train_state


def main(argv: Optional[Sequence[str]] = None):
    """Parse ``argv`` (default ``sys.argv[1:]``), train, print the summary
    line; returns ``(final state, RunnerStats)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", action="store_true",
                    help="error-feedback int8 gradient compression")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = LM(cfg, device=args.device, remat="none")
    mesh = make_debug_mesh(1, 1, device=args.device)

    state = init_train_state(model, 0, use_compression=args.compress)
    step_fn, specs = build_train_step(
        model, mesh, args.batch,
        lr=warmup_cosine(args.lr, warmup=5, total=args.steps),
        microbatches=args.microbatches,
        use_compression=args.compress,
    )
    data = SyntheticTokens(cfg.vocab_size, args.seq, args.batch)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)

    def data_fn(step):
        tok, tgt = data.host_batch(step)
        return (torch.from_numpy(tok).to(model.device), torch.from_numpy(tgt).to(model.device))

    runner = FaultTolerantRunner(step_fn, data_fn, ckpt, ckpt_every=args.ckpt_every)
    t0 = time.time()
    state, stats = runner.run(state, 0, args.steps)
    dt = time.time() - t0
    print(f"arch={cfg.name} steps={stats.steps_done} "
          f"final_loss={stats.last_loss:.4f} failures={stats.failures} "
          f"stragglers={stats.stragglers} wall={dt:.1f}s "
          f"({dt / max(1, stats.steps_done):.2f}s/step)")
    return state, stats


if __name__ == "__main__":
    main()
