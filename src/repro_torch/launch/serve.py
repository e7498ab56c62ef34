"""LM serving command line: continuous-batching decode over random-weight
models, any architecture but the encoder (hubert-xlarge has no decode
path); qwen2-vl-7b serves from tokens, its M-RoPE positions the same on
all three components.

Runs on the card by default, at the configuration's full width::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b

and on the CPU at reduced width (the plain versions of the kernels)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --reduced --device cpu --requests 6 --slots 4 --max-new 8
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models.lm import LM
from repro_torch.serve.engine import Request, ServeEngine


def make_requests(vocab_size: int, n: int, prompt_len: int, max_new: int,
                  seed: int = 0) -> List[Request]:
    """``n`` requests; the even ones share a prompt prefix (prefix-grouping
    showcase) and diverge at the last token."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab_size, prompt_len)
    reqs = []
    for i in range(n):
        if i % 2 == 0:
            prompt = shared.copy()
            prompt[-1] = i  # diverge at the last token
        else:
            prompt = rng.integers(0, vocab_size, prompt_len)
        reqs.append(Request(rid=i, prompt=prompt.astype(np.int32), max_new=max_new))
    return reqs


def serve(arch: str, device: str = "cuda", use_reduced: bool = False,
          requests: int = 6, slots: int = 4, max_new: int = 8, prompt_len: int = 6,
          max_len: int = 64, group_prefixes: bool = True, seed: int = 0,
          params: Optional[Dict] = None):
    """Serve ``requests`` seeded requests (``params`` default to the
    model's init from ``seed``); ``(done, seconds, model)`` with ``done =
    {rid: tokens}`` and the wall time of the run (ended by a device
    sync)."""
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    if cfg.family == "encoder":
        raise ValueError(f"{arch} is an encoder: it has no decode path")
    model = LM(cfg, device=device, remat="none")
    if params is None:
        params = model.init(seed)
    engine = ServeEngine(model, params, batch_slots=slots, max_len=max_len,
                         group_prefixes=group_prefixes)
    reqs = make_requests(cfg.vocab_size, requests, prompt_len, max_new, seed)
    t0 = time.perf_counter()
    done = engine.run(reqs, max_steps=max_new * requests + 8)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    return done, time.perf_counter() - t0, model


def main(argv: Optional[Sequence[str]] = None):
    """Parse the command line, serve, print every request's tokens and the
    throughput."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=6)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--no-prefix-grouping", action="store_true")
    args = ap.parse_args(argv)

    done, dt, model = serve(
        args.arch, device=args.device, use_reduced=args.reduced,
        requests=args.requests, slots=args.slots, max_new=args.max_new,
        prompt_len=args.prompt_len, max_len=args.max_len,
        group_prefixes=not args.no_prefix_grouping)
    for rid in sorted(done):
        print(f"req {rid}: {done[rid]}")
    total_toks = sum(len(v) for v in done.values())
    print(f"served {len(done)} requests, {total_toks} tokens in {dt:.1f}s "
          f"({total_toks / max(dt, 1e-9):.1f} tok/s) on {model.device}")


if __name__ == "__main__":
    main()
