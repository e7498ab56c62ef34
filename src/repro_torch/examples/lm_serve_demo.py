"""Serve a (reduced) LM from the assigned-architecture zoo with batched
requests, continuous batching and prefix-grouped admission.

  python -m repro_torch.examples.lm_serve_demo [--arch gemma2-2b] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.models.lm import LM
from repro_torch.serve.engine import Request, ServeEngine


def requests(cfg) -> list:
    """Six requests of 6 new tokens: three share a 5-token prefix, and
    each prompt ends in its own id."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
    reqs = []
    for i in range(6):
        prompt = shared.copy() if i < 3 else rng.integers(
            0, cfg.vocab_size, 6).astype(np.int32)
        prompt[-1] = i
        reqs.append(Request(rid=i, prompt=prompt, max_new=6))
    return reqs


def main(argv=None, params=None) -> dict:
    """Run the flow; ``params`` replaces the seeded init (``model.init(0)``)
    when given.  Returns the config, the requests and what they generated."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch))
    model = LM(cfg, device=args.device, remat="none")
    if params is None:
        params = model.init(0)
    engine = ServeEngine(model, params, batch_slots=4, max_len=48)

    reqs = requests(cfg)
    done = engine.run(reqs, max_steps=64)
    for rid in sorted(done):
        print(f"req {rid}: generated {done[rid]}")
    print(f"arch={cfg.name} (reduced) served {len(done)} requests")
    return {"cfg": cfg, "requests": reqs, "done": done}


if __name__ == "__main__":
    main()
