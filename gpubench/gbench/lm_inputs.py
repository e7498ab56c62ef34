"""Inputs of the LM cells, made by the benchmark from the seed on the
device and handed to the port and to the reference alike: the parameter
tree of an ``("attn", "moe")`` stack with the port's keys, shapes and
dtypes, and token batches."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def params(cfg: Dict, seed: int, device) -> Dict:
    """Weights normal times 0.02 (output projections times ``0.02 /
    sqrt(2 L)``), norms 1, one ``randn`` a leaf (leaves are stacked over
    the layers), in the dtypes the port serves them in: bf16 weights, the
    router's bf16 values held in float32, float32 norms."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    L, d = cfg["num_layers"], cfg["d_model"]
    hq, hkv, dh = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    e, f = cfg["num_experts"], cfg["moe_d_ff"]
    deep = 0.02 / max(1.0, (2 * L) ** 0.5)

    def w(shape, scale=0.02):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    block = {
        "ln1": ones(L, d), "ln2": ones(L, d),
        "mixer": {"wq": w((L, d, hq * dh)), "wk": w((L, d, hkv * dh)),
                  "wv": w((L, d, hkv * dh)), "wo": w((L, hq * dh, d), deep)},
        "ffn": {"w_router": w((L, d, e)).float(), "w_gate": w((L, e, d, f)),
                "w_up": w((L, e, d, f)), "w_down": w((L, e, f, d), deep)},
    }
    return {"embed": w((cfg["padded_vocab"], d)), "final_norm": ones(d), "blocks": [block]}


class TokenStream:
    """Batches of ``(tokens, targets)`` (int32, targets shifted by one),
    each row new, drawn in order from one generator seeded with the run's
    seed on the device; ``restart`` replays the stream from its start."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int, device):
        self.vocab, self.batch, self.seq, self.seed, self.device = vocab, batch, seq, seed, device
        self.restart()

    def restart(self) -> None:
        self.gen = torch.Generator(device=self.device).manual_seed(int(self.seed) + 7)

    def next(self) -> Tuple[torch.Tensor, torch.Tensor]:
        t = torch.randint(0, self.vocab, (self.batch, self.seq + 1), generator=self.gen,
                          device=self.device, dtype=torch.int32)
        return t[:, :-1], t[:, 1:]

    def take(self, n: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        return [self.next() for _ in range(n)]
