"""Small helpers the kind drivers share: device synchronisation, the
window loop, percentiles, and the port's LM configuration built from a
configuration file."""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, List

import torch


def sync(device) -> None:
    """Wait for the device (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0


def fresh_peak(device) -> None:
    """Release cached blocks and restart the peak-memory count."""
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def window(call: Callable[[], None], seconds: float, device) -> tuple:
    """Call ``call`` back to back until ``seconds`` have passed on the host
    clock, then synchronise once: ``(calls, seconds of the window)``."""
    n, t0 = 0, time.perf_counter()
    while True:
        call()
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    return n, time.perf_counter() - t0


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile of all ``values``."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def arch_config(cfg: Dict):
    """The port's ``ArchConfig`` of an attention + MoE configuration file."""
    from repro_torch.models.config import ArchConfig

    return ArchConfig(
        name=cfg["name"], family="moe", num_layers=cfg["num_layers"], d_model=cfg["d_model"],
        num_heads=cfg["num_heads"], num_kv_heads=cfg["num_kv_heads"], head_dim=cfg["head_dim"],
        d_ff=0, vocab_size=cfg["vocab_size"], block_pattern=(tuple(cfg["block"]),),
        num_experts=cfg["num_experts"], experts_per_token=cfg["experts_per_token"],
        moe_d_ff=cfg["moe_d_ff"], rope_theta=cfg["rope_theta"],
        tie_embeddings=cfg["tie_embeddings"], norm_eps=cfg["norm_eps"],
        moe_group_size=cfg["moe_group_size"])
