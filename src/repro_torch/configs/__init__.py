"""Architecture registry: one module per assigned arch (+ the paper's own).

``get_config(name)`` returns the full published config; ``reduced(cfg)``
shrinks it to a CPU-runnable smoke-test config of the same family/pattern.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import SHAPES, ArchConfig, ShapeSpec

from repro_torch.configs.mamba2_370m import CONFIG as mamba2_370m
from repro_torch.configs.olmoe_1b_7b import CONFIG as olmoe_1b_7b
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as granite_moe_1b_a400m
from repro_torch.configs.minicpm3_4b import CONFIG as minicpm3_4b
from repro_torch.configs.minitron_4b import CONFIG as minitron_4b
from repro_torch.configs.smollm_135m import CONFIG as smollm_135m
from repro_torch.configs.gemma2_2b import CONFIG as gemma2_2b
from repro_torch.configs.hubert_xlarge import CONFIG as hubert_xlarge
from repro_torch.configs.jamba_v01_52b import CONFIG as jamba_v01_52b
from repro_torch.configs.qwen2_vl_7b import CONFIG as qwen2_vl_7b

ARCHS = {
    c.name: c
    for c in [
        mamba2_370m, olmoe_1b_7b, granite_moe_1b_a400m, minicpm3_4b,
        minitron_4b, smollm_135m, gemma2_2b, hubert_xlarge,
        jamba_v01_52b, qwen2_vl_7b,
    ]
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def cells(arch: ArchConfig):
    """The runnable (arch x shape) cells, applying the skip rules
    (DESIGN.md §4): encoder-only archs have no decode; long_500k only for
    sub-quadratic sequence mixing (ssm / hybrid)."""
    out = []
    for spec in SHAPES.values():
        if spec.kind == "decode" and arch.family == "encoder":
            continue
        if spec.name == "long_500k" and arch.family not in ("ssm", "hybrid"):
            continue
        out.append(spec)
    return out


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Family-faithful smoke config: same block pattern, tiny dims."""
    nope = 32
    return dataclasses.replace(
        cfg,
        num_layers=2 * len(cfg.block_pattern),
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=(nope + 16) if cfg.mla_kv_rank else 16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.num_experts else 0,
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        sliding_window=32 if cfg.sliding_window else None,
        mla_kv_rank=32 if cfg.mla_kv_rank else 0,
        mla_rope_dim=16 if cfg.mla_kv_rank else 0,
        mrope_sections=(4, 2, 2) if cfg.mrope_sections else None,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_heads=4 if cfg.ssm_heads else 0,
        ssm_head_dim=16 if cfg.ssm_heads else 0,
        ssm_groups=1 if cfg.ssm_heads else 1,
        moe_group_size=64,
    )
