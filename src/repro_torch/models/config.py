"""Architecture config schema for the LM zoo.

A ``block_pattern`` describes one repeating super-block as a tuple of
(mixer, ffn) pairs; the model is ``num_layers / len(pattern)`` scan steps
over stacked parameters (compile time stays O(pattern), not O(layers)).

Mixers: "attn" (GQA), "local" (sliding-window GQA), "mla", "ssm".
FFNs:   "mlp" (SwiGLU), "gelu_mlp" (encoder-style), "moe", "none".
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

Block = Tuple[str, str]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encoder | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    block_pattern: Tuple[Block, ...] = (("attn", "mlp"),)
    causal: bool = True
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    # attention extras
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    q_scale: Optional[float] = None  # gemma2 query_pre_attn_scalar**-0.5
    # MLA (minicpm3)
    mla_kv_rank: int = 0
    mla_rope_dim: int = 0
    # M-RoPE (qwen2-vl)
    mrope_sections: Optional[Tuple[int, int, int]] = None
    # SSM (mamba2 / jamba)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_groups: int = 1
    conv_width: int = 4
    # misc
    tie_embeddings: bool = False
    gemma_norms: bool = False  # (1+w) RMSNorm + post-norms + sqrt(D) embed scale
    norm_eps: float = 1e-5
    frontend: str = "none"  # none | audio_stub | vision_stub
    moe_group_size: int = 512

    def __post_init__(self):
        assert self.num_layers % len(self.block_pattern) == 0, (
            self.name, self.num_layers, len(self.block_pattern))

    @property
    def num_groups(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_heads * self.ssm_head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    def param_count(self) -> int:
        """Total parameters (for 6ND model-FLOP accounting)."""
        d = self.d_model
        n = 0
        n += self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for mixer, ffn in self.block_pattern:
            g = self.num_groups
            if mixer in ("attn", "local"):
                n += g * d * self.head_dim * (self.num_heads * 2 + self.num_kv_heads * 2)
            elif mixer == "mla":
                nope = self.head_dim - self.mla_rope_dim
                n += g * (
                    d * self.num_heads * self.head_dim  # wq
                    + d * self.mla_kv_rank + d * self.mla_rope_dim
                    + self.mla_kv_rank * self.num_heads * 2 * nope
                    + self.num_heads * nope * d
                )
            elif mixer == "ssm":
                n += g * (
                    d * (2 * self.d_inner + 2 * self.ssm_groups * self.ssm_state
                         + self.ssm_heads)
                    + self.conv_width * self.conv_dim
                    + self.d_inner * d
                )
            if ffn in ("mlp", "gelu_mlp"):
                mult = 3 if ffn == "mlp" else 2
                n += g * mult * d * self.d_ff
            elif ffn == "moe":
                n += g * (d * self.num_experts
                          + self.num_experts * 3 * d * self.moe_d_ff)
        return n

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only top-k experts count)."""
        if self.num_experts == 0:
            return self.param_count()
        n = self.param_count()
        for mixer, ffn in self.block_pattern:
            if ffn == "moe":
                dead = self.num_experts - self.experts_per_token
                n -= self.num_groups * dead * 3 * self.d_model * self.moe_d_ff
        return n


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
