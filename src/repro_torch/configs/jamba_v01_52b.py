"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attention 1:7 interleave
[arXiv:2403.19887].

Super-block of 8 layers: attention at position 3, Mamba elsewhere; MoE
replaces the MLP on every second layer.  SSM geometry: d_inner = 2*d_model,
head_dim 64 (mamba2-style SSD mixer adaptation; Jamba v0.1 itself uses
mamba1 with state 16 — we keep state 16 and the SSD formulation)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=(
        ("ssm", "mlp"), ("ssm", "moe"), ("ssm", "mlp"), ("attn", "moe"),
        ("ssm", "mlp"), ("ssm", "moe"), ("ssm", "mlp"), ("ssm", "moe"),
    ),
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=14336,
    ssm_state=16,
    ssm_heads=128,     # d_inner = 8192
    ssm_head_dim=64,
    ssm_groups=1,
)
