"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (kv=16) MoE 64e top-8,
expert d_ff=1024, vocab 50304 [arXiv:2409.02060]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=50304,
    block_pattern=(("attn", "moe"),),
    num_experts=64,
    experts_per_token=8,
    moe_d_ff=1024,
    rope_theta=1e4,
)
