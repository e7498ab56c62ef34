"""mamba2-370m [ssm]: 48L d_model=1024, attn-free, ssm_state=128 — SSD
(state-space duality) [arXiv:2405.21060]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=64,  # rope dim unused (attn-free) but kept valid
    d_ff=0,
    vocab_size=50280,
    block_pattern=(("ssm", "none"),),
    ssm_state=128,
    ssm_heads=32,      # d_inner = 2*d_model = 2048, head_dim 64
    ssm_head_dim=64,
    ssm_groups=1,
    conv_width=4,
    tie_embeddings=True,
)
