"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE, dynamic resolution [arXiv:2409.12191].

The vision tower is a STUB: input_specs() feeds merged patch embeddings
plus 3D (temporal, height, width) M-RoPE position ids to the text
backbone; the backbone's M-RoPE sections are (16, 24, 24) over head_dim
128 (dim/2 = 64 rotary channels)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    block_pattern=(("attn", "mlp"),),
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    frontend="vision_stub",
)
