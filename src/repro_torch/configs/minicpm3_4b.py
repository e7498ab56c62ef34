"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA
(multi-head latent attention) [hf:openbmb/MiniCPM3-4B].

MLA geometry follows the HF config: qk_nope 64 + qk_rope 32 (head_dim 96),
kv LoRA rank 256."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=96,        # 64 nope + 32 rope
    d_ff=6400,
    vocab_size=73448,
    block_pattern=(("mla", "mlp"),),
    mla_kv_rank=256,
    mla_rope_dim=32,
    tie_embeddings=True,
)
