"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000 — local+global alternating, logit softcaps [arXiv:2408.00118]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    block_pattern=(("local", "mlp"), ("attn", "mlp")),
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    q_scale=256.0 ** -0.5,  # query_pre_attn_scalar = 256
    gemma_norms=True,
    tie_embeddings=True,
)
