"""hubert-xlarge [audio]: 48L d_model=1280 16H d_ff=5120 vocab=504 —
encoder-only transformer backbone (w2v2 arch) [arXiv:2106.07447].

The conv waveform frontend is a STUB: input_specs() feeds precomputed
frame embeddings (B, S, d_model) directly to the backbone."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="encoder",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    block_pattern=(("attn", "gelu_mlp"),),
    causal=False,
    frontend="audio_stub",
)
