"""qwen3-0.6b [dense] — hf:Qwen/Qwen3-0.6B family. qk_norm, GQA (kv=8)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
)
