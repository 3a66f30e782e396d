"""internvl2-1b [vlm] — arXiv:2404.16821. Qwen2-0.5B LM backbone; the
InternViT frontend is a stub supplying precomputed patch embeddings."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    n_vision_tokens=256,
)
