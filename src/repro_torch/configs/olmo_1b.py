"""olmo-1b [dense] — arXiv:2402.00838. Non-parametric LayerNorm."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm_type="layernorm",
    nonparametric_norm=True,
    mlp_type="swiglu",
    tie_embeddings=True,
)
