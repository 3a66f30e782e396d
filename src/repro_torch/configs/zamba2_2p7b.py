"""zamba2-2.7b [hybrid] — arXiv:2411.15242. Mamba2 backbone with one
weight-tied (shared) attention+MLP block applied every 6 layers."""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,                  # shared attention block's MLP width
    vocab_size=32000,
    hybrid_attn_period=6,
    ssm=SSMConfig(
        state_size=64,
        head_dim=64,
        n_groups=1,
        conv_kernel=4,
        expand=2,
        chunk_size=256,
    ),
)
