"""mamba2-1.3b [ssm] — arXiv:2405.21060. SSD, attention-free."""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=64,                  # d_inner / ssm.head_dim (bookkeeping only)
    n_kv_heads=64,
    d_ff=0,                      # attention-free: no MLP blocks
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(
        state_size=128,
        head_dim=64,
        n_groups=1,
        conv_kernel=4,
        expand=2,
        chunk_size=256,
    ),
)
