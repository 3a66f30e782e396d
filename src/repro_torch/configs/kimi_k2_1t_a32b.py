"""kimi-k2-1t-a32b [moe] — trillion-parameter MoE (paper-table config).

Assigned spec: 61L, d_model=7168, 64H (GQA kv=8), expert width d_ff=2048,
vocab=163840, 384 routed experts top-8. We add 1 shared expert and 1 leading
dense layer (width 18432) following the public K2 architecture family; the
assignment's GQA attention is used as specified (public K2 uses MLA).

At full width it does not fit one card (about 1 T parameters); the port
runs it reduced."""

from repro_torch.models.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=18432,                  # leading dense layer width
    vocab_size=163840,
    rope_theta=50_000.0,
    moe=MoEConfig(
        n_experts=384,
        top_k=8,
        d_expert=2048,
        n_shared=1,
        n_dense_layers=1,
        capacity_factor=1.25,
    ),
)
