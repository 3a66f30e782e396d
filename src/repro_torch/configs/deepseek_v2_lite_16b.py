"""deepseek-v2-lite-16b [moe] — arXiv:2405.04434.

MLA with kv_lora_rank=512; 64 routed experts (top-6) + 2 shared, expert
width 1408; first layer dense (width 10944). The assignment note mentions
"160 routed" (the non-Lite V2); the Lite HF config has 64 routed — we follow
the assigned "MoE 64e top-6"."""

from repro_torch.models.config import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,                  # leading dense layer width
    vocab_size=102400,
    mla=MLAConfig(
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_expert=1408,
        n_shared=2,
        n_dense_layers=1,
        capacity_factor=1.25,
    ),
)
