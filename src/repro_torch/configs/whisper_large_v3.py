"""whisper-large-v3 [audio] — arXiv:2212.04356 (backbone only; conv/mel
frontend is a stub supplying precomputed frame embeddings)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,                 # decoder depth
    n_encoder_layers=32,
    encoder_seq_len=1500,        # 30 s of audio after 2x conv downsampling
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    norm_type="layernorm",
    mlp_type="gelu",
    qkv_bias=True,
    use_rope=False,              # sinusoidal (enc) + learned (dec) positions
    tie_embeddings=True,
    max_seq_len=32_768,
)
