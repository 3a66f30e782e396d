"""Architecture configuration schema for the model zoo. Port of
``repro.models.config`` (which imports no JAX; the port keeps its own copy
all the same, so it never imports the JAX package).

The port's :class:`ModelConfig` holds the architecture fields, the
activation ``dtype`` and ``remat``, the JAX config's activation
checkpointing: "none" keeps every layer's activations for the backward;
"block" and "full" (the same in both packages) keep each stacked layer's
input and recompute the layer in the backward, where the JAX package
wraps the layer in ``jax.checkpoint`` (``torch.utils.checkpoint``). The
JAX config's other fields steer its XLA lowering and its kernels
(``scan_layers``, ``attn_vjp``, the blocked attention's
``attn_block_q``/``attn_block_kv``, ``use_flash_kernel``); nothing in the
port reads them, so it has none of them: its layers run eagerly one at a
time, and its attention always runs the flash-attention kernel on the
card (forward and backward), with a tile of its own.

One :class:`ModelConfig` describes any of the assigned families:
dense decoder-only LMs (olmo/qwen2/qwen3), MoE LMs (kimi-k2,
deepseek-v2-lite w/ MLA), encoder-decoder audio (whisper), VLM backbones
(internvl2), SSMs (mamba2) and hybrids (zamba2). The port runs every
one of them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


REMAT_MODES = ("none", "block", "full")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int                 # routed experts
    top_k: int
    d_expert: int                  # per-expert FFN hidden size
    n_shared: int = 0              # shared (always-on) experts
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    n_dense_layers: int = 0        # leading layers that stay dense


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int = 0           # 0 = full-rank q projection


@dataclass(frozen=True)
class SSMConfig:
    state_size: int = 128          # N
    head_dim: int = 64             # P
    n_groups: int = 1              # G (B/C parameter groups)
    conv_kernel: int = 4
    expand: int = 2                # d_inner = expand * d_model
    chunk_size: int = 256          # SSD chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0              # 0 = d_model // n_heads
    qk_norm: bool = False          # qwen3
    qkv_bias: bool = False         # qwen2
    nonparametric_norm: bool = False   # olmo
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm
    mlp_type: str = "swiglu"       # swiglu | gelu
    rope_theta: float = 10_000.0
    use_rope: bool = True          # False: whisper (learned/sinusoidal pos)
    tie_embeddings: bool = False
    max_seq_len: int = 524_288

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # hybrid (zamba2): one weight-tied attention block every `period` layers
    hybrid_attn_period: int = 0

    # encoder-decoder (whisper): encoder depth; frontend supplies embeddings
    n_encoder_layers: int = 0
    encoder_seq_len: int = 0       # e.g. 1500 post-conv audio frames

    # vlm (internvl2): frontend patch embeddings prepended to the sequence
    n_vision_tokens: int = 0

    dtype: str = "bfloat16"        # activations (params stay float32)
    remat: str = "block"           # none | block | full

    def __post_init__(self):
        if self.remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, got "
                             f"{self.remat!r}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_causal_lm(self) -> bool:
        return self.family in ("dense", "moe", "ssm", "hybrid", "vlm")

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks), for 6ND math."""
        d, hd = self.d_model, self.resolved_head_dim
        qo = self.n_heads * hd * d * 2
        kv = self.n_kv_heads * hd * d * 2
        if self.mla is not None:
            m = self.mla
            q_dim = self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            attn = (d * q_dim                           # q (full-rank)
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.n_heads
                    * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
        else:
            attn = qo + kv
        if self.mlp_type == "swiglu":
            def ffn(h):
                return 3 * d * h
        else:
            def ffn(h):
                return 2 * d * h
        blocks = 0
        for layer in range(self.n_layers):
            blocks += attn if self._layer_has_attn(layer) else 0
            if self.ssm is not None and self._layer_is_ssm(layer):
                s = self.ssm
                d_in = s.expand * d
                n_h = d_in // s.head_dim
                blocks += (d * (2 * d_in + 2 * s.n_groups * s.state_size + n_h)
                           + d_in * d + d_in * s.conv_kernel)
            elif self.moe is not None and layer >= self.moe.n_dense_layers:
                m = self.moe
                blocks += ((m.n_experts + m.n_shared) * ffn(m.d_expert)
                           + d * m.n_experts)
            elif self._layer_has_attn(layer) or self.ssm is None:
                blocks += ffn(self.d_ff)
        if self.n_encoder_layers:
            blocks += self.n_encoder_layers * (qo + kv + ffn(self.d_ff) + qo)
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return embed + blocks

    def active_param_count(self) -> int:
        """Active parameters per token (=param_count for non-MoE)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        all_experts = (self.n_layers - m.n_dense_layers) * m.n_experts * \
            (3 if self.mlp_type == "swiglu" else 2) * self.d_model * m.d_expert
        active_experts = (self.n_layers - m.n_dense_layers) * m.top_k * \
            (3 if self.mlp_type == "swiglu" else 2) * self.d_model * m.d_expert
        return full - all_experts + active_experts

    def _layer_has_attn(self, layer: int) -> bool:
        if self.family in ("ssm",):
            return False
        if self.family == "hybrid":
            return self.hybrid_attn_period > 0 and \
                (layer + 1) % self.hybrid_attn_period == 0
        return True

    def _layer_is_ssm(self, layer: int) -> bool:
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            return True                      # zamba2: every layer is mamba2;
        return False                         # attention is an EXTRA shared block

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        shrink = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            max_seq_len=256,
            dtype="float32",
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            encoder_seq_len=16 if self.encoder_seq_len else 0,
            n_vision_tokens=8 if self.n_vision_tokens else 0,
            hybrid_attn_period=2 if self.hybrid_attn_period else 0,
        )
        if self.moe is not None:
            shrink["moe"] = MoEConfig(
                n_experts=4, top_k=2, d_expert=32,
                n_shared=min(self.moe.n_shared, 1),
                n_dense_layers=min(self.moe.n_dense_layers, 1))
        if self.mla is not None:
            shrink["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                                      qk_rope_head_dim=8, v_head_dim=16)
        if self.ssm is not None:
            shrink["ssm"] = SSMConfig(state_size=16, head_dim=16, n_groups=1,
                                      conv_kernel=4, expand=2, chunk_size=32)
        shrink.update(overrides)
        return dataclasses.replace(self, **shrink)
