"""Model facade: a uniform init / loss / logits / decode interface, plus
the (arch x shape) grid's shape specs. Port of ``repro.models.model``; the
dense, MoE (MLA included), SSM and hybrid families so far.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "train"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# pure full-attention archs skip long_500k (no sub-quadratic mechanism)
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    if shape.name == "long_500k":
        return cfg.family in SUBQUADRATIC_FAMILIES
    return True


class Model:
    """Family-dispatched facade used by the train and serve launchers."""

    def __init__(self, cfg: ModelConfig):
        transformer.require_ported(cfg)
        self.cfg = cfg

    # -- parameters ---------------------------------------------------------

    def init(self, gen: torch.Generator):
        """Random float32 params drawn from ``gen``, on its device."""
        return transformer.lm_init(self.cfg, gen)

    def serving_params(self, params):
        """The copy a server keeps: matrices in the activation dtype, norm
        scales and biases float32 (:func:`transformer.cast_params`); the
        same numbers as ``params``."""
        return transformer.cast_params(
            params, transformer.activation_dtype(self.cfg))

    def init_serving(self, gen: torch.Generator):
        """``serving_params(init(gen))``, bit for bit, built a layer at a
        time so the float32 params never exist whole (the way a card
        holds deepseek-v2-lite-16b)."""
        return transformer.lm_init(self.cfg, gen,
                                   transformer.activation_dtype(self.cfg))

    # -- training -----------------------------------------------------------

    def loss(self, params, batch):
        """Scalar training loss of ``batch`` (``tokens`` (B, S+1))."""
        return transformer.lm_loss(params, self.cfg, batch)

    def logits(self, params, batch):
        out, _ = transformer.lm_forward(
            params, self.cfg, batch["tokens"][:, :-1],
            prefix_embeds=batch.get("prefix_embeds"))
        return out

    # -- serving ------------------------------------------------------------

    def decode_init(self, params, batch: dict, max_len: int,
                    dtype=torch.bfloat16):
        """The decode cache on the device of ``batch["tokens"]``: k and v
        in ``dtype``, SSM state and conv buffers in float32."""
        tokens = batch["tokens"]
        return transformer.lm_decode_init(self.cfg, tokens.shape[0], max_len,
                                          dtype, device=tokens.device)

    def decode_step(self, params, cache, tokens):
        return transformer.lm_decode_step(params, self.cfg, cache, tokens)


    # -- shapes -------------------------------------------------------------

    def batch_specs(self, shape: ShapeSpec, *,
                    batch_override: int | None = None) -> dict:
        """The training batch of ``shape`` as (shape, dtype) pairs: tokens
        (B, seq_len + 1) int32."""
        b = batch_override or shape.global_batch
        return {"tokens": ((b, shape.seq_len + 1), torch.int32)}


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
