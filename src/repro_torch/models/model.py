"""Model facade: a uniform init / loss / logits / decode interface over
every family (dense, MoE with or without MLA, SSM, hybrid, VLM and the
encoder-decoder), plus the (arch x shape) grid's shape specs. Port of
``repro.models.model``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ShapeDtype:
    """A leaf's shape and dtype without its data (``jax.ShapeDtypeStruct``'s
    counterpart)."""
    shape: tuple
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


def _shapes(fn):
    """The tree ``fn()`` returns, as :class:`ShapeDtype` leaves, computed
    on fake tensors (no memory, no arithmetic)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.utils import tree_map
    with FakeTensorMode():
        tree = fn()
    return tree_map(lambda t: ShapeDtype(tuple(t.shape), t.dtype), tree)


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
        self.cfg = cfg
        self._encdec = cfg.family == "encdec"

    # -- parameters ---------------------------------------------------------

    def _init(self, gen: torch.Generator, dtype: torch.dtype | None):
        if self._encdec:
            return encdec.encdec_init(self.cfg, gen, dtype)
        return transformer.lm_init(self.cfg, gen, dtype)

    def init(self, gen: torch.Generator):
        """Random float32 params drawn from ``gen``, on its device."""
        return self._init(gen, None)

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
        return self._init(gen, transformer.activation_dtype(self.cfg))

    # -- training -----------------------------------------------------------

    def loss(self, params, batch):
        """Scalar training loss of ``batch`` (``tokens`` (B, S+1); an
        encoder-decoder's ``frames``, a VLM's ``prefix_embeds``)."""
        if self._encdec:
            return encdec.encdec_loss(params, self.cfg, batch)
        return transformer.lm_loss(params, self.cfg, batch)

    def logits(self, params, batch):
        """Teacher-forced logits of ``batch["tokens"][:, :-1]``: (B, S, V);
        (B, P + S, V) with a VLM's ``prefix_embeds``."""
        if self._encdec:
            return encdec.encdec_forward(params, self.cfg, batch["frames"],
                                         batch["tokens"][:, :-1])
        out, _ = transformer.lm_forward(
            params, self.cfg, batch["tokens"][:, :-1],
            prefix_embeds=batch.get("prefix_embeds"))
        return out

    # -- serving ------------------------------------------------------------

    def decode_init(self, params, batch: dict, max_len: int,
                    dtype=torch.bfloat16):
        """The decode cache on the device of ``batch["tokens"]``: k and v
        in ``dtype``, SSM state and conv buffers in float32; an
        encoder-decoder runs its encoder on ``batch["frames"]`` here and
        keeps each layer's cross k/v. A VLM's decode takes no prefix, as in
        the JAX package."""
        if self._encdec:
            if "frames" not in batch:
                raise ValueError(f"{self.cfg.name} decodes from frames: "
                                 "batch['frames'] is missing")
            return encdec.encdec_decode_init(params, self.cfg,
                                             batch["frames"], max_len, dtype)
        tokens = batch["tokens"]
        return transformer.lm_decode_init(self.cfg, tokens.shape[0], max_len,
                                          dtype, device=tokens.device)

    def decode_step(self, params, cache, tokens):
        if self._encdec:
            return encdec.encdec_decode_step(params, self.cfg, cache, tokens)
        return transformer.lm_decode_step(params, self.cfg, cache, tokens)

    # -- shapes -------------------------------------------------------------

    def param_specs(self):
        """The float32 params' tree as :class:`ShapeDtype` leaves."""
        return _shapes(lambda: self.init(torch.Generator()))

    def decode_specs(self, shape: ShapeSpec, *,
                     batch_override: int | None = None,
                     dtype=torch.bfloat16):
        """(cache specs, token spec) of a decode step at ``shape``: the
        cache ``decode_init`` builds for ``batch_override`` or the shape's
        batch and ``shape.seq_len`` positions (an encoder-decoder's from
        frames of that batch), as :class:`ShapeDtype` leaves."""
        cfg = self.cfg
        b = batch_override or shape.global_batch

        def build():
            batch = {"tokens": torch.zeros(b, 1, dtype=torch.int32)}
            params = None
            if self._encdec:
                params = self.init(torch.Generator())
                batch["frames"] = torch.zeros(
                    b, cfg.encoder_seq_len, cfg.d_model, dtype=dtype)
            return self.decode_init(params, batch, shape.seq_len, dtype)

        return _shapes(build), ShapeDtype((b,), torch.int32)

    def batch_specs(self, shape: ShapeSpec, *,
                    batch_override: int | None = None) -> dict:
        """The training batch of ``shape`` as (shape, dtype) pairs: tokens
        (B, seq_len + 1) int32; an encoder-decoder's frames (B,
        encoder_seq_len, d) and a VLM's prefix (B, n_vision_tokens, d) in
        bfloat16."""
        cfg = self.cfg
        b = batch_override or shape.global_batch
        specs = {"tokens": ((b, shape.seq_len + 1), torch.int32)}
        if cfg.family == "encdec":
            specs["frames"] = ((b, cfg.encoder_seq_len, cfg.d_model),
                               torch.bfloat16)
        if cfg.family == "vlm":
            specs["prefix_embeds"] = ((b, cfg.n_vision_tokens, cfg.d_model),
                                      torch.bfloat16)
        return specs


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
