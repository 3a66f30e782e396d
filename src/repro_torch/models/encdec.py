"""Encoder-decoder (the Whisper backbone). Port of ``repro.models.encdec``.

The audio frontend (mel + conv downsampling) is a stub, as in the JAX
package: ``frames`` arrive as precomputed post-conv frame embeddings
(B, encoder_seq_len, d_model). The encoder adds sinusoidal positions and
runs full (non-causal) self-attention; the decoder adds learned positions
and runs causal self-attention and cross-attention to the encoder output.
LayerNorm with a bias, tanh GELU and a tied read-out, as Whisper has them.
Each encoder and decoder layer runs under ``cfg.remat``'s checkpointing
(:func:`transformer.maybe_remat`), as JAX's scan bodies do, and on a mesh
gathers its slice of the rank's blocks inside it
(:func:`pjit_hints.use_layer`).

Every attention over a whole sequence goes through
:func:`ops.flash_attention` (the kernel on the card, its plain version on
the CPU), where the JAX package calls ``blocked_attention``, the same
function. A decode step's self and cross attention are the plain
``cached_attention``, as in JAX.

The activation dtype follows the frames, not ``cfg.dtype``: the encoder
casts its positions to the frames' dtype, the decoder its token
embeddings to the encoder output's, and a decode step runs in the
embedding table's dtype (bfloat16 in a serving copy), as in JAX.

On a mesh the attention layers (self and cross) and the MLPs split over
``model`` as the decoder-only layers do (``models/attention.py``,
``models/layers.py``); the vocab-parallel embedding, read-out and loss
likewise.
"""

from __future__ import annotations

from functools import partial

import torch

from repro_torch.kernels import ops
from repro_torch.models import pjit_hints
from repro_torch.models.attention import (attention, attention_decode,
                                          attention_init, cross_kv,
                                          decode_attend, out_proj)
from repro_torch.models.layers import (apply_norm, cross_entropy, dense,
                                       embed, embedding_init, mlp, mlp_init,
                                       norm_init, sinusoidal_positions,
                                       unembed)
from repro_torch.models.transformer import (cast_params, layer_slices,
                                            maybe_remat, stacked_init)


def _norm(cfg, device):
    return norm_init(cfg.d_model, kind=cfg.norm_type, device=device)


def _an(cfg, p, x):
    return apply_norm(p, x, kind=cfg.norm_type)


def _cross_attn(params, cfg, x, kv):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    split = pjit_hints.attention_split(cfg)
    if split:
        x = pjit_hints.copy_to_model(x)
    q = dense(params["wq"], x).reshape(b, s, -1, hd)
    out = ops.flash_attention(q, kv[0], kv[1], causal=False)
    return out_proj(params, out.reshape(b, s, -1), split)


def _mlp(layer, cfg, x):
    return mlp(layer["ffn"], x, kind=cfg.mlp_type,
               split=pjit_hints.mlp_split(cfg))


def _embed(params, cfg, tokens):
    return embed(params["embed"], tokens,
                 split=pjit_hints.vocab_split(cfg.vocab_size))


def _logits(params, cfg, x):
    return unembed(params["embed"], x,
                   split=pjit_hints.vocab_split(cfg.vocab_size))


def enc_block_init(gen: torch.Generator, cfg):
    return {"norm1": _norm(cfg, gen.device), "attn": attention_init(gen, cfg),
            "norm2": _norm(cfg, gen.device),
            "ffn": mlp_init(gen, cfg.d_model, cfg.d_ff, kind=cfg.mlp_type)}


def dec_block_init(gen: torch.Generator, cfg):
    return {"norm1": _norm(cfg, gen.device),
            "self_attn": attention_init(gen, cfg),
            "norm_x": _norm(cfg, gen.device),
            "cross_attn": attention_init(gen, cfg),
            "norm2": _norm(cfg, gen.device),
            "ffn": mlp_init(gen, cfg.d_model, cfg.d_ff, kind=cfg.mlp_type)}


def encdec_init(cfg, gen: torch.Generator, dtype: torch.dtype | None = None):
    """Random params drawn from ``gen`` on its device, in the JAX tree:
    ``enc_blocks`` and ``dec_blocks`` stacked along a leading layer axis,
    ``enc_norm``, ``embed``, ``pos_embed`` (max_seq_len, d) x 0.01 and
    ``dec_norm``. ``dtype=None`` gives float32 params; a ``dtype`` gives
    ``cast_params(encdec_init(cfg, gen), dtype)`` bit for bit, a layer at a
    time (``pos_embed`` is no matrix leaf, so it stays float32: every use
    casts it to the activation dtype first)."""
    cast = (lambda t: t) if dtype is None else partial(cast_params,
                                                       dtype=dtype)
    dev = gen.device
    params = {"enc_blocks": stacked_init(
        lambda: cast(enc_block_init(gen, cfg)), cfg.n_encoder_layers)}
    params["enc_norm"] = _norm(cfg, dev)
    params["embed"] = cast(embedding_init(gen, cfg.vocab_size, cfg.d_model))
    params["pos_embed"] = torch.randn(cfg.max_seq_len, cfg.d_model,
                                      generator=gen, device=dev) * 0.01
    params["dec_blocks"] = stacked_init(
        lambda: cast(dec_block_init(gen, cfg)), cfg.n_layers)
    params["dec_norm"] = _norm(cfg, dev)
    return params


def encode(params, cfg, frames):
    """frames: (B, S_enc, d) stub embeddings -> encoder states, in the
    frames' dtype."""
    s = frames.shape[1]
    x = frames + sinusoidal_positions(s, cfg.d_model,
                                      frames.device).to(frames.dtype)
    block = maybe_remat(cfg, _enc_step)
    for layer in layer_slices(params["enc_blocks"], cfg.n_encoder_layers):
        x = block(layer, cfg, x)
    return _an(cfg, params["enc_norm"], x)


def _enc_step(layer, cfg, x):
    return _enc_block(pjit_hints.use_layer("enc_blocks", layer, cfg), cfg, x)


def _dec_step(layer, cfg, x, enc):
    return _dec_block(pjit_hints.use_layer("dec_blocks", layer, cfg), cfg, x,
                      enc)


def _enc_block(layer, cfg, x):
    x = x + attention(layer["attn"], cfg, _an(cfg, layer["norm1"], x),
                      causal=False, rope=False)
    return x + _mlp(layer, cfg, _an(cfg, layer["norm2"], x))


def _dec_block(layer, cfg, x, enc):
    x = x + attention(layer["self_attn"], cfg, _an(cfg, layer["norm1"], x),
                      causal=True, rope=False)
    kv = cross_kv(layer["cross_attn"], cfg, enc)
    x = x + _cross_attn(layer["cross_attn"], cfg,
                        _an(cfg, layer["norm_x"], x), kv)
    return x + _mlp(layer, cfg, _an(cfg, layer["norm2"], x))


def encdec_forward(params, cfg, frames, tokens):
    """Teacher-forced forward: logits (B, S_dec, V) in the frames' dtype."""
    enc = encode(params, cfg, frames)
    s = tokens.shape[1]
    x = _embed(params, cfg, tokens).to(enc.dtype)
    x = x + params["pos_embed"][:s].to(x.dtype)
    block = maybe_remat(cfg, _dec_step)
    for layer in layer_slices(params["dec_blocks"], cfg.n_layers):
        x = block(layer, cfg, x, enc)
    x = _an(cfg, params["dec_norm"], x)
    return _logits(params, cfg, x)


def encdec_loss(params, cfg, batch):
    """batch: {frames (B, S_enc, d), tokens (B, S+1)[, loss_mask (B, S)]}
    -> the mean next-token cross entropy."""
    tokens = batch["tokens"]
    logits = encdec_forward(params, cfg, batch["frames"], tokens[:, :-1])
    return cross_entropy(logits, tokens[:, 1:], batch.get("loss_mask"),
                         split=pjit_hints.vocab_split(cfg.vocab_size))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def encdec_decode_init(params, cfg, frames, max_len: int,
                       dtype=torch.bfloat16):
    """Run the encoder once and keep each layer's cross k/v in ``dtype``;
    an empty self cache of ``max_len`` positions. The cache: ``cross``
    {k, v} (L, B, S_enc, Hkv, hd), ``self`` {k, v} (L, B, max_len, Hkv,
    hd) and ``length`` (L, B), ``position`` (B,)."""
    enc = encode(params, cfg, frames)
    b, s_enc, _ = enc.shape
    n, dev = cfg.n_layers, frames.device
    kv_shape = (n, b, s_enc, cfg.n_kv_heads, cfg.resolved_head_dim)
    cross = {"k": torch.empty(kv_shape, dtype=dtype, device=dev),
             "v": torch.empty(kv_shape, dtype=dtype, device=dev)}
    for i, layer in enumerate(layer_slices(params["dec_blocks"], n)):
        layer = pjit_hints.use_layer("dec_blocks", layer, cfg)
        k, v = cross_kv(layer["cross_attn"], cfg, enc, whole=True)
        cross["k"][i].copy_(k)
        cross["v"][i].copy_(v)
    self_shape = (n, b, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"cross": cross,
            "self": {"k": torch.zeros(self_shape, dtype=dtype, device=dev),
                     "v": torch.zeros(self_shape, dtype=dtype, device=dev),
                     "length": torch.zeros(n, b, dtype=torch.int32,
                                           device=dev)},
            "position": torch.zeros(b, dtype=torch.int32, device=dev)}


def encdec_decode_step(params, cfg, cache, tokens):
    """tokens: (B,) -> (logits (B, V), cache). The self cache's k and v are
    written in place at each layer's ``length`` (JAX returns new arrays);
    the cross cache is read only."""
    b = tokens.shape[0]
    hd = cfg.resolved_head_dim
    pos = cache["position"]
    sc, cc = cache["self"], cache["cross"]
    x = _embed(params, cfg, tokens[:, None])
    x = x + params["pos_embed"][pos.long()][:, None].to(x.dtype)
    enc_len = torch.full((b,), cc["k"].shape[2], dtype=torch.int32,
                         device=tokens.device)
    lengths = []
    for i, layer in enumerate(layer_slices(params["dec_blocks"],
                                           cfg.n_layers)):
        layer = pjit_hints.use_layer("dec_blocks", layer, cfg)
        h, new = attention_decode(
            layer["self_attn"], cfg, _an(cfg, layer["norm1"], x),
            {"k": sc["k"][i], "v": sc["v"][i], "length": sc["length"][i]},
            rope=False)
        x = x + h
        lengths.append(new["length"])
        # no name outlives the layer: the next layer gathers its blocks
        # with this one's freed
        q = dense(layer["cross_attn"]["wq"],
                  _an(cfg, layer["norm_x"], x)).reshape(b, 1, -1, hd)
        x = x + decode_attend(layer["cross_attn"], cfg, q, cc["k"][i],
                              cc["v"][i], enc_len)
        x = x + _mlp(layer, cfg, _an(cfg, layer["norm2"], x))
    x = _an(cfg, params["dec_norm"], x)
    logits = _logits(params, cfg, x)
    new_self = {"k": sc["k"], "v": sc["v"], "length": torch.stack(lengths)}
    return logits[:, 0], {"cross": cc, "self": new_self,
                          "position": pos + 1}
