"""Decoder-only LM assembly: the dense (olmo / qwen2 / qwen3), MoE (kimi-k2;
deepseek-v2-lite with MLA), SSM (mamba2), hybrid (zamba2) and VLM
(internvl2's Qwen2 backbone) families. Port of
``repro.models.transformer``; the encoder-decoder family is
``models/encdec.py``.

Layer parameters are stacked along a leading axis, as in the JAX package;
a Python loop over layer slices takes the place of ``lax.scan``. The
heterogeneous parts sit outside the stack: the leading dense layers of a
MoE model (``dense_blocks``, run before it) and zamba2's weight-tied
shared attention+MLP block (run after every ``hybrid_attn_period``
layers). A VLM's forward takes ``prefix_embeds`` (B, P, d), the stub
vision frontend's patch embeddings, prepended to the token embeddings;
its decode takes none (the JAX package's decode drops the prefix too).

On a mesh each rank runs this code on its rows of the batch with the
layout :mod:`repro_torch.models.pjit_hints` decides: attention heads, MLP
columns and the vocab split over ``model`` where they divide it (the
logits, and a decode step's, are then this rank's vocab block); MoE,
MLA and SSM layers compute whole on every ``model`` rank.
"""

from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (attention, attention_decode,
                                          attention_init, init_kv_cache,
                                          init_mla_cache, mla_attention,
                                          mla_decode, mla_init)
from repro_torch.models.layers import (apply_norm, cross_entropy, dense,
                                       dense_init, embed, embedding_init,
                                       mlp, mlp_init, norm_init, unembed)
from repro_torch.models import pjit_hints
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.ssm import (init_ssm_cache, ssm_apply, ssm_decode,
                                    ssm_init)
from repro_torch.utils import tree_map

SSM_FAMILIES = ("ssm", "hybrid")

# parameter leaves that are matrices: the ones a serving copy holds in the
# activation dtype (``dense``/``embed``/``unembed`` cast them to it anyway;
# the SSM's conv_w, a_log, d_skip, dt_bias and norm_scale stay float32)
MATRIX_LEAVES = ("w", "table")
# matrices that some use reads in float32 whatever the activation dtype, so
# a serving copy keeps them float32: the MoE router (float32 routing) and
# MLA's wkv_b (the absorbed decode's float32 einsums)
FLOAT32_MATRICES = ("router", "wkv_b")


def activation_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def cast_params(params, dtype: torch.dtype):
    """A copy of ``params`` with the matrix leaves (``w``, ``table``) in
    ``dtype`` and every other leaf (norm scales, biases, and the matrices
    of :data:`FLOAT32_MATRICES`) float32. With ``dtype`` the activation
    dtype it computes the same numbers as the float32 params, since every
    other use casts a matrix to the activation dtype first and every other
    leaf to float32 or the activation dtype."""
    def cast(node, key=None, parent=None):
        if isinstance(node, dict):
            return {k: cast(v, k, key) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(cast(v, key, parent) for v in node)
        matrix = key in MATRIX_LEAVES and parent not in FLOAT32_MATRICES
        return node.to(dtype if matrix else torch.float32)
    return cast(params)


def _norm_params(cfg, device):
    return norm_init(cfg.d_model, kind=cfg.norm_type,
                     parametric=not cfg.nonparametric_norm, device=device)


def _apply_norm(cfg, p, x):
    return apply_norm(p, x, kind=cfg.norm_type)


def layer_slices(blocks, n: int) -> list:
    """The ``n`` per-layer views of the stacked ``blocks`` tree."""
    def split(node):
        if isinstance(node, dict):
            parts = {k: split(v) for k, v in node.items()}
            return [{k: parts[k][i] for k in node} for i in range(n)]
        return node.unbind(0)
    return split(blocks)


# ---------------------------------------------------------------------------
# Homogeneous block
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg):
    """One layer of the stack, its structure fixed by ``cfg.family``."""
    if cfg.family in SSM_FAMILIES:
        return {"norm1": _norm_params(cfg, gen.device),
                "ssm": ssm_init(gen, cfg)}
    if cfg.moe is None:
        return dense_block_init(gen, cfg)
    return {"norm1": _norm_params(cfg, gen.device),
            "norm2": _norm_params(cfg, gen.device),
            "attn": _attn_init(gen, cfg),
            "ffn": moe_init(gen, cfg)}


def _attn_init(gen: torch.Generator, cfg):
    return mla_init(gen, cfg) if cfg.mla is not None else \
        attention_init(gen, cfg)


def _attn(params, cfg, h):
    if cfg.mla is not None:
        return mla_attention(params, cfg, h)
    return attention(params, cfg, h, causal=True, rope=cfg.use_rope)


def _attn_decode(params, cfg, h, layer_cache):
    if cfg.mla is not None:
        return mla_decode(params, cfg, h, layer_cache)
    return attention_decode(params, cfg, h, layer_cache, rope=cfg.use_rope)


def dense_block_init(gen: torch.Generator, cfg):
    """A dense attention+MLP layer: the dense family's layers, a MoE
    model's leading layers (kimi / deepseek layer 0) and zamba2's
    weight-tied shared block."""
    d_ff = cfg.d_ff if cfg.d_ff else 4 * cfg.d_model
    return {"norm1": _norm_params(cfg, gen.device),
            "norm2": _norm_params(cfg, gen.device),
            "attn": _attn_init(gen, cfg),
            "ffn": mlp_init(gen, cfg.d_model, d_ff, kind=cfg.mlp_type)}


def dense_block_apply(params, cfg, x):
    x = x + _attn(params["attn"], cfg, _apply_norm(cfg, params["norm1"], x))
    h = _apply_norm(cfg, params["norm2"], x)
    return x + mlp(params["ffn"], h, kind=cfg.mlp_type,
                   split=pjit_hints.mlp_split(cfg))


# zamba2's weight-tied shared attention+MLP block, under the JAX package's
# names: the dense block's structure and function
shared_attn_init = dense_block_init
shared_attn_apply = dense_block_apply


def block_apply(params, cfg, x, aux):
    if cfg.family in SSM_FAMILIES:
        return x + ssm_apply(params["ssm"], cfg,
                             _apply_norm(cfg, params["norm1"], x)), aux
    if cfg.moe is None:
        return dense_block_apply(params, cfg, x), aux
    x = x + _attn(params["attn"], cfg, _apply_norm(cfg, params["norm1"], x))
    h, a = moe_apply(params["ffn"], cfg, _apply_norm(cfg, params["norm2"], x))
    return x + h, aux + a


def _shared_period(cfg) -> int:
    """Layers between two applications of zamba2's shared block; 0 for a
    model without one."""
    if cfg.family != "hybrid" or not cfg.hybrid_attn_period:
        return 0
    if cfg.n_layers % cfg.hybrid_attn_period:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not a "
                         f"multiple of the period {cfg.hybrid_attn_period}")
    return cfg.hybrid_attn_period


# ---------------------------------------------------------------------------
# LM init / forward
# ---------------------------------------------------------------------------

def _n_dense_layers(cfg) -> int:
    return cfg.moe.n_dense_layers if cfg.moe is not None else 0


def _n_stack_layers(cfg) -> int:
    return cfg.n_layers - _n_dense_layers(cfg)


def stacked_init(make_layer, n: int):
    """``n`` layers from ``make_layer()``, called in order, stacked along a
    leading axis: each layer is written into preallocated stacked tensors
    as it is drawn, so at most one layer exists outside the stack (as
    ``torch.stack`` of a list of them would give, bit for bit)."""
    stacked = None
    for i in range(n):
        layer = make_layer()
        if stacked is None:
            stacked = tree_map(lambda t: t.new_empty((n, *t.shape)), layer)
        tree_map(lambda dst, src: dst[i].copy_(src), stacked, layer)
        del layer          # before the next layer is drawn
    return stacked


def lm_init(cfg, gen: torch.Generator, dtype: torch.dtype | None = None):
    """Random params drawn from ``gen`` on its device. ``dtype=None`` gives
    float32 params. A ``dtype`` gives the serving copy
    ``cast_params(lm_init(cfg, gen), dtype)``, bit for bit, without ever
    holding the float32 tree: each layer is drawn in float32, cast, and
    written into the stack (deepseek-v2-lite's float32 params alone are
    62.8 GB; its bf16 serving copy is 31.4 GB). Draws: the embedding, the
    leading dense layers, the stack, zamba2's shared block, the
    read-out."""
    cast = (lambda t: t) if dtype is None else partial(cast_params,
                                                       dtype=dtype)
    params = {"embed": cast(embedding_init(gen, cfg.vocab_size,
                                           cfg.d_model))}
    if _n_dense_layers(cfg):
        params["dense_blocks"] = [cast(dense_block_init(gen, cfg))
                                  for _ in range(_n_dense_layers(cfg))]
    params["blocks"] = stacked_init(lambda: cast(block_init(gen, cfg)),
                                     _n_stack_layers(cfg))
    params["final_norm"] = _norm_params(cfg, gen.device)
    if _shared_period(cfg):
        params["shared_attn"] = cast(dense_block_init(gen, cfg))
    if not cfg.tie_embeddings:
        params["unembed"] = cast(dense_init(gen, cfg.d_model,
                                            cfg.vocab_size,
                                            scale=cfg.d_model ** -0.5))
    return params


def maybe_remat(cfg, fn):
    """``fn`` under activation checkpointing when ``cfg.remat`` asks for it
    and autograd records (the JAX package's ``_maybe_remat``): the
    backward recomputes ``fn`` from its saved inputs instead of keeping
    its activations. The layers draw no random numbers, so no RNG state
    is stashed for the recomputation."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    return partial(checkpoint, fn, use_reentrant=False,
                   preserve_rng_state=False)


def _run_stack(params, cfg, x):
    """Run the layer stack, one layer slice at a time, with zamba2's shared
    block after every ``period`` layers; each stacked layer under
    :func:`maybe_remat`, as JAX's scan body (the leading dense layers and
    the shared block are not, as in JAX). Returns (x, aux), aux summed
    over the MoE layers."""
    aux = torch.zeros((), device=x.device)
    period = _shared_period(cfg)
    block = maybe_remat(cfg, block_apply)
    for i, layer in enumerate(layer_slices(params["blocks"],
                                      _n_stack_layers(cfg))):
        x, aux = block(layer, cfg, x, aux)
        if period and (i + 1) % period == 0:
            x = dense_block_apply(params["shared_attn"], cfg, x)
    return x, aux


def _read_out(params, cfg, x):
    """Logits of the last hidden states: this rank's vocab block when the
    vocab splits over ``model``."""
    x = _apply_norm(cfg, params["final_norm"], x)
    split = pjit_hints.vocab_split(cfg.vocab_size)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x, split=split)
    return dense(params["unembed"],
                 pjit_hints.copy_to_model(x) if split else x)


def _embed(params, cfg, tokens):
    x = embed(params["embed"], tokens,
              split=pjit_hints.vocab_split(cfg.vocab_size))
    return x.to(activation_dtype(cfg))


def lm_forward(params, cfg, tokens, *, prefix_embeds=None):
    """tokens: (B, S) integer; ``prefix_embeds`` (B, P, d), a VLM's patch
    embeddings, prepended in the activation dtype. Returns (logits
    (B, P + S, V), aux_loss scalar)."""
    x = _embed(params, cfg, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    for dp in params.get("dense_blocks", ()):
        x = dense_block_apply(dp, cfg, x)
    x, aux = _run_stack(params, cfg, x)
    return _read_out(params, cfg, x), aux


def lm_loss(params, cfg, batch):
    """batch: {tokens (B, S+1)[, prefix_embeds (B, P, d), loss_mask
    (B, S)]} -> scalar loss: the mean next-token cross entropy of the
    token positions (the prefix's logits are sliced off) plus ``0.01 *
    aux`` (aux, the MoE layers' load-balancing loss, is zero for the other
    families)."""
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    prefix = batch.get("prefix_embeds")
    logits, aux = lm_forward(params, cfg, inputs, prefix_embeds=prefix)
    if prefix is not None:
        logits = logits[:, prefix.shape[1]:]
    loss = cross_entropy(logits, labels, batch.get("loss_mask"),
                         split=pjit_hints.vocab_split(cfg.vocab_size))
    return loss + 0.01 * aux


# ---------------------------------------------------------------------------
# Decode (serve step)
# ---------------------------------------------------------------------------

def _layer_cache_init(cfg, batch, max_len, dtype, device):
    """One layer's cache: an SSM layer's is float32 whatever ``dtype``; an
    MLA layer's holds the latent and the rope key (c_kv, k_rope)."""
    if cfg.family in SSM_FAMILIES:
        return init_ssm_cache(cfg, batch, torch.float32, device)
    if cfg.mla is not None:
        return init_mla_cache(cfg, batch, max_len, dtype, device)
    return init_kv_cache(cfg, batch, max_len, dtype, device)


def _stacked(layer_cache: dict, n: int) -> dict:
    """``n`` copies of the all-zero ``layer_cache`` stacked along a leading
    axis, each leaf allocated once (stacking ``n`` caches would hold twice
    the cache for a moment: 103 GB for internvl2-1b at decode_32k)."""
    return tree_map(lambda t: t.new_zeros((n, *t.shape)), layer_cache)


def lm_decode_init(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None):
    """The decode cache: per-layer caches stacked over the stack's layers,
    a ``dense`` list with one per leading dense layer of a MoE model, and
    for zamba2 one k/v cache per application of the shared block; all
    zeros, lengths and positions 0."""
    cache = {"stack": _stacked(
        _layer_cache_init(cfg, batch, max_len, dtype, device),
        _n_stack_layers(cfg)),
        "position": torch.zeros(batch, dtype=torch.int32, device=device)}
    if _n_dense_layers(cfg):
        cache["dense"] = [_layer_cache_init(cfg, batch, max_len, dtype,
                                            device)
                          for _ in range(_n_dense_layers(cfg))]
    period = _shared_period(cfg)
    if period:
        cache["shared"] = _stacked(
            init_kv_cache(cfg, batch, max_len, dtype, device),
            cfg.n_layers // period)
    return cache


def dense_block_decode(params, cfg, x, layer_cache):
    h, new = _attn_decode(params["attn"], cfg,
                          _apply_norm(cfg, params["norm1"], x), layer_cache)
    x = x + h
    h = _apply_norm(cfg, params["norm2"], x)
    return x + mlp(params["ffn"], h, kind=cfg.mlp_type,
                   split=pjit_hints.mlp_split(cfg)), new


def _block_decode(params, cfg, x, layer_cache):
    if cfg.family in SSM_FAMILIES:
        h, new = ssm_decode(params["ssm"], cfg,
                            _apply_norm(cfg, params["norm1"], x), layer_cache)
        return x + h, new
    if cfg.moe is None:
        return dense_block_decode(params, cfg, x, layer_cache)
    h, new = _attn_decode(params["attn"], cfg,
                          _apply_norm(cfg, params["norm1"], x), layer_cache)
    x = x + h
    h, _ = moe_apply(params["ffn"], cfg, _apply_norm(cfg, params["norm2"], x))
    return x + h, new


def _slice(stack: dict, i: int) -> dict:
    """Layer ``i``'s view of a stacked cache."""
    return {k: v[i] for k, v in stack.items()}


def _restacked(stack: dict, news: list) -> dict:
    """A stacked cache after a step: the layers updated k, v, state and
    conv in place; the lengths they return are stacked anew."""
    out = dict(stack)
    if "length" in stack:
        out["length"] = torch.stack([new["length"] for new in news])
    return out


def lm_decode_step(params, cfg, cache, tokens):
    """One decode step. tokens: (B,) integer -> (logits (B, V), cache). The
    cache's k, v, MLA latents, SSM state and conv buffer are updated in
    place. On a mesh the logits are this rank's vocab block when the vocab
    splits."""
    x = _embed(params, cfg, tokens[:, None])
    period = _shared_period(cfg)
    news, shared_news, dense_news = [], [], []
    for dp, dc in zip(params.get("dense_blocks", ()),
                      cache.get("dense", ())):
        x, new = dense_block_decode(dp, cfg, x, dc)
        dense_news.append(new)
    for i, layer in enumerate(layer_slices(params["blocks"],
                                      _n_stack_layers(cfg))):
        x, new = _block_decode(layer, cfg, x, _slice(cache["stack"], i))
        news.append(new)
        if period and (i + 1) % period == 0:
            x, new = dense_block_decode(
                params["shared_attn"], cfg, x,
                _slice(cache["shared"], i // period))
            shared_news.append(new)
    new_cache = {"stack": _restacked(cache["stack"], news),
                 "position": cache["position"] + 1}
    if dense_news:
        new_cache["dense"] = dense_news
    if period:
        new_cache["shared"] = _restacked(cache["shared"], shared_news)
    return _read_out(params, cfg, x)[:, 0], new_cache
