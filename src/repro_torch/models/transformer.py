"""Decoder-only LM assembly, dense family (olmo / qwen2 / qwen3). Port of
``repro.models.transformer``.

Layer parameters are stacked along a leading axis, as in the JAX package;
a Python loop over layer slices takes the place of ``lax.scan``. The
other families raise ``NotImplementedError`` naming their ROADMAP items.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import (attention, attention_decode,
                                          attention_init, init_kv_cache)
from repro_torch.models.layers import (apply_norm, dense, dense_init, embed,
                                       embedding_init, mlp, mlp_init,
                                       norm_init, unembed)
from repro_torch.utils import tree_map

# families of ModelConfig the port does not run yet -> ROADMAP item
NOT_PORTED_FAMILIES = {
    "moe": "queue 1 item 10(b), MoE",
    "mla": "queue 1 item 10(c), MLA",
    "ssm": "queue 1 item 10(d), SSM (with queue 2 item 4)",
    "hybrid": "queue 1 item 10(d), hybrid SSM (with queue 2 item 4)",
    "encdec": "queue 1 item 10(e), encoder-decoder",
    "vlm": "queue 1 item 10(f), VLM",
}

# parameter leaves that are matrices: the ones a serving copy holds in the
# activation dtype (``dense``/``embed``/``unembed`` cast them to it anyway)
MATRIX_LEAVES = ("w", "table")


def require_ported(cfg) -> None:
    """Raise ``NotImplementedError`` unless the port runs ``cfg``."""
    what = ("mla" if cfg.mla is not None else
            "moe" if cfg.moe is not None else cfg.family)
    if what != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {what} family is not ported yet: ROADMAP "
            f"{NOT_PORTED_FAMILIES.get(what, 'queue 1 item 10')}")


def activation_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def cast_params(params, dtype: torch.dtype):
    """A copy of ``params`` with the matrix leaves (``w``, ``table``) in
    ``dtype`` and every other leaf (norm scales, biases) float32. With
    ``dtype`` the activation dtype it computes the same numbers as the
    float32 params, since every use casts a matrix to the activation dtype
    first and a norm scale to float32."""
    def cast(node, key=None):
        if isinstance(node, dict):
            return {k: cast(v, k) for k, v in node.items()}
        return node.to(dtype if key in MATRIX_LEAVES else torch.float32)
    return cast(params)


def _norm_params(cfg, device):
    return norm_init(cfg.d_model, kind=cfg.norm_type,
                     parametric=not cfg.nonparametric_norm, device=device)


def _apply_norm(cfg, p, x):
    return apply_norm(p, x, kind=cfg.norm_type)


def _layers(blocks, n: int) -> list:
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
    require_ported(cfg)
    return {"norm1": _norm_params(cfg, gen.device),
            "norm2": _norm_params(cfg, gen.device),
            "attn": attention_init(gen, cfg),
            "ffn": mlp_init(gen, cfg.d_model, cfg.d_ff, kind=cfg.mlp_type)}


def block_apply(params, cfg, x, aux):
    h = _apply_norm(cfg, params["norm1"], x)
    h = attention(params["attn"], cfg, h, causal=True, rope=cfg.use_rope)
    x = x + h
    h = _apply_norm(cfg, params["norm2"], x)
    return x + mlp(params["ffn"], h, kind=cfg.mlp_type), aux


# ---------------------------------------------------------------------------
# LM init / forward
# ---------------------------------------------------------------------------

def lm_init(cfg, gen: torch.Generator):
    """Random params drawn from ``gen`` on its device, float32."""
    require_ported(cfg)
    params = {"embed": embedding_init(gen, cfg.vocab_size, cfg.d_model)}
    layers = [block_init(gen, cfg) for _ in range(cfg.n_layers)]
    params["blocks"] = tree_map(lambda *ls: torch.stack(ls), *layers)
    del layers
    params["final_norm"] = _norm_params(cfg, gen.device)
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                       scale=cfg.d_model ** -0.5)
    return params


def _run_stack(params, cfg, x):
    """Run the layer stack, one layer slice at a time. Returns (x, aux)."""
    aux = torch.zeros((), device=x.device)
    for layer in _layers(params["blocks"], cfg.n_layers):
        x, aux = block_apply(layer, cfg, x, aux)
    return x, aux


def _read_out(params, cfg, x):
    x = _apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return dense(params["unembed"], x)


def lm_forward(params, cfg, tokens, *, prefix_embeds=None):
    """tokens: (B, S) integer. Returns (logits (B, S, V), aux_loss scalar)."""
    require_ported(cfg)
    if prefix_embeds is not None:
        raise NotImplementedError(f"prefix_embeds: ROADMAP "
                                  f"{NOT_PORTED_FAMILIES['vlm']}")
    x = embed(params["embed"], tokens).to(activation_dtype(cfg))
    x, aux = _run_stack(params, cfg, x)
    return _read_out(params, cfg, x), aux


# ---------------------------------------------------------------------------
# Decode (serve step)
# ---------------------------------------------------------------------------

def _layer_cache_init(cfg, batch, max_len, dtype, device):
    require_ported(cfg)
    return init_kv_cache(cfg, batch, max_len, dtype, device)


def lm_decode_init(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None):
    """The decode cache: per-layer caches stacked over the layers."""
    layers = [_layer_cache_init(cfg, batch, max_len, dtype, device)
              for _ in range(cfg.n_layers)]
    stack = tree_map(lambda *ls: torch.stack(ls), *layers)
    return {"stack": stack,
            "position": torch.zeros(batch, dtype=torch.int32,
                                    device=device)}


def _block_decode(params, cfg, x, layer_cache, position):
    h = _apply_norm(cfg, params["norm1"], x)
    h, new = attention_decode(params["attn"], cfg, h, layer_cache,
                              rope=cfg.use_rope)
    x = x + h
    h = _apply_norm(cfg, params["norm2"], x)
    return x + mlp(params["ffn"], h, kind=cfg.mlp_type), new


def lm_decode_step(params, cfg, cache, tokens):
    """One decode step. tokens: (B,) integer -> (logits (B, V), cache). The
    cache's k and v are updated in place."""
    require_ported(cfg)
    x = embed(params["embed"], tokens[:, None]).to(activation_dtype(cfg))
    position = cache["position"]
    stack = cache["stack"]
    lengths = []
    for i, layer in enumerate(_layers(params["blocks"], cfg.n_layers)):
        layer_cache = {"k": stack["k"][i], "v": stack["v"][i],
                       "length": stack["length"][i]}
        x, new = _block_decode(layer, cfg, x, layer_cache, position)
        lengths.append(new["length"])
    new_cache = {"stack": {"k": stack["k"], "v": stack["v"],
                           "length": torch.stack(lengths)},
                 "position": position + 1}
    return _read_out(params, cfg, x)[:, 0], new_cache
