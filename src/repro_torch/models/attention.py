"""Attention: the full-sequence forward through the flash-attention kernel,
the cached decode path, GQA / qk-norm / QKV-bias variants. Port of
``repro.models.attention``.

All shapes are (batch, seq, heads, head_dim); softmax statistics in
float32. The full-sequence path is differentiable: its scores go through
:func:`ops.flash_attention`, whose backward recomputes attention in
float32 (``kernels/flash_attention.py``). MLA and
cross-attention (``cross_kv``) come with their families (ROADMAP queue 1
items 10(c) and 10(e)).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, dense, dense_init,
                                       rms_norm_heads)

_NEG_INF = -1e30


def _f32(x):
    return x.to(torch.float32)


def cached_attention(q, k_cache, v_cache, length):
    """Single-step decode attention against a (possibly padded) KV cache.

    q: (B, 1, Hq, hd); caches: (B, S_max, Hkv, hd); ``length``: valid
    prefix (B,)."""
    b, _, hq, hd = q.shape
    _, s_max, hkv, _ = k_cache.shape
    g = hq // hkv
    qr = q.reshape(b, hkv, g, hd) * hd ** -0.5
    s = torch.einsum("bhgd,bkhd->bhgk", _f32(qr), _f32(k_cache))
    mask = torch.arange(s_max, device=q.device)[None, :] < length[:, None]
    s = torch.where(mask[:, None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", _f32(p.to(v_cache.dtype)),
                       _f32(v_cache))
    return out.reshape(b, 1, hq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Standard (GQA) attention block
# ---------------------------------------------------------------------------

def attention_init(gen: torch.Generator, cfg):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, bias=cfg.qkv_bias),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias),
        "wo": dense_init(gen, cfg.n_heads * hd, d),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, device=gen.device)
        p["k_norm"] = torch.ones(hd, device=gen.device)
    return p


def _project_qkv(params, cfg, x, positions, *, rope: bool = True):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = dense(params["wq"], x).reshape(b, s, cfg.n_heads, hd)
    k = dense(params["wk"], x).reshape(b, s, cfg.n_kv_heads, hd)
    v = dense(params["wv"], x).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm_heads(q, params["q_norm"])
        k = rms_norm_heads(k, params["k_norm"])
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(params, cfg, x, *, causal: bool = True, rope: bool = True):
    """Full-sequence attention (prefill) at positions 0..S-1, the scores
    always through :func:`ops.flash_attention`: the kernel on the card, its
    plain version on the CPU. It computes the function of the JAX package's
    ``attention`` under either value of its ``use_flash_kernel`` (the
    Pallas kernel or ``blocked_attention``), so the port has no such
    flag."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(params, cfg, x, positions, rope=rope)
    out = ops.flash_attention(q, k, v, causal=causal)
    return dense(params["wo"], out.reshape(b, s, -1))


def attention_decode(params, cfg, x, cache, *, rope: bool = True):
    """One decode step. x: (B, 1, d); cache dict with k, v (B, S_max, Hkv,
    hd) and ``length`` (B,), each below S_max. The new k, v are written
    into the cache in place at position ``length`` (the JAX package returns
    a new array); returns (out, cache with ``length + 1``)."""
    b = x.shape[0]
    length = cache["length"]
    q, k, v = _project_qkv(params, cfg, x, length[:, None], rope=rope)
    rows = torch.arange(b, device=x.device)
    cache["k"][rows, length.long()] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, length.long()] = v[:, 0].to(cache["v"].dtype)
    out = cached_attention(q, cache["k"], cache["v"], length + 1)
    new_cache = {"k": cache["k"], "v": cache["v"], "length": length + 1}
    return dense(params["wo"], out.reshape(b, 1, -1)), new_cache


def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None):
    hd = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": torch.zeros(batch, dtype=torch.int32, device=device),
    }
