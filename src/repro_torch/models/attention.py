"""Attention: the full-sequence forward through the flash-attention kernel,
the cached decode path, GQA / qk-norm / QKV-bias variants, and DeepSeek's
Multi-head Latent Attention (MLA). Port of ``repro.models.attention``.

All shapes are (batch, seq, heads, head_dim); softmax statistics in
float32. The full-sequence paths are differentiable: their scores go
through :func:`ops.flash_attention`, whose backward is the flash
backward kernel from the saved output and logsumexp
(``kernels/flash_attention.py``). The encoder-decoder's
cross-attention reads the k and v of :func:`cross_kv`
(``models/encdec.py``).

On a mesh whose ``model`` axis divides the query heads
(:func:`pjit_hints.attention_split`) a layer computes its local heads: q
(and k, v when the kv heads divide too, and an MLA layer's ``wkv_b``)
column-parallel, the flash kernel on the local heads, the output
row-parallel with one all-reduce. An MLA layer's latent (``wkv_a``,
``kv_norm``) is computed whole on every rank, as the JAX package stores
those leaves, and its absorbed decode reads the local heads' slices of
``wkv_b`` against the whole latent cache. kv heads
that do not divide are computed whole and repeated to the query heads,
and each rank keeps its block (as the JAX package's TP kv-replication).
A decode cache split over ``model`` on its head dim (as
``launch.sharding.cache_shardings`` places it) is read in place: each
rank's scores over its head-dim block are summed over ``model``, its
block of the output gathered.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models import pjit_hints
from repro_torch.models.layers import (apply_rope, dense, dense_init,
                                       rms_norm_heads)

_NEG_INF = -1e30


def _f32(x):
    return x.to(torch.float32)


def cached_attention(q, k_cache, v_cache, length):
    """Single-step decode attention against a (possibly padded) KV cache.

    q: (B, 1, Hq, hd); caches: (B, S_max, Hkv, hd); ``length``: valid
    prefix (B,). Caches of ``hd / m`` columns are this rank's block of the
    head dim over ``model`` (m ranks): the scores are the sum over
    ``model`` of each block's, and the rank's block of the output is
    gathered."""
    b, _, hq, hd = q.shape
    _, s_max, hkv, hd_c = k_cache.shape
    g = hq // hkv
    qr = q.reshape(b, hkv, g, hd) * hd ** -0.5
    if hd_c != hd:
        qr = qr[..., pjit_hints.block_of(hd)]
    s = torch.einsum("bhgd,bkhd->bhgk", _f32(qr), _f32(k_cache))
    if hd_c != hd:
        s = pjit_hints.reduce_from_model(s)
    mask = torch.arange(s_max, device=q.device)[None, :] < length[:, None]
    s = torch.where(mask[:, None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", _f32(p.to(v_cache.dtype)),
                       _f32(v_cache))
    if hd_c != hd:
        out = pjit_hints.gather_from_model(out, -1)
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


def local_kv(t, cfg):
    """Under a head split whose kv heads do not divide ``model``: the whole
    (B, S, Hkv, hd) ``t`` repeated to the query heads, this rank's block of
    them (a rank's query heads then use one kv head each)."""
    t = t.repeat_interleave(cfg.n_heads // cfg.n_kv_heads, dim=2)
    return pjit_hints.local_block(t, 2)


def _project_qkv(params, cfg, x, positions, *, rope: bool = True,
                 whole_kv: bool = False):
    """q, k, v of ``x``: this rank's heads under a head split (k and v
    repeated to the local query heads when the kv heads do not split,
    unless ``whole_kv``)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    split = pjit_hints.attention_split(cfg)
    q = dense(params["wq"], x).reshape(b, s, -1, hd)
    k = dense(params["wk"], x).reshape(b, s, -1, hd)
    v = dense(params["wv"], x).reshape(b, s, -1, hd)
    if split and not whole_kv and not pjit_hints.heads_split(cfg.n_kv_heads):
        k, v = local_kv(k, cfg), local_kv(v, cfg)
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
    split = pjit_hints.attention_split(cfg)
    if split:
        x = pjit_hints.copy_to_model(x)
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(params, cfg, x, positions, rope=rope)
    out = ops.flash_attention(q, k, v, causal=causal)
    return out_proj(params, out.reshape(b, s, -1), split)


def out_proj(params, out, split: bool):
    """The output projection: row-parallel (this rank's heads' rows, then
    the sum over ``model``) under a head split."""
    y = dense(params["wo"], out)
    return pjit_hints.reduce_from_model(y) if split else y


def cross_kv(params, cfg, enc_out, *, whole: bool = False):
    """The cross-attention k and v (B, S_enc, Hkv, hd) of the encoder
    output: this rank's heads under a head split (as ``_project_qkv``
    gives them), all heads with ``whole`` (a decode cache's)."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    split = pjit_hints.attention_split(cfg)
    kv_split = split and pjit_hints.heads_split(cfg.n_kv_heads)
    if split:
        enc_out = pjit_hints.copy_to_model(enc_out)
    k = dense(params["wk"], enc_out).reshape(b, s, -1, hd)
    v = dense(params["wv"], enc_out).reshape(b, s, -1, hd)
    if whole and kv_split:
        k, v = (pjit_hints.gather_from_model(t, 2) for t in (k, v))
    elif split and not (whole or kv_split):
        k, v = local_kv(k, cfg), local_kv(v, cfg)
    return k, v


def attention_decode(params, cfg, x, cache, *, rope: bool = True):
    """One decode step. x: (B, 1, d); cache dict with k, v (B, S_max, Hkv,
    hd) and ``length`` (B,), each below S_max. The new k, v are written
    into the cache in place at position ``length`` (the JAX package returns
    a new array); returns (out, cache with ``length + 1``)."""
    b = x.shape[0]
    length = cache["length"]
    split = pjit_hints.attention_split(cfg)
    q, k, v = _project_qkv(params, cfg, x, length[:, None], rope=rope,
                           whole_kv=True)
    if split and pjit_hints.heads_split(cfg.n_kv_heads):
        k, v = (pjit_hints.gather_from_model(t, 2) for t in (k, v))
    hd, cols = k.shape[-1], cache["k"].shape[-1]
    if cols != hd:                  # this rank's block of the head dim
        k, v = (t[..., pjit_hints.block_of(hd)] for t in (k, v))
    rows = torch.arange(b, device=x.device)
    cache["k"][rows, length.long()] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, length.long()] = v[:, 0].to(cache["v"].dtype)
    out = decode_attend(params, cfg, q, cache["k"], cache["v"], length + 1)
    new_cache = {"k": cache["k"], "v": cache["v"], "length": length + 1}
    return out, new_cache


def decode_attend(params, cfg, q, k_cache, v_cache, length):
    """A decode step's attention output (B, 1, d) from its q (B, 1, H, hd),
    this rank's heads under a head split, against the cache: the query
    heads gathered whole for :func:`cached_attention`, then the output
    projection (row-parallel on this rank's heads)."""
    b = q.shape[0]
    split = pjit_hints.attention_split(cfg)
    if split:
        q = pjit_hints.gather_from_model(q, 2)
    out = cached_attention(q, k_cache, v_cache, length)
    if split:
        out = out[:, :, pjit_hints.block_of(cfg.n_heads)]
    return out_proj(params, out.reshape(b, 1, -1), split)


def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None):
    hd = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": torch.zeros(batch, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# DeepSeek Multi-head Latent Attention (MLA)
# ---------------------------------------------------------------------------

def mla_init(gen: torch.Generator, cfg):
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": dense_init(gen, d, h * qk_dim),
        "wkv_a": dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim),
        "kv_norm": torch.ones(m.kv_lora_rank, device=gen.device),
        "wkv_b": dense_init(gen, m.kv_lora_rank,
                            h * (m.qk_nope_head_dim + m.v_head_dim)),
        "wo": dense_init(gen, h * m.v_head_dim, d),
    }


def _mla_qkv(params, cfg, x, positions):
    m = cfg.mla
    b, s, _ = x.shape
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim

    q = dense(params["wq"], x).reshape(b, s, -1, qk_dim)  # the rank's heads
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim,
                                     m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv = dense(params["wkv_a"], x)
    c_kv, k_rope = torch.split(kv, [m.kv_lora_rank, m.qk_rope_head_dim],
                               dim=-1)
    c_kv = rms_norm_heads(c_kv[..., None, :],
                          params["kv_norm"])[..., 0, :]      # (B, S, r)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)                      # (B, S, 1, rope)
    return q_nope, q_rope, c_kv, k_rope


def mla_attention(params, cfg, x):
    """Prefill MLA at positions 0..S-1: the latent expanded to per-head K
    and V, q and k of ``qk_nope + qk_rope`` columns. q, k and v are padded
    with zeros to the kernel's next head dim (``HEAD_DIMS``; 192 for
    deepseek-v2-lite, so only v is padded there) so one flash call (the
    kernel on the card) serves all three, scaled by MLA's ``(nope + rope)
    ** -0.5``; the output is sliced back to ``v_head_dim``. Under a head
    split ``wq``'s and ``wkv_b``'s column blocks give the rank's heads
    (each block is whole heads: its columns are (heads, dims) in head
    order) and ``wo``'s row block the output's partial sum."""
    m = cfg.mla
    b, s, _ = x.shape
    split = pjit_hints.attention_split(cfg)
    if split:
        x = pjit_hints.copy_to_model(x)
    positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, cfg, x, positions)
    h = q_nope.shape[2]

    kv = dense(params["wkv_b"], c_kv).reshape(
        b, s, h, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = torch.split(kv, [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k_rope_h = k_rope.expand(b, s, h, m.qk_rope_head_dim)

    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    hd = min(d for d in HEAD_DIMS if d >= max(qk_dim, m.v_head_dim))
    q_full = F.pad(torch.cat([q_nope, q_rope], dim=-1), (0, hd - qk_dim))
    k_full = F.pad(torch.cat([k_nope, k_rope_h], dim=-1), (0, hd - qk_dim))
    v_pad = F.pad(v, (0, hd - m.v_head_dim))
    out = ops.flash_attention(q_full, k_full, v_pad, causal=True,
                              scale=qk_dim ** -0.5)
    out = out[..., :m.v_head_dim]
    return out_proj(params, out.reshape(b, s, -1), split)


def mla_decode(params, cfg, x, cache):
    """Absorbed-matmul MLA decode: the cache stores only (c_kv, k_rope),
    the architecture's KV compression; wkv_b's K half is absorbed into the
    query and its V half applied after the softmax, in float32 as in the
    JAX package. x: (B, 1, d). The new c_kv and k_rope are written into
    the cache in place at position ``length`` (the JAX package returns new
    arrays); returns (out, cache with ``length + 1``). Under a head split
    the rank computes its heads' q_eff, scores, context and output from
    its block of ``wkv_b`` and ``wo`` against the whole latent cache,
    then sums the output over ``model``."""
    m = cfg.mla
    b = x.shape[0]
    length = cache["length"]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, cfg, x, length[:, None])
    h = q_nope.shape[2]

    rows = torch.arange(b, device=x.device)
    c_cache, r_cache = cache["c_kv"], cache["k_rope"]
    c_cache[rows, length.long()] = c_kv[:, 0].to(c_cache.dtype)
    r_cache[rows, length.long()] = k_rope[:, 0, 0].to(r_cache.dtype)

    wkv_b = params["wkv_b"]["w"].reshape(
        m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim)
    wk = wkv_b[:, :, :m.qk_nope_head_dim]                    # (r, H, nope)
    wv = wkv_b[:, :, m.qk_nope_head_dim:]                    # (r, H, v)
    q_eff = torch.einsum("bshn,rhn->bshr", _f32(q_nope), _f32(wk))

    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    c_f32 = _f32(c_cache)
    s_lat = torch.einsum("bshr,bkr->bhk", q_eff, c_f32) * scale
    s_rope = torch.einsum("bshn,bkn->bhk", _f32(q_rope),
                          _f32(r_cache)) * scale
    scores = s_lat + s_rope
    s_max = c_cache.shape[1]
    mask = (torch.arange(s_max, device=x.device)[None, :]
            < (length + 1)[:, None])
    scores = torch.where(mask[:, None], scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1)                        # (B, H, S)
    ctx = torch.einsum("bhk,bkr->bhr", p, c_f32)
    out = torch.einsum("bhr,rhv->bhv", ctx, _f32(wv))
    out = out.reshape(b, 1, h * m.v_head_dim).to(x.dtype)
    new_cache = {"c_kv": c_cache, "k_rope": r_cache, "length": length + 1}
    return out_proj(params, out, pjit_hints.attention_split(cfg)), new_cache


def init_mla_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None):
    m = cfg.mla
    return {
        "c_kv": torch.zeros(batch, max_len, m.kv_lora_rank, dtype=dtype,
                            device=device),
        "k_rope": torch.zeros(batch, max_len, m.qk_rope_head_dim,
                              dtype=dtype, device=device),
        "length": torch.zeros(batch, dtype=torch.int32, device=device),
    }
