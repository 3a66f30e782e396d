"""Mamba2: State Space Duality (SSD) blocks (arXiv:2405.21060). Port of
``repro.models.ssm``.

The sequence is processed in chunks: within a chunk the SSD recurrence is
a masked, decay-weighted attention-like product; across chunks a compact
(H, N, P) state is carried. The JAX package carries it through the body of
a ``lax.scan`` over the chunks. The port computes every chunk's own state
at once, sends the recurrence across chunks to :func:`ops.ssd_state_scan`
(the ``ssd_scan`` kernel on the card), then adds each chunk's share of the
state entering it, again for all chunks at once. Per-token decode is the
plain O(1) recurrence and runs no kernel, as in the JAX package.

Shapes: x (B, S, H, P) after the input projection's reshape, B/C
(B, S, G, N) with H % G == 0 (head h reads group h // (H // G), as
``jnp.repeat`` maps it), dt (B, S, H), A (H,) negative. All SSD math runs
in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense, dense_init

_NEG = -1e30


def softplus(x):
    """``jax.nn.softplus``, ``logaddexp(x, 0)`` at every x (PyTorch's
    ``F.softplus`` returns x itself above its threshold of 20)."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _dims(cfg):
    """(d_inner, SSM heads, G * N) of ``cfg``."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, s.n_groups * s.state_size


def ssm_init(gen: torch.Generator, cfg):
    s = cfg.ssm
    d_inner, h, gn = _dims(cfg)
    conv_dim = d_inner + 2 * gn
    dev = gen.device
    return {
        "in_proj": dense_init(gen, cfg.d_model, 2 * d_inner + 2 * gn + h),
        "conv_w": torch.randn(s.conv_kernel, conv_dim, generator=gen,
                              device=dev) * (s.conv_kernel * conv_dim) ** -0.5,
        "conv_b": torch.zeros(conv_dim, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "d_skip": torch.ones(h, device=dev),
        "dt_bias": torch.zeros(h, device=dev),
        "norm_scale": torch.ones(d_inner, device=dev),
        "out_proj": dense_init(gen, d_inner, cfg.d_model),
    }


def _split_proj(cfg, zxbcdt):
    d_inner, h, gn = _dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * gn, h], dim=-1)


def _causal_conv(xbc, w, b):
    """Depthwise causal conv1d along seq. xbc (B, S, C), w (K, C): the K
    shifted products summed in xbc's dtype in index order, then silu."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, :s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i]
    return F.silu(out + b)


def ssd_chunked(x, dt, a, b_mat, c_mat, *, chunk: int, initial_state=None):
    """Chunked SSD scan (the heart of Mamba2).

    x (B, S, H, P), dt (B, S, H) [post-softplus], a (H,) negative,
    b_mat/c_mat (B, S, G, N). Returns (y (B, S, H, P), final_state
    (B, H, N, P)), float32. S must be a multiple of ``chunk``."""
    bsz, seq, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if seq % chunk or h % g:
        raise ValueError(f"seq {seq} must be a multiple of the chunk {chunk} "
                         f"and heads {h} of the groups {g}")
    hg, nc = h // g, seq // chunk
    f32 = torch.float32
    # chunks, each head's rows contiguous: (B, NC, H or G, Q, ...)
    xc = x.to(f32).reshape(bsz, nc, chunk, h, p).transpose(2, 3)
    dtc = dt.to(f32).reshape(bsz, nc, chunk, h).transpose(2, 3).contiguous()
    bm = b_mat.to(f32).reshape(bsz, nc, chunk, g, n).transpose(2, 3)
    cm = c_mat.to(f32).reshape(bsz, nc, chunk, g, n).transpose(2, 3)

    # 1. within every chunk at once
    da = dtc * a[:, None]                                  # (B, NC, H, Q)
    seg = torch.cumsum(da, dim=-1)
    # masked decay attention. Mask BEFORE the exp: the masked (future)
    # entries have rel > 0 and exp(rel) overflows to inf
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    # (out of place from the exp on, so autograd can differentiate it)
    att = (seg[..., :, None] - seg[..., None, :]).masked_fill_(~causal, _NEG)
    att = att.exp_()                                       # (B, NC, H, Q, T)
    scores = cm @ bm.transpose(-1, -2)                     # (B, NC, G, Q, T)
    # scores * decay * dt, head h reading group h // hg
    att = (att.view(bsz, nc, g, hg, chunk, chunk) * scores[:, :, :, None]
           ).view(bsz, nc, h, chunk, chunk) * dtc[..., None, :]
    y = att @ xc                                           # (B, NC, H, Q, P)
    del att, scores
    w_state = torch.exp(seg[..., -1:] - seg) * dtc         # (B, NC, H, Q)
    bh = bm.repeat_interleave(hg, dim=2)                   # (B, NC, H, Q, N)
    states = (bh * w_state[..., None]).transpose(-1, -2) @ xc
    chunk_decay = torch.exp(torch.sum(da, dim=-1))         # (B, NC, H)

    # 2. across chunks: the state entering each chunk, and the final one
    entering, final = ops.ssd_state_scan(
        states.transpose(0, 1).contiguous(),
        chunk_decay.transpose(0, 1).contiguous(),
        None if initial_state is None else initial_state.to(f32))
    del states

    # 3. the entering state's share, every chunk at once
    ch = cm.repeat_interleave(hg, dim=2)                   # (B, NC, H, Q, N)
    y += torch.exp(seg)[..., None] * (ch @ entering.transpose(0, 1))
    return y.transpose(2, 3).reshape(bsz, seq, h, p), final


def _gated_norm(params, y, z):
    """Mamba2's gated RMSNorm before the output projection: RMSNorm of
    ``y * silu(z)`` with float32 statistics (eps 1e-6) and ``norm_scale``,
    in y's dtype, through the rmsnorm kernel (the same function as the JAX
    package's inline norm)."""
    return ops.rmsnorm(y * F.silu(z), params["norm_scale"], eps=1e-6)


def ssm_apply(params, cfg, x, *, initial_state=None, return_state=False):
    """Full-sequence Mamba2 block. x: (B, S, d) -> (B, S, d)."""
    s = cfg.ssm
    bsz, seq, _ = x.shape
    d_inner, h, gn = _dims(cfg)
    z, xbc, dt = _split_proj(cfg, dense(params["in_proj"], x))
    xbc = _causal_conv(xbc, params["conv_w"].to(x.dtype),
                       params["conv_b"].to(x.dtype))
    xs, b_mat, c_mat = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    xs = xs.reshape(bsz, seq, h, s.head_dim)
    b_mat = b_mat.reshape(bsz, seq, s.n_groups, s.state_size)
    c_mat = c_mat.reshape(bsz, seq, s.n_groups, s.state_size)
    dt = softplus(dt.to(torch.float32)
                  + params["dt_bias"].to(torch.float32))
    a = -torch.exp(params["a_log"].to(torch.float32))

    y, state = ssd_chunked(xs, dt, a, b_mat, c_mat,
                           chunk=min(s.chunk_size, seq),
                           initial_state=initial_state)
    y = y + xs.to(torch.float32) * params["d_skip"].to(torch.float32)[
        None, None, :, None]
    y = y.reshape(bsz, seq, d_inner).to(x.dtype)
    out = dense(params["out_proj"], _gated_norm(params, y, z))
    if return_state:
        return out, state
    return out


# ---------------------------------------------------------------------------
# O(1) decode
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg, batch: int, dtype=torch.float32, device=None):
    s = cfg.ssm
    d_inner, h, gn = _dims(cfg)
    return {
        "state": torch.zeros((batch, h, s.state_size, s.head_dim),
                             dtype=dtype, device=device),
        "conv": torch.zeros((batch, s.conv_kernel - 1, d_inner + 2 * gn),
                            dtype=dtype, device=device),
    }


def ssm_decode(params, cfg, x, cache):
    """One-token step. x: (B, 1, d). Returns (y, cache); the cache's
    ``state`` and ``conv`` are updated in place (the JAX package returns
    new arrays), with the same arithmetic."""
    s = cfg.ssm
    bsz = x.shape[0]
    d_inner, h, gn = _dims(cfg)
    f32 = torch.float32
    z, xbc, dt = _split_proj(cfg, dense(params["in_proj"], x))

    # rolling conv buffer
    conv = cache["conv"]
    window = torch.cat([conv, xbc.to(conv.dtype)], dim=1)       # (B, K, C)
    conv_out = (window.to(f32) * params["conv_w"].to(f32)).sum(1) \
        + params["conv_b"].to(f32)
    xbc1 = F.silu(conv_out)[:, None, :].to(x.dtype)
    conv.copy_(window[:, 1:])

    xs, b_mat, c_mat = torch.split(xbc1, [d_inner, gn, gn], dim=-1)
    xs = xs.reshape(bsz, h, s.head_dim).to(f32)
    b_mat = b_mat.reshape(bsz, s.n_groups, s.state_size).to(f32)
    c_mat = c_mat.reshape(bsz, s.n_groups, s.state_size).to(f32)
    dt1 = softplus(dt[:, 0].to(f32) + params["dt_bias"].to(f32))  # (B, H)
    a = -torch.exp(params["a_log"].to(f32))

    hg = h // s.n_groups
    bh = b_mat.repeat_interleave(hg, dim=1)                     # (B, H, N)
    ch = c_mat.repeat_interleave(hg, dim=1)
    decay = torch.exp(dt1 * a[None, :])                         # (B, H)
    state = cache["state"]
    state.mul_(decay[..., None, None])
    state.add_((dt1[..., None] * bh)[..., None] * xs[:, :, None, :])
    y = (ch[:, :, None, :] @ state)[:, :, 0] \
        + xs * params["d_skip"].to(f32)[None, :, None]

    y = y.reshape(bsz, 1, d_inner).to(x.dtype)
    return dense(params["out_proj"], _gated_norm(params, y, z)), cache
