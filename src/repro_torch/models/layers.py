"""Shared neural-net building blocks (plain functions on tensors, parameter
dicts). Port of ``repro.models.layers``.

Every block is a pair of plain functions: ``<block>_init(gen, ...) ->
params`` and ``<block>(params, x, ...) -> y``. Init draws from an explicit
``torch.Generator`` on the generator's device; it does not reproduce
``jax.random``, so parity with the JAX package carries its params across
(:func:`repro_torch.convert.lm_params_from_numpy`). Per-layer parameters
are stacked along a leading layer axis by the model builders.

RMSNorm with a scale goes through the ``rmsnorm`` kernel
(:func:`repro_torch.kernels.ops.rmsnorm`), which computes exactly
``apply_norm``'s function for that case; LayerNorm, the scale-less norm
and the per-head ``rms_norm_heads`` are other functions and stay plain.

On a mesh (:mod:`repro_torch.models.pjit_hints` installed) the layers that
split over ``model`` take ``split=True``: ``mlp`` column-parallel in and
row-parallel out, one all-reduce after; ``embed``, ``unembed`` and
``cross_entropy`` vocab-parallel. A ``dense`` whose bias is whole beside a
column block of its weight adds the bias's block.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import pjit_hints


def _randn(gen: torch.Generator, *shape: int) -> torch.Tensor:
    return torch.randn(*shape, generator=gen, device=gen.device)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               scale: float | None = None, bias: bool = False):
    scale = scale if scale is not None else d_in ** -0.5
    w = _randn(gen, d_in, d_out) * scale
    if bias:
        return {"w": w, "b": torch.zeros(d_out, device=gen.device)}
    return {"w": w}


def dense(params, x):
    w = params["w"]
    y = x @ w.to(x.dtype)
    if "b" in params:
        b = params["b"]
        if b.shape[-1] != w.shape[-1]:     # a column block of the weight
            b = b[pjit_hints.block_of(b.shape[-1])]
        y = y + b.to(x.dtype)
    return y


def embedding_init(gen: torch.Generator, vocab: int, d: int):
    return {"table": _randn(gen, vocab, d) * 0.02}


def embed(params, ids, *, split: bool = False):
    """The table's rows of ``ids``. ``split``: the table is this rank's
    block of vocab rows; ids outside it read zeros, and the ranks' rows are
    summed over ``model`` (one non-zero term each, so exact)."""
    table = params["table"]
    if not split:
        return table[ids]
    n = table.shape[0]
    local = ids.long() - pjit_hints.model_rank() * n
    mine = (local >= 0) & (local < n)
    rows = torch.where(mine[..., None], table[torch.where(mine, local, 0)],
                       0)
    return pjit_hints.reduce_from_model(rows)


def unembed(params, x, *, split: bool = False):
    """Tied read-out: logits = x @ table^T in the activation dtype.
    ``split``: this rank's vocab block of the logits."""
    if split:
        x = pjit_hints.copy_to_model(x)
    return x @ params["table"].to(x.dtype).T


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def norm_init(d: int, *, kind: str = "rmsnorm", parametric: bool = True,
              device=None):
    p = {}
    if parametric:
        p["scale"] = torch.ones(d, device=device)
        if kind == "layernorm":
            p["bias"] = torch.zeros(d, device=device)
    return p


def apply_norm(params, x, *, kind: str = "rmsnorm", eps: float = 1e-6):
    if kind == "rmsnorm" and set(params) == {"scale"}:
        return ops.rmsnorm(x, params["scale"], eps=eps)
    xf = x.to(torch.float32)
    if kind == "layernorm":
        xf = xf - torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if "scale" in params:
        y = y * params["scale"].to(torch.float32)
    if "bias" in params:
        y = y + params["bias"].to(torch.float32)
    return y.to(x.dtype)


def rms_norm_heads(x, scale, eps: float = 1e-6):
    """Per-head qk-norm (qwen3): x (..., H, hd), scale (hd,). Statistics in
    float32; the normalized product in x.dtype (it rounds at other places
    than the rmsnorm kernel, so it stays plain)."""
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, d_ff: int, *,
             kind: str = "swiglu"):
    if kind == "swiglu":
        return {"wi": dense_init(gen, d, d_ff),
                "wg": dense_init(gen, d, d_ff),
                "wo": dense_init(gen, d_ff, d)}
    return {"wi": dense_init(gen, d, d_ff),
            "wo": dense_init(gen, d_ff, d)}


def mlp(params, x, *, kind: str = "swiglu", split: bool = False):
    """``split``: ``wi``/``wg`` hold this rank's FFN columns and ``wo`` the
    matching rows; the output is the all-reduce of the partial products."""
    if split:
        x = pjit_hints.copy_to_model(x)
    if kind == "swiglu":
        h = torch.nn.functional.silu(dense(params["wg"], x)) \
            * dense(params["wi"], x)
    else:
        h = torch.nn.functional.gelu(dense(params["wi"], x),
                                     approximate="tanh")
    y = dense(params["wo"], h)
    return pjit_hints.reduce_from_model(y) if split else y


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """``1 / theta^(2i / hd)`` in float32, computed in float64 and rounded
    once, so the CPU and the card hold the same table."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64,
                        device=device) / head_dim
    return (1.0 / theta ** exps).to(torch.float32)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., S, H, hd); positions: broadcastable to (..., S). The
    rotation tables are computed in float32 and cast to x.dtype."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)       # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs    # (..., S, ·)
    cos = torch.cos(angles)[..., None, :].to(x.dtype)      # (..., S, 1, ·)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def sinusoidal_positions(seq_len: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed positional embeddings, (S, d) float32: the sines
    of ``pos / 10000^(2i / d)`` then their cosines."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / (10_000.0 ** (dim / d))
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

# bytes of the float32 logits one chunk of rows of the cross entropy holds
CE_CHUNK_BYTES = 1 << 28


def _ce_chunks(rows: int, vocab: int):
    step = max(1, CE_CHUNK_BYTES // (4 * vocab))
    return [(r, min(r + step, rows)) for r in range(0, rows, step)]


class CrossEntropyFn(torch.autograd.Function):
    """Per-row ``logsumexp(logits) - logits[label]`` in float32, with the
    VJP that autograd of that formula gives (``g * exp(x - logsumexp)``,
    minus ``g`` at the label, cast to the logits' dtype), computed a chunk
    of rows at a time. It saves the logits as they are and the row
    statistics: autograd of the formula would hold the whole float32 copy
    of the logits (10 GB for 4 x 4096 tokens at vocab 151,936) and build
    two more of that size in its backward; XLA fuses them away in the JAX
    package."""

    @staticmethod
    def forward(ctx, logits, labels):
        vocab = logits.shape[-1]
        flat = logits.reshape(-1, vocab)
        idx = labels.reshape(-1, 1).long()
        logz = torch.empty(flat.shape[0], dtype=torch.float32,
                           device=logits.device)
        for lo, hi in _ce_chunks(flat.shape[0], vocab):
            logz[lo:hi] = torch.logsumexp(flat[lo:hi].to(torch.float32),
                                          dim=-1)
        gold = torch.gather(flat, -1, idx)[:, 0].to(torch.float32)
        ctx.save_for_backward(logits, idx, logz)
        return (logz - gold).reshape(labels.shape)

    @staticmethod
    def backward(ctx, g):
        logits, idx, logz = ctx.saved_tensors
        vocab = logits.shape[-1]
        flat = logits.reshape(-1, vocab)
        g = g.reshape(-1, 1).to(torch.float32)
        grad = torch.empty_like(flat)
        for lo, hi in _ce_chunks(flat.shape[0], vocab):
            part = torch.exp(flat[lo:hi].to(torch.float32)
                             - logz[lo:hi, None]) * g[lo:hi]
            part.scatter_add_(-1, idx[lo:hi], -g[lo:hi])
            grad[lo:hi] = part.to(grad.dtype)
        return grad.reshape(logits.shape), None


class VocabParallelCrossEntropyFn(torch.autograd.Function):
    """:class:`CrossEntropyFn` of logits split over ``model`` by vocab
    blocks (this rank's block starts at ``lo``): each chunk's row max and
    sum of exponentials, and the gold logit (read on the rank that holds
    it, zeros elsewhere), are all-reduced over ``model``; the backward is
    local."""

    @staticmethod
    def forward(ctx, logits, labels, lo):
        vocab = logits.shape[-1]
        flat = logits.reshape(-1, vocab)
        local = labels.reshape(-1).long() - lo
        mine = (local >= 0) & (local < vocab)
        idx = torch.where(mine, local, 0)[:, None]
        logz = torch.empty(flat.shape[0], dtype=torch.float32,
                           device=logits.device)
        for a, b in _ce_chunks(flat.shape[0], vocab):
            part = flat[a:b].to(torch.float32)
            top = pjit_hints.reduce_from_model_max(
                torch.amax(part, dim=-1))
            total = pjit_hints.reduce_from_model(
                torch.sum(torch.exp(part - top[:, None]), dim=-1))
            logz[a:b] = torch.log(total) + top
        gold = torch.where(mine, torch.gather(flat, -1, idx)[:, 0]
                           .to(torch.float32), 0)
        gold = pjit_hints.reduce_from_model(gold)
        ctx.save_for_backward(logits, idx, mine, logz)
        return (logz - gold).reshape(labels.shape)

    @staticmethod
    def backward(ctx, g):
        logits, idx, mine, logz = ctx.saved_tensors
        vocab = logits.shape[-1]
        flat = logits.reshape(-1, vocab)
        g = g.reshape(-1, 1).to(torch.float32)
        grad = torch.empty_like(flat)
        for a, b in _ce_chunks(flat.shape[0], vocab):
            part = torch.exp(flat[a:b].to(torch.float32)
                             - logz[a:b, None]) * g[a:b]
            part.scatter_add_(-1, idx[a:b],
                              torch.where(mine[a:b, None], -g[a:b], 0))
            grad[a:b] = part.to(grad.dtype)
        return grad.reshape(logits.shape), None, None


def cross_entropy(logits, labels, mask=None, *, split: bool = False):
    """Mean next-token CE in float32. logits (..., V), labels (...) int.

    The per-token losses come from :class:`CrossEntropyFn` (float32
    logsumexp, the gold logit read with ``torch.gather``), then the mean,
    or the masked mean ``sum(nll * mask) / max(sum(mask), 1)``. The JAX
    package selects the gold logit with an iota-compare and masked sum,
    for vocab-sharded logits; on one card the two are bit-equal (one
    non-zero plus zeros is exact), and the gather's backward needs no
    (..., V) one-hot. ``split``: the logits are this rank's vocab block
    (:class:`VocabParallelCrossEntropyFn`)."""
    if split:
        nll = VocabParallelCrossEntropyFn.apply(
            logits, labels, pjit_hints.model_rank() * logits.shape[-1])
    else:
        nll = CrossEntropyFn.apply(logits, labels)
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
