"""Mixture-of-Experts with sort-based capacity dispatch. Port of
``repro.models.moe``.

Tokens are ranked into per-expert slots via a stable sort; over-capacity
(token, expert) pairs are dropped (their residual path passes through
untouched, plus any shared experts). The expert FFNs run as one batched
product over the (E, capacity, d) buffer; the JAX package computes it as
an einsum outside any Pallas kernel, so here it is ``torch.bmm``.

On a mesh the layer computes on the global batch, as the JAX package's
does (its capacity and load-balancing loss are functions of every
token): each rank gathers the batch ranks' tokens
(``pjit_hints.gather_batch``), runs the whole layer with every expert
(gathered over ``model``; expert parallelism is not ported), and keeps its
own rows of the output.

Router in float32; the Switch-style load-balancing loss is returned to
the caller.

No step synchronises with the host, so a layer's launches queue up
behind the previous layer's: the dropped pairs are written to a spare
slot row that is sliced off (instead of being selected by a boolean
mask, whose size the host would have to read), and read back as zeros
by a ``where``; the first choices' counts come from ``index_add_``, not
``bincount``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import pjit_hints
from repro_torch.models.layers import dense, dense_init, mlp, mlp_init


def _expert_init(gen: torch.Generator, n: int, d_in: int, d_out: int):
    """``n`` experts' ``dense_init`` matrices, drawn as one (n, d_in,
    d_out) tensor."""
    return {"w": torch.randn(n, d_in, d_out, generator=gen,
                             device=gen.device).mul_(d_in ** -0.5)}


def moe_init(gen: torch.Generator, cfg):
    m = cfg.moe
    d = cfg.d_model
    e = m.n_experts
    p = {"router": dense_init(gen, d, e, scale=0.02)}
    if cfg.mlp_type == "swiglu":
        p["experts"] = {"wi": _expert_init(gen, e, d, m.d_expert),
                        "wg": _expert_init(gen, e, d, m.d_expert),
                        "wo": _expert_init(gen, e, m.d_expert, d)}
    else:
        p["experts"] = {"wi": _expert_init(gen, e, d, m.d_expert),
                        "wo": _expert_init(gen, e, m.d_expert, d)}
    if m.n_shared:
        p["shared"] = mlp_init(gen, d, m.d_expert * m.n_shared,
                               kind=cfg.mlp_type)
    return p


def _expert_ffn(experts, buf, kind: str):
    """buf: (E, C, d) -> (E, C, d) through the per-expert FFNs."""
    def matmul(w, x):           # w: (E, a, b), x: (E, C, a)
        return torch.bmm(x, w.to(x.dtype))

    if kind == "swiglu":
        h = torch.nn.functional.silu(matmul(experts["wg"]["w"], buf)) \
            * matmul(experts["wi"]["w"], buf)
    else:
        h = torch.nn.functional.gelu(matmul(experts["wi"]["w"], buf),
                                     approximate="tanh")
    return matmul(experts["wo"]["w"], h)


def capacity(cfg, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens: the JAX package's Python
    expression, so both packages drop the same pairs."""
    m = cfg.moe
    tk = n_tokens * m.top_k
    return max(int(math.ceil(tk * m.capacity_factor / m.n_experts)), 4)


def dispatch(ids, cap: int):
    """Each (token, choice) pair's slot within its expert, in token order
    (a stable sort of the flat expert ids; a pair's slot is its rank among
    the pairs of its expert), and whether it fits under ``cap``.
    ids: (T, k) -> (slot (T*k,) int64, kept (T*k,) bool)."""
    flat = ids.reshape(-1)
    tk = flat.shape[0]
    order = torch.argsort(flat, stable=True)
    sorted_ids = flat[order]
    rank = torch.arange(tk, device=ids.device) - torch.searchsorted(
        sorted_ids, sorted_ids, right=False)
    slot = torch.empty_like(rank).scatter_(0, order, rank)
    return slot, slot < cap


def route(params, cfg, tokens):
    """The router, in float32: tokens (T, d) -> (probs (T, E), gate (T, k)
    renormalised over the top k, ids (T, k) in ``torch.topk``'s order)."""
    logits = dense(params["router"], tokens.to(torch.float32))   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.topk(probs, cfg.moe.top_k, dim=-1)         # (T, k)
    gate = gate / torch.clamp_min(torch.sum(gate, dim=-1, keepdim=True),
                                  1e-9)
    return probs, gate, ids


def moe_apply(params, cfg, x):
    """x: (B, S, d) -> (y, aux_loss). On a mesh: this rank's rows of the
    global batch's y, and the global batch's aux_loss."""
    b_local = x.shape[0]
    x = pjit_hints.gather_batch(x)
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.n_experts, m.top_k
    tokens = x.reshape(t, d)
    probs, gate, ids = route(params, cfg, tokens)

    # load-balancing auxiliary loss (Switch-style)
    me = torch.mean(probs, dim=0)                                # (E,)
    first = torch.zeros(e, device=x.device).index_add_(
        0, ids[:, 0], torch.ones(t, device=x.device))
    aux = e * torch.sum(me * (first / t))

    cap = capacity(cfg, t)
    flat_ids = ids.reshape(-1)
    slot, kept = dispatch(ids, cap)
    # scatter into the expert buffer, the dropped pairs to spare slot `cap`
    rows = flat_ids * (cap + 1) + torch.where(kept, slot, cap)
    buf = x.new_zeros(e * (cap + 1), d)
    buf.index_copy_(0, rows, tokens.repeat_interleave(k, dim=0))
    buf = buf.view(e, cap + 1, d)[:, :cap]

    out_buf = _expert_ffn(params["experts"], buf, cfg.mlp_type)

    gathered = out_buf[flat_ids, torch.clamp_max(slot, cap - 1)]  # (Tk, d)
    gathered = torch.where(kept[:, None], gathered, 0)
    y = torch.sum((gathered * gate.reshape(-1, 1).to(gathered.dtype))
                  .reshape(t, k, d), dim=1)

    if m.n_shared:
        y = y + mlp(params["shared"], tokens, kind=cfg.mlp_type)
    return pjit_hints.batch_rows(y.reshape(b, s, d), b_local), aux
