"""Mixture-of-Experts with sort-based capacity dispatch. Port of
``repro.models.moe``.

Tokens are ranked into per-expert slots via a stable sort; over-capacity
(token, expert) pairs are dropped (their residual path passes through
untouched, plus any shared experts). The expert FFNs run as one batched
product over the (E, capacity, d) buffer; the JAX package computes it as
an einsum outside any Pallas kernel, so here it is ``torch.bmm``.

On a mesh the layer is laid out as the JAX package's specs lay it out:
the router and the shared experts run on the rank's own (batch-sharded)
tokens; the capacity, the slots and the load-balancing loss are those of
the global batch; and the (E, C, d) buffer and the expert weights are
split over ``model`` when E divides it (``pjit_hints.shard_experts``: E
over ``model``, C and d replicated). A rank

1. routes its own tokens (float32 router, top k, gate), and takes the
   load-balancing loss from the prob sums summed over the batch axes
   (``pjit_hints.batch_mean``) and every batch rank's first choices;
2. gathers the expert ids, not the activations, over the batch axes
   (``pjit_hints.gather_batch``) and computes every pair's slot in
   global token order, so the same pairs drop as on one card;
3. fills only its own experts' rows of the buffer, (E/M, C, d) on a
   ``model`` axis of M, from the gathered tokens a choice at a time
   (pairs of other ranks' experts and dropped pairs go to a spare row;
   no (T*k, d) tensor is built);
4. runs its experts' FFNs on that block (``pjit_hints.use_params`` gives
   it the expert weights' E/M block, moved there from the FFN-width split
   JAX's rules store them in);
5. combines its own tokens only, each pair of another rank's expert
   contributing zero, and sums the partial outputs over ``model``
   (Megatron's ``reduce_from_model``; ``copy_to_model`` on the tokens
   and the gate sums their partial gradients back);
6. adds the shared experts on its own tokens.

Without a mesh, on a ``model`` axis of one, or when E does not divide
``model`` (the JAX package then replicates the experts), the buffer holds
every expert and nothing is summed over ``model``.

Router in float32; the Switch-style load-balancing loss is returned to
the caller.

No step synchronises with the host, so a layer's launches queue up
behind the previous layer's: the dropped pairs are written to a spare
row that is sliced off (instead of being selected by a boolean mask,
whose size the host would have to read), and read back as zeros by a
``where``; the first choices' counts come from ``index_add_``, not
``bincount``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import pjit_hints
from repro_torch.models.layers import dense, dense_init, mlp, mlp_init


def _expert_init(gen: torch.Generator, n: int, d_in: int, d_out: int,
                 dtype: torch.dtype | None = None):
    """``n`` experts' ``dense_init`` matrices, drawn as one (n, d_in,
    d_out) tensor, cast to ``dtype`` when given."""
    w = torch.randn(n, d_in, d_out, generator=gen,
                    device=gen.device).mul_(d_in ** -0.5)
    return {"w": w if dtype is None else w.to(dtype)}


def moe_init(gen: torch.Generator, cfg, dtype: torch.dtype | None = None):
    """A MoE layer's params; a ``dtype`` casts each expert weight to it as
    it is drawn (the same draws, in the same order)."""
    m = cfg.moe
    d = cfg.d_model
    e = m.n_experts
    p = {"router": dense_init(gen, d, e, scale=0.02)}
    if cfg.mlp_type == "swiglu":
        p["experts"] = {"wi": _expert_init(gen, e, d, m.d_expert, dtype),
                        "wg": _expert_init(gen, e, d, m.d_expert, dtype),
                        "wo": _expert_init(gen, e, m.d_expert, d, dtype)}
    else:
        p["experts"] = {"wi": _expert_init(gen, e, d, m.d_expert, dtype),
                        "wo": _expert_init(gen, e, m.d_expert, d, dtype)}
    if m.n_shared:
        p["shared"] = mlp_init(gen, d, m.d_expert * m.n_shared,
                               kind=cfg.mlp_type)
    return p


def _expert_ffn(experts, buf, kind: str):
    """buf: (E, C, d) -> (E, C, d) through the per-expert FFNs (E this
    rank's experts)."""
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
    """x: (B, S, d), this rank's rows on a mesh -> (y, aux_loss): y of the
    same rows, aux_loss the global batch's."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.n_experts, m.top_k
    tokens = x.reshape(t, d)
    probs, gate, ids = route(params, cfg, tokens)

    # every batch rank's expert ids in global token order: the global
    # capacity, slots and first-choice counts
    all_ids = pjit_hints.gather_batch(ids)                       # (Tg, k)
    t_all = all_ids.shape[0]

    # load-balancing auxiliary loss (Switch-style)
    me = pjit_hints.batch_mean(probs)                            # (E,)
    first = torch.zeros(e, device=x.device).index_add_(
        0, all_ids[:, 0], torch.ones(t_all, device=x.device))
    aux = e * torch.sum(me * (first / t_all))

    cap = capacity(cfg, t_all)
    slot, kept = dispatch(all_ids, cap)
    # this rank's experts: E/M of them on a ``model`` axis of M dividing E
    split = pjit_hints.experts_split(e) and pjit_hints.model_active()
    block = pjit_hints.block_of(e) if split else slice(0, e)
    lo, n_loc = block.start, block.stop - block.start
    local = all_ids - lo
    use = kept.view(t_all, k) & (local >= 0) & (local < n_loc)
    # scatter into this rank's experts' buffer a choice at a time; the
    # other ranks' and the dropped pairs to the spare last row
    spare = n_loc * cap
    rows = torch.where(use, local * cap + slot.view(t_all, k), spare)
    src = pjit_hints.gather_batch(
        pjit_hints.copy_to_model(tokens) if split else tokens)  # (Tg, d)
    buf = src.new_zeros(spare + 1, d)
    for rows_j in rows.t().contiguous():
        buf.index_copy_(0, rows_j, src)
    del src
    out_buf = _expert_ffn(params["experts"], buf[:spare].view(n_loc, cap, d),
                          cfg.mlp_type)

    # combine this rank's tokens: a pair of another rank's expert, or a
    # dropped one, reads a clamped row and contributes zero
    own_slot = pjit_hints.batch_rows(slot.view(t_all, k), t).reshape(-1)
    own_use = pjit_hints.batch_rows(use, t).reshape(-1)
    own_lid = (torch.clamp(ids - lo, 0, n_loc - 1) if split else ids) \
        .reshape(-1)
    gathered = out_buf[own_lid, torch.clamp_max(own_slot, cap - 1)]  # (Tk, d)
    gathered = torch.where(own_use[:, None], gathered, 0)
    if split:
        gate = pjit_hints.copy_to_model(gate)
    # split: each rank's partial sum stays float32 until the sum over
    # ``model``, so y is rounded once, as on one card
    y = torch.sum((gathered * gate.reshape(-1, 1).to(gathered.dtype))
                  .reshape(t, k, d), dim=1,
                  dtype=torch.float32 if split else None)
    if split:
        y = pjit_hints.reduce_from_model(y).to(x.dtype)

    if m.n_shared:
        y = y + mlp(params["shared"], tokens, kind=cfg.mlp_type)
    return y.reshape(b, s, d), aux
