"""Sharding hints: how a rank of a mesh lays out and computes its part of
the model. Port of ``repro.models.pjit_hints``.

Pure model code stays mesh-agnostic: the launcher installs the logical ->
mesh mapping here (a module-level context), and the model asks it at the
points where the layout is decided (attention heads, FFN width, vocab,
experts). When no hints are installed (one card, the CPU tests) every
spec is None and every predicate is False.

The JAX package states the layout with ``with_sharding_constraint`` and
lets GSPMD move data. Here each rank runs the model on its own block, so
the layout is decided by the same rules and carried out by hand:

* the ``shard_*`` functions give JAX's spec of a tensor from the logical
  size of the dim it decides;
* the predicates ``heads_split``, ``ffn_split``, ``vocab_split`` and
  ``experts_split`` read those specs, and the layers ask them before they
  compute (column- or row-parallel products, vocab-parallel embedding and
  loss);
* the autograd collectives below are Megatron's: ``copy_to_model`` (the
  identity, its backward an all-reduce over ``model``) where a replicated
  activation enters a split region, ``reduce_from_model`` (an all-reduce,
  its backward the identity) after a row-parallel product,
  ``gather_from_model`` / ``local_block`` between a split and a
  replicated layout, ``gather_batch`` for the MoE layer's global token
  set, and :func:`use_params`, which gathers each parameter block to the
  layout its layer computes with and reduces its gradient back.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.utils import collectives as coll


@dataclass(frozen=True)
class ShardingHints:
    batch_axes: tuple            # mesh axes carrying the global batch
    model_axis: str | None       # tensor-parallel axis name
    model_size: int              # size of the model axis
    # the device mesh whose process groups the rank's collectives use; None
    # for hints built from axis sizes alone (spec choice, no computing)
    mesh: Any = field(default=None, compare=False)


_HINTS: ShardingHints | None = None


def install(hints: ShardingHints | None):
    global _HINTS
    _HINTS = hints


@contextlib.contextmanager
def hints_ctx(hints: ShardingHints | None):
    global _HINTS
    prev = _HINTS
    _HINTS = hints
    try:
        yield
    finally:
        _HINTS = prev


def current() -> ShardingHints | None:
    return _HINTS


def _model_spec(n: int):
    """JAX's rule for a dim of logical size ``n``: over ``model`` when
    ``n`` divides it, else replicated."""
    h = _HINTS
    return h.model_axis if (h.model_axis and n % h.model_size == 0) else None


# JAX's ``shard_*`` helpers constrain a tensor to a spec. Here each names
# the spec of a tensor from the logical size of the dim it decides (None
# without hints); the predicates below ask them, so the layers follow
# JAX's specs by construction.

def shard_batch(ndim: int):
    """(B, ...): dim 0 over the batch axes, the rest unsharded (the
    residual stream: a rank holds its rows)."""
    h = _HINTS
    return None if h is None else (h.batch_axes,) + (None,) * (ndim - 1)


def shard_heads(n: int):
    """(B, S, H, hd) with ``n`` heads: batch over the batch axes, heads
    over model when ``n`` divides it."""
    h = _HINTS
    return None if h is None else (h.batch_axes, None, _model_spec(n), None)


def shard_scores(n: int):
    """(B, H, q, k) attention scores of ``n`` heads: heads over model when
    divisible (the flash kernel keeps them on chip)."""
    h = _HINTS
    return None if h is None else (h.batch_axes, _model_spec(n), None, None)


def shard_ffn(n: int):
    """(B, S, F) MLP hidden of width ``n``: F over model when
    divisible."""
    h = _HINTS
    return None if h is None else (h.batch_axes, None, _model_spec(n))


def shard_logits(n: int, ndim: int = 3):
    """(..., V) logits of vocab ``n``: vocab over model when divisible."""
    h = _HINTS
    return None if h is None else \
        (h.batch_axes,) + (None,) * (ndim - 2) + (_model_spec(n),)


def shard_experts(n: int, ndim: int = 3):
    """(E, C, D) expert buffers of ``n`` experts: E over model when
    divisible."""
    return None if _HINTS is None else \
        (_model_spec(n),) + (None,) * (ndim - 1)


def from_mesh(mesh, *, inside_pod_vmap: bool = False) -> ShardingHints:
    """Hints for ``mesh`` (a device mesh, or a mapping of axis sizes).
    ``inside_pod_vmap``: the batch axes of one pod (hierarchical mode,
    where each pod trains its own copy)."""
    from repro_torch.launch.mesh import axis_sizes
    sizes = axis_sizes(mesh)
    batch = tuple(a for a in ("pod", "data") if a in sizes)
    if inside_pod_vmap:
        batch = tuple(a for a in batch if a != "pod")
    model_axis = "model" if "model" in sizes else None
    return ShardingHints(batch_axes=batch, model_axis=model_axis,
                         model_size=sizes.get("model", 1),
                         mesh=None if isinstance(mesh, dict) else mesh)


# ---------------------------------------------------------------------------
# What the layers split over ``model`` (False without hints or at size 1)
# ---------------------------------------------------------------------------

def _on_model(spec, dim: int) -> bool:
    return bool(spec is not None and spec[dim] is not None
                and _HINTS.model_size > 1)


def heads_split(n_heads: int) -> bool:
    return _on_model(shard_heads(n_heads), 2)


def ffn_split(d_ff: int) -> bool:
    return _on_model(shard_ffn(d_ff), 2)


def vocab_split(vocab: int) -> bool:
    return _on_model(shard_logits(vocab), -1)


def experts_split(n_experts: int) -> bool:
    return _on_model(shard_experts(n_experts), 0)


def attention_split(cfg) -> bool:
    """A (non-MLA) attention layer of ``cfg`` computes its local heads: q
    column-parallel, the output row-parallel."""
    return cfg.mla is None and heads_split(cfg.n_heads)


def mlp_split(cfg) -> bool:
    """A dense MLP layer of ``cfg`` computes its local FFN columns."""
    return ffn_split(cfg.d_ff if cfg.d_ff else 4 * cfg.d_model)


# ---------------------------------------------------------------------------
# The rank's groups
# ---------------------------------------------------------------------------

def _group(axis: str):
    return _HINTS.mesh.get_group(axis)


def model_rank() -> int:
    """This rank's index on the model axis (0 without hints)."""
    h = _HINTS
    if h is None or h.model_size == 1:
        return 0
    return torch.distributed.get_rank(_group(h.model_axis))


def block_of(n: int) -> slice:
    """This rank's block of ``n`` entries split over ``model``."""
    step = n // _HINTS.model_size
    r = model_rank()
    return slice(r * step, (r + 1) * step)


def _active(axis) -> bool:
    h = _HINTS
    return (h is not None and axis is not None and h.mesh is not None
            and coll.size(h.mesh.get_group(axis)) > 1)


def model_active() -> bool:
    return _HINTS is not None and _active(_HINTS.model_axis)


# ---------------------------------------------------------------------------
# Autograd collectives
# ---------------------------------------------------------------------------

# the autograd functions keep the groups of the hints their forward ran
# under, so a backward outside ``hints_ctx`` reduces over the same ranks

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.group = _group(_HINTS.model_axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return coll.all_reduce(g, ctx.group)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return coll.all_reduce(x, _group(_HINTS.model_axis))

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.n, ctx.rank = dim, x.shape[dim], model_rank()
        return coll.all_gather(x, _group(_HINTS.model_axis), dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None


def reduce_from_model_max(x):
    """The max over ``model`` of the ranks' ``x`` (no gradient)."""
    if not model_active():
        return x
    return coll.all_reduce(x, _group(_HINTS.model_axis), "max")


def copy_to_model(x):
    """Identity; the gradient all-reduced over ``model`` (a replicated
    activation entering a split region, whose gradients are partial)."""
    return _CopyToModel.apply(x) if model_active() else x


def reduce_from_model(x):
    """The sum over ``model`` of the ranks' partial ``x`` (after a
    row-parallel product); the gradient passes as it is."""
    return _ReduceFromModel.apply(x) if model_active() else x


def gather_from_model(x, dim: int):
    """The ranks' blocks along ``dim`` joined into the whole (replicated)
    tensor; the gradient of the whole, the same on every rank, narrowed
    back to this rank's block."""
    return _GatherFromModel.apply(x, dim % x.ndim) if model_active() else x


def local_block(x, dim: int):
    """This rank's block along ``dim`` of a tensor that every rank holds
    whole, inside a split region (the gradient stays partial: zeros
    outside the block)."""
    if not model_active():
        return x
    return x[(slice(None),) * (dim % x.ndim) + (block_of(x.shape[dim]),)]


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.groups = [_group(a) for a in _HINTS.batch_axes]
        for group in reversed(ctx.groups):
            x = coll.all_gather(x, group, 0)
        return x

    @staticmethod
    def backward(ctx, g):
        for group in ctx.groups:
            g = coll.reduce_scatter(g, group, 0)
        return g


def batch_active() -> bool:
    h = _HINTS
    return h is not None and any(_active(a) for a in h.batch_axes)


def gather_batch(x):
    """The global batch: every batch rank's ``x`` (B_local, ...) joined
    along dim 0 in the batch axes' order; the gradient reduce-scattered
    back. For a layer whose result depends on the whole batch (the MoE
    capacity and load-balancing loss)."""
    return _GatherBatch.apply(x) if batch_active() else x


def batch_rows(x, n_local: int):
    """This rank's rows of a tensor over the global batch (the inverse of
    :func:`gather_batch`'s layout)."""
    if not batch_active():
        return x
    index = 0
    for a in _HINTS.batch_axes:
        g = _group(a)
        index = index * coll.size(g) + torch.distributed.get_rank(g)
    return x[index * n_local:(index + 1) * n_local]


# ---------------------------------------------------------------------------
# Parameters: a rank's blocks -> the layout its layers compute with
# ---------------------------------------------------------------------------

def param_use(path: str, cfg) -> tuple[bool, bool]:
    """How the layer at ``path`` (a params tree path joined by ``/``) uses
    its leaf on this mesh: (keep_model, partial). ``keep_model``: the layer
    computes with this rank's block along ``model`` (column- or
    row-parallel weights, a vocab-parallel table). Otherwise the leaf is
    gathered whole, and ``partial`` says whether its gradient on this rank
    is a part of the whole (the leaf is used inside a split region:
    qk-norm scales, biases sliced to the local columns, k/v projections
    of kv heads that do not split), so it is summed over ``model``, or
    the whole (a replicated region: norms, MoE, MLA, SSM)."""
    parts = path.split("/")
    if path.endswith("embed/table") or path.endswith("unembed/w"):
        return vocab_split(cfg.vocab_size), False
    if any(p in parts for p in ("experts", "router", "ssm")) \
            or "ffn/shared" in path:
        return False, False
    if any(p in parts for p in ("attn", "self_attn", "cross_attn")):
        if not attention_split(cfg):
            return False, False
        if path.endswith(("wq/w", "wo/w")):
            return True, False
        if path.endswith(("wk/w", "wv/w")):
            return heads_split(cfg.n_kv_heads), True
        return False, True                # q_norm, k_norm, biases
    if "ffn" in parts and parts[-1] == "w":
        return mlp_split(cfg), False
    return False, False


class _Use(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, keep_model, partial):
        from repro_torch.launch.sharding import _gather
        ctx.spec, ctx.keep_model, ctx.partial = spec, keep_model, partial
        ctx.hints, ctx.rank = _HINTS, model_rank()
        out = _gather(x, _HINTS.mesh, spec,
                      keep=("model",) if keep_model else ())
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, g):
        from repro_torch.launch.sharding import spec_axes
        h = ctx.hints
        on = spec_axes(ctx.spec)
        if h.model_axis and h.model_size > 1:
            group = h.mesh.get_group(h.model_axis)
            if "model" in on and not ctx.keep_model:
                d = on["model"]
                if ctx.partial:
                    g = coll.reduce_scatter(g, group, d)
                else:
                    n = g.shape[d] // h.model_size
                    g = g.narrow(d, ctx.rank * n, n)
            elif "model" not in on and ctx.partial:
                g = coll.all_reduce(g, group)
        for a in h.batch_axes:
            group = h.mesh.get_group(a)
            if a in on:
                g = coll.reduce_scatter(g, group, on[a])
            else:
                g = coll.all_reduce(g, group)
        return g.contiguous(), None, None, None


def use_params(leaves: list, paths: list, specs: list, cfg) -> list:
    """Each parameter block (``leaves``, this rank's blocks under ``specs``,
    at tree ``paths``) in the layout its layer computes with: gathered
    over ``data`` (fsdp), and over ``model`` unless the layer splits it
    (:func:`param_use`). The gradient that flows back into a block is the
    block of the whole batch's gradient: reduce-scattered over each axis
    the block was gathered over, all-reduced over each batch axis it is
    replicated on, and over ``model`` where partial. The whole tree is
    gathered before the forward (no layer-by-layer gather: qwen3-0.6b's
    gathered float32 blocks are 1.2 GB a rank at model = 2)."""
    h = _HINTS
    if h is None or h.mesh is None or not (model_active() or batch_active()):
        return list(leaves)
    out = []
    for x, path, spec in zip(leaves, paths, specs):
        keep, partial = param_use(path, cfg)
        out.append(_Use.apply(x, tuple(spec), keep, partial))
    return out
