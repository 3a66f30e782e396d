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
  ``experts_split`` (and ``attention_split``, ``ssm_split``, ``mlp_split``
  of a config) read those specs, and the layers ask them before they
  compute (column- or row-parallel products, vocab-parallel embedding and
  loss);
* the autograd collectives below are Megatron's: ``copy_to_model`` (the
  identity, its backward an all-reduce over ``model``) where a replicated
  activation enters a split region, ``reduce_from_model`` (an all-reduce,
  its backward the identity) after a row-parallel product,
  ``gather_from_model`` / ``local_block`` between a split and a
  replicated layout, ``sum_over_model`` for a statistic a split layer
  reads whole (its backward sums too), ``gather_batch`` and
  ``batch_mean`` for the MoE
  layer's global expert ids, tokens and load-balancing loss, and
  :func:`use_params`, which gathers each parameter block to the layout
  its layer computes with and reduces its gradient back.

The parameters reach the model as the rank's blocks, as the JAX package's
jitted steps take them (``in_shardings`` of the blocks; GSPMD inserts the
gathers). A step installs the blocks' specs in its hints
(:func:`with_params`); :func:`use_tree` gathers the leaves outside the
stacked layer trees (:data:`STACKED`) once, before the forward, and each
layer gathers its own slice of a stacked tree inside its step
(:func:`use_layer`), as GSPMD gathers inside JAX's scan body: under
``remat="block"`` a layer's gathered blocks die with its forward and are
gathered again in its recompute, and its gradient is reduced back inside
its backward.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.utils import collectives as coll
from repro_torch.utils import (tree_leaves, tree_leaves_with_path, tree_map,
                               tree_unflatten)


@dataclass(frozen=True)
class ShardingHints:
    batch_axes: tuple            # mesh axes carrying the global batch
    model_axis: str | None       # tensor-parallel axis name
    model_size: int              # size of the model axis
    # the device mesh whose process groups the rank's collectives use; None
    # for hints built from axis sizes alone (spec choice, no computing)
    mesh: Any = field(default=None, compare=False)
    # {params tree path: spec} of the rank's parameter blocks, which
    # :func:`use_tree` and :func:`use_layer` gather; None where the caller
    # hands the layers what they compute with
    params: Any = field(default=None, compare=False)


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


def with_params(hints: ShardingHints, paths: list,
                specs: list) -> ShardingHints:
    """``hints`` carrying the specs of the rank's parameter blocks at tree
    ``paths`` (joined by ``/``): a step that takes the blocks computes
    under them."""
    return dataclasses.replace(hints, params=dict(zip(paths, specs)))


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
    """An attention layer of ``cfg`` computes its local heads: q (and an
    MLA layer's ``wkv_b``) column-parallel, the output row-parallel."""
    return heads_split(cfg.n_heads)


def ssm_heads(cfg) -> int:
    """The SSM heads of a Mamba2 block of ``cfg``."""
    return cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim


def ssm_split(cfg) -> bool:
    """A Mamba2 block of ``cfg`` computes its local SSM heads: its z, x
    and dt columns of ``in_proj``, the conv on their channels, the scan on
    their heads, ``out_proj`` row-parallel. Its B/C stay whole on every
    rank, which every head reads where there is one group (mamba2's and
    zamba2's); a block of several groups computes whole."""
    return (cfg.ssm is not None and cfg.ssm.n_groups == 1
            and heads_split(ssm_heads(cfg)))


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


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.group = _group(_HINTS.model_axis)
        return coll.all_reduce(x, ctx.group)

    @staticmethod
    def backward(ctx, g):
        return coll.all_reduce(g, ctx.group)


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


def sum_over_model(x):
    """The sum over ``model`` of the ranks' partial ``x`` where what
    follows stays split (a statistic each rank's block then reads): the
    gradient is all-reduced too, each rank holding its own block's part
    of it (Megatron's identity backward of :func:`reduce_from_model`
    would drop the other ranks')."""
    return _SumOverModel.apply(x) if model_active() else x


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
    layer's expert ids, for the global capacity and slots, and the tokens
    its experts' buffer takes)."""
    return _GatherBatch.apply(x) if batch_active() else x


class _SumBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.groups = [_group(a) for a in _HINTS.batch_axes]
        for group in ctx.groups:
            x = coll.all_reduce(x, group)
        return x

    @staticmethod
    def backward(ctx, g):
        for group in ctx.groups:
            g = coll.all_reduce(g, group)
        return g


def batch_mean(x):
    """The mean over the global batch's rows of a tensor of which this rank
    holds its rows ``x`` (B_local, ...): the rows' sums summed over the
    batch axes, the same on every batch rank; the gradient summed back over
    them (each rank's loss holds the whole mean, as :func:`gather_batch`'s
    reduce-scatter sums it). ``torch.mean(x, 0)`` without batch ranks."""
    if not batch_active():
        return torch.mean(x, dim=0)
    n = x.shape[0]
    for a in _HINTS.batch_axes:
        n *= coll.size(_group(a))
    return _SumBatch.apply(torch.sum(x, dim=0)) / n


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

def param_use(path: str, cfg) -> tuple[bool, bool, int | None]:
    """How the layer at ``path`` (a params tree path joined by ``/``) uses
    its leaf on this mesh: (keep_model, partial, dim). ``keep_model``: the layer
    computes with this rank's block along ``model`` (column- or
    row-parallel weights, a vocab-parallel table). Otherwise the leaf is
    gathered whole, and ``partial`` says whether its gradient on this rank
    is a part of the whole (the leaf is used inside a split region:
    qk-norm scales, biases sliced to the local columns, k/v projections
    of kv heads that do not split, MLA's ``wkv_a`` and ``kv_norm``, and
    every SSM leaf but ``out_proj``: ``in_proj`` and ``conv_w``, whose
    stored blocks are not the rank's heads' columns, are gathered whole
    and sliced, and the B/C columns serve only the local heads), so it is
    summed over ``model``, or the whole (a replicated region: norms, the
    MoE router and shared experts, an SSM block whose heads do not
    split). ``dim``: where the kept block lies on another dim
    than the one the leaf is stored split on, that dim (negative), else
    None. The experts' weights keep their block of E experts (dim -3)
    where JAX's ``shard_experts`` splits E over ``model``; JAX's rules
    store them with their FFN width over ``model`` (the ``wi``/``wg``/
    ``wo`` rules match before ``experts/.*?/w$``)."""
    parts = path.split("/")
    if path.endswith("embed/table") or path.endswith("unembed/w"):
        return vocab_split(cfg.vocab_size), False, None
    if "experts" in parts:
        split = experts_split(cfg.moe.n_experts)
        return split, False, -3 if split else None
    if "router" in parts or "ffn/shared" in path:
        return False, False, None
    if "ssm" in parts:
        if not ssm_split(cfg):
            return False, False, None
        return (True, False, None) if path.endswith("out_proj/w") \
            else (False, True, None)
    if any(p in parts for p in ("attn", "self_attn", "cross_attn")):
        if not attention_split(cfg):
            return False, False, None
        if path.endswith(("wq/w", "wo/w", "wkv_b/w")):
            return True, False, None
        if path.endswith(("wk/w", "wv/w")):
            return heads_split(cfg.n_kv_heads), True, None
        return False, True, None  # q/k norms, biases, wkv_a, kv_norm
    if "ffn" in parts and parts[-1] == "w":
        return mlp_split(cfg), False, None
    return False, False, None


class _Use(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, keep_model, partial, dim):
        from repro_torch.launch.sharding import _gather, spec_axes
        ctx.spec, ctx.keep_model, ctx.partial = spec, keep_model, partial
        ctx.hints, ctx.rank = _HINTS, model_rank()
        out = _gather(x, _HINTS.mesh, spec,
                      keep=("model",) if keep_model else ())
        ctx.moved = None
        if keep_model and dim is not None:
            # the layer computes with its model block on another dim than
            # the stored one: move it there by an all-to-all
            stored, dim = spec_axes(spec).get("model"), dim % x.ndim
            assert stored is not None and stored != dim, (
                f"a block kept on dim {dim} needs the leaf stored split "
                f"over model on another dim; its spec is {spec}")
            ctx.moved = (stored, dim)
            out = coll.all_to_all(out, _group(_HINTS.model_axis), dim,
                                  stored)
        if out is x:
            return out.view_as(out)
        if _METER is not None:
            _METER.track(out)
        return out

    @staticmethod
    def backward(ctx, g):
        from repro_torch.launch.sharding import spec_axes
        h = ctx.hints
        on = spec_axes(ctx.spec)
        if h.model_axis and h.model_size > 1:
            group = h.mesh.get_group(h.model_axis)
            if ctx.moved is not None:
                g = coll.all_to_all(g, group, *ctx.moved)
            elif "model" in on and not ctx.keep_model:
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
        return g.contiguous(), None, None, None, None


def use_params(leaves: list, paths: list, specs: list, cfg) -> list:
    """Each parameter block (``leaves``, this rank's blocks under ``specs``,
    at tree ``paths``) in the layout its layer computes with: gathered
    over ``data`` (fsdp), and over ``model`` unless the layer splits it
    (:func:`param_use`); an expert weight's ``model`` block moved from its
    FFN width to its experts by an all-to-all over ``model``. The gradient
    that flows back into a block is the block of the whole batch's
    gradient: reduce-scattered over each axis the block was gathered over,
    all-reduced over each batch axis it is replicated on, and over
    ``model`` where partial (an expert weight's moved back by the reverse
    all-to-all). A step never calls it on the whole tree: :func:`use_tree`
    calls it on the leaves outside the stacked trees, :func:`use_layer` on
    one layer's slice, so a rank holds one stacked layer's gathered
    blocks at a time beside the others (qwen3-0.6b's whole gathered
    float32 tree is 1.2 GB a rank at model = 2, one of its 28 layers
    0.03 GB)."""
    h = _HINTS
    if h is None or h.mesh is None or not (model_active() or batch_active()):
        return list(leaves)
    out = []
    for x, path, spec in zip(leaves, paths, specs):
        out.append(_Use.apply(x, tuple(spec), *param_use(path, cfg)))
    return out


# the params trees whose leaves stack the layers along a leading axis (a
# transformer's ``blocks``, an encoder-decoder's ``enc_blocks`` and
# ``dec_blocks``): each layer gathers its own slice
STACKED = ("blocks", "enc_blocks", "dec_blocks")


def _path(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def use_tree(params, cfg):
    """The tree a step computes with, from this rank's parameter blocks
    ``params`` under the hints' specs (:func:`with_params`): every leaf
    outside the stacked trees gathered by :func:`use_params` (the
    embedding and read-out, norms, a MoE model's leading dense layers,
    zamba2's shared block: what JAX's scan body closes over or what lies
    outside the scan); the stacked trees left as the rank's blocks, each
    layer gathering its slice by :func:`use_layer`. ``params`` itself
    without such hints."""
    h = _HINTS
    if h is None or h.params is None:
        return params
    pairs = tree_leaves_with_path(params)
    outside = [i for i, (p, _) in enumerate(pairs) if p[0] not in STACKED]
    leaves = [x for _, x in pairs]
    paths = [_path(pairs[i][0]) for i in outside]
    used = use_params([leaves[i] for i in outside], paths,
                      [h.params[p] for p in paths], cfg)
    for i, x in zip(outside, used):
        leaves[i] = x
    return tree_unflatten(params, leaves)


def use_layer(name: str, layer, cfg):
    """One layer's slice ``layer`` of the stacked tree ``name`` (this
    rank's blocks) in the layout the layer computes with
    (:func:`use_params` under each stacked leaf's spec less its layer
    axis, which no rule splits); ``layer`` itself without a step's specs
    in the hints. Called inside the function that ``maybe_remat`` wraps,
    so the recompute gathers again and the backward reduces the layer's
    gradient before the layer below runs."""
    h = _HINTS
    if h is None or h.params is None:
        return layer
    pairs = tree_leaves_with_path(layer)
    paths = [f"{name}/{_path(p)}" for p, _ in pairs]
    specs = [h.params[p] for p in paths]
    assert all(not s or s[0] is None for s in specs), (
        f"a stacked leaf of {name} is split on its layer axis: {specs}")
    return tree_unflatten(layer, use_params(
        [x for _, x in pairs], paths, [s[1:] for s in specs], cfg))


def gathered_alone(params, cfg) -> tuple[int, list]:
    """What this rank's blocks ``params`` gather alone under the installed
    hints, no gradient: the bytes of the leaves outside the stacked trees
    (:func:`use_tree`) and of each stacked layer's slice
    (:func:`use_layer`), in :data:`STACKED`'s order (:class:`GatherMeter`:
    a block used as it is stored counts nothing)."""
    layers = []
    with torch.no_grad():
        with GatherMeter() as m:
            used = use_tree(params, cfg)
            outside = m.live
        del used
        for name in STACKED:
            if name not in params:
                continue
            for i in range(tree_leaves(params[name])[0].shape[0]):
                layer = tree_map(lambda t, i=i: t[i], params[name])
                with GatherMeter() as m:
                    used = use_layer(name, layer, cfg)
                    layers.append(m.live)
                del used
    return outside, layers


class GatherMeter:
    """While in use (``with GatherMeter() as m``): the bytes of gathered
    parameter blocks alive (each storage :func:`use_params` returns counts
    from its gather until it is freed) and their peak, forward, recompute
    and backward alike."""

    def __init__(self):
        self.live = self.peak = 0
        self._refs: dict = {}

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        n = st.nbytes()

        def freed(_ref, key=key, n=n):
            self.live -= n
            self._refs.pop(key, None)

        self._refs[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __enter__(self):
        global _METER
        self._prev, _METER = _METER, self
        return self

    def __exit__(self, *exc):
        global _METER
        _METER = self._prev


_METER: GatherMeter | None = None
