"""Train and serve steps. Port of ``repro.launch.steps``: on one card
(``mesh=None``), or on each rank of a ``torch.distributed`` device mesh.

Two training modes realize the paper's Algorithm 1 at datacenter scale:

* ``sync`` — conventional fully-synchronous training: one parameter copy,
  one gradient over the whole batch (on a mesh: reduced over every batch
  axis, pod and data). The flat-FedAvg analogue and the baseline.

* ``hierarchical`` (HFEL) — parameters and optimizer state carry a
  leading ``pod`` axis (one copy per pod); each step trains every pod on
  its own slice of the batch (eq. (8)'s edge tier; on a mesh the gradient
  is reduced over ``data`` alone), and ``cloud_sync_fn`` averages
  parameters and AdamW moments across pods (eq. (14)), once per I steps,
  optionally through a compressor.

On one card the pods are slices of one tensor and the step loops over
them: forward, backward and update per pod, so one pod's activations and
gradients live at a time. The result is JAX's: its loss is the mean of
the pod losses (so each pod's gradient carries 1/n_pods), and its
optimizer is vmapped over pods (so the global-norm clip is taken per
pod).

On a mesh each rank holds its blocks of the parameters and optimizer
state (``launch.sharding``: ``params_shardings``, ``opt_shardings``; in
hierarchical mode ``("pod", *inner)``, a rank holding its pod's copy) and
its rows of the batch (``batch_shardings``). The step gathers each block
to the layout its layer computes with (``pjit_hints.use_params``), runs
the model under the mesh's hints (tensor parallelism over ``model``),
and reduces each gradient back to the rank's block; the loss of a rank is
the mean over its rows, scaled by 1/(batch ranks) for the gradient. The
clip's norm sums each distinct block once over the ranks (a pod's ranks
in hierarchical mode). The cloud sync is ``core.hierarchy.psum_mean`` over
``pod``.

The step writes the new parameters and optimizer state into the trees it
was given, in place (the JAX step donates them), and returns them. The
update goes one leaf at a time (``Optimizer.apply_``), each gradient
released once used, so beside the parameters, moments and gradients it
holds a few copies of one leaf, not of the tree.

Serving (``make_serve_step``) is one greedy decode step, on one card or
over a mesh: the cache placed by ``cache_shardings``, the tokens by
``token_sharding``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.core.hierarchy import psum_mean
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import Model, ShapeDtype, ShapeSpec, pjit_hints
from repro_torch.optim import Optimizer, adamw, clip_by_global_norm
from repro_torch.utils import (tree_global_norm, tree_leaves,
                               tree_leaves_with_path, tree_map, tree_unflatten)
from repro_torch.utils import collectives as coll

MODES = ("sync", "hierarchical")


def make_optimizer(lr: float = 3e-4, clip: float = 1.0, *,
                   norm=tree_global_norm) -> Optimizer:
    """AdamW under a global-norm clip; ``norm`` computes the clip's norm
    (a mesh's rank passes one summed over the ranks)."""
    return clip_by_global_norm(adamw(lr), clip, norm=norm)


@dataclass
class TrainStepBundle:
    """What ``make_train_step`` builds. ``step_fn(params, opt_state, step,
    batch, clock=None) -> (params, opt_state, step + 1, loss)``;
    ``cloud_sync_fn(params, opt_state) -> (params, opt_state)`` in
    hierarchical mode, else None. ``clock``, when given, is called with
    "forward", "backward", "optimizer" and "end" at the boundaries of the
    step's parts (the first three once per pod), to time them.

    On a mesh the trees are this rank's blocks (``init_state`` makes them
    from the whole params), ``batch`` is this rank's rows
    (``local_batch``), the loss the mean over every rank's rows, and the
    ``*_shardings`` trees (:class:`launch.sharding.NamedSharding` leaves)
    place each leaf; without one they are None."""

    step_fn: Callable
    cloud_sync_fn: Callable | None
    batch_spec: dict
    optimizer: Optimizer
    mode: str
    n_pods: int
    device: torch.device
    mesh: Any = None
    params_spec: Any = None
    opt_spec: Any = None
    params_shardings: Any = None
    opt_shardings: Any = None
    batch_shardings: Any = None

    def init_state(self, params) -> tuple[Any, Any, torch.Tensor]:
        """(params, opt_state, step 0) to start from ``params`` (one
        model's whole tree, the same on every rank of a mesh): in
        hierarchical mode every pod gets its own copy; on a mesh each rank
        keeps its blocks."""
        if self.mesh is not None:
            if self.mode == "hierarchical":
                inner = _inner(self.params_shardings)
                params = tree_map(lambda p, sh: sh.local(p)[None], params,
                                  inner)
            else:
                params = shd.shard_tree(params, self.params_shardings)
        elif self.mode == "hierarchical":
            params = tree_map(lambda p: p.expand(self.n_pods, *p.shape)
                              .clone(), params)
        return (params, self.optimizer.init(params),
                torch.zeros((), dtype=torch.int32, device=self.device))

    def local_batch(self, batch: dict) -> dict:
        """This rank's rows of a whole batch (the batch itself without a
        mesh)."""
        if self.mesh is None:
            return batch
        return {k: self.batch_shardings[k].local(v) for k, v in batch.items()}

    def whole_params(self, params):
        """The whole tree of a rank's parameter blocks (every rank of the
        mesh calls it; pod-stacked in hierarchical mode)."""
        if self.mesh is None:
            return params
        return shd.gather_tree(params, self.params_shardings)


def _inner(shardings):
    """Per-pod shardings of pod-stacked ones (the leading ``pod`` entry
    dropped)."""
    return tree_map(lambda sh: shd.NamedSharding(sh.mesh, sh.spec[1:]),
                    shardings)


def _loss_and_grads(model: Model, params, batch, scale: float, clock):
    """(loss, grads of ``scale * loss`` with respect to every leaf, a list
    in ``tree_leaves`` order)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    clock("forward")
    loss = model.loss(tree_unflatten(params, leaves), batch)
    clock("backward")
    grads = torch.autograd.grad(loss * scale, leaves)
    return loss.detach(), list(grads)


def _no_clock(_):
    return None


def make_train_step(model: Model, shape: ShapeSpec, *, mesh=None,
                    mode: str = "sync", sharding_mode: str = "fsdp",
                    lr: float = 3e-4, compressor=None, n_pods: int = 2,
                    batch_override: int | None = None,
                    device=None) -> TrainStepBundle:
    """The train step of ``mode`` for ``model`` at ``shape`` (its batch
    ``batch_override`` or the shape's global batch), with
    :func:`make_optimizer`'s AdamW under a global-norm clip of 1.0.
    ``device=None`` means CUDA (raising without a card). With a ``mesh``
    (every rank calls this) the step is one rank's, its leaves placed by
    ``sharding_mode`` ("fsdp" or "tp"), the pod count the mesh's ``pod``
    axis."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mesh is not None:
        return _mesh_train_step(model, shape, mesh, mode=mode,
                                sharding_mode=sharding_mode, lr=lr,
                                compressor=compressor,
                                batch_override=batch_override,
                                device=device)
    dev = resolve_device(device)
    opt = make_optimizer(lr)
    hierarchical = mode == "hierarchical"
    if hierarchical and n_pods < 2:
        raise ValueError("hierarchical mode needs at least 2 pods")
    batch_spec = model.batch_specs(shape, batch_override=batch_override)
    b = batch_spec["tokens"][0][0]
    if hierarchical and b % n_pods:
        raise ValueError(f"batch {b} does not split into {n_pods} pods")

    def sync_step(params, opt_state, step, batch, clock=None):
        clock = clock or _no_clock
        loss, grads = _loss_and_grads(model, params, batch, 1.0, clock)
        clock("optimizer")
        opt.apply_(grads, opt_state, params, step)
        clock("end")
        return params, opt_state, step + 1, loss

    def hier_step(params, opt_state, step, batch, clock=None):
        clock = clock or _no_clock
        pod_batch = {k: v.reshape(n_pods, v.shape[0] // n_pods,
                                  *v.shape[1:]) for k, v in batch.items()}
        losses = []
        for p in range(n_pods):
            params_p = tree_map(lambda x: x[p], params)
            state_p = tree_map(lambda x: x[p], opt_state)
            loss_p, grads = _loss_and_grads(
                model, params_p, {k: v[p] for k, v in pod_batch.items()},
                1.0 / n_pods, clock)
            losses.append(loss_p)
            # pod p's update reads only pod p's gradient, parameters and
            # state, so it runs before the next pod's forward
            clock("optimizer")
            opt.apply_(grads, state_p, params_p, step)
        clock("end")
        return params, opt_state, step + 1, torch.mean(torch.stack(losses))

    cloud_sync_fn = None
    if hierarchical:
        def cloud_sync(params, opt_state):
            """eq. (14): average parameters (and moments) across pods."""
            def avg(leaf):
                if compressor is not None:
                    mean = torch.mean(leaf, dim=0, keepdim=True)
                    delta, _ = compressor.compress(leaf - mean,
                                                   torch.zeros_like(leaf))
                    leaf_c = mean + delta       # pod-local residual, sparse
                else:
                    leaf_c = leaf
                leaf.copy_(torch.mean(leaf_c, dim=0, keepdim=True)
                           .expand_as(leaf))

            for leaf in tree_leaves(params) + tree_leaves(opt_state):
                avg(leaf)
            return params, opt_state

        cloud_sync_fn = cloud_sync

    return TrainStepBundle(hier_step if hierarchical else sync_step,
                           cloud_sync_fn, batch_spec, opt, mode,
                           n_pods if hierarchical else 1, dev)


def _structs(batch_spec: dict) -> dict:
    return {k: ShapeDtype(tuple(shape), dtype)
            for k, (shape, dtype) in batch_spec.items()}


def _mesh_train_step(model, shape, mesh, *, mode, sharding_mode, lr,
                     compressor, batch_override, device) -> TrainStepBundle:
    dev = resolve_device(device)
    sizes = axis_sizes(mesh)
    n_pods = sizes.get("pod", 1)
    hierarchical = mode == "hierarchical"
    if hierarchical and n_pods < 2:
        raise ValueError("hierarchical mode needs a pod axis of 2 or more")
    if sharding_mode not in ("fsdp", "tp"):
        raise ValueError(f"sharding_mode must be fsdp or tp, got "
                         f"{sharding_mode!r}")

    params_spec = model.param_specs()
    if hierarchical:
        params_spec = tree_map(
            lambda l: ShapeDtype((n_pods,) + l.shape, l.dtype), params_spec)
    opt_spec = {"m": params_spec, "v": params_spec}    # adamw's moments
    batch_spec = model.batch_specs(shape, batch_override=batch_override)
    rule = shd.hier_param_shardings if hierarchical else shd.param_shardings
    p_shard = rule(params_spec, mesh, mode=sharding_mode)
    o_shard = rule(opt_spec, mesh, mode=sharding_mode)
    b_shard = shd.batch_shardings(_structs(batch_spec), mesh)
    b = batch_spec["tokens"][0][0]
    n_batch = sizes.get("data", 1) * n_pods
    if b % n_batch:
        raise ValueError(f"batch {b} does not split over {n_batch} batch "
                         "ranks")

    hints = pjit_hints.from_mesh(mesh, inside_pod_vmap=hierarchical)
    inner = _inner(p_shard) if hierarchical else p_shard
    pairs = tree_leaves_with_path(params_spec)
    paths = [shd._key_str(p) for p, _ in pairs]
    specs = [sh.spec for sh in shd._sharding_leaves(inner)]
    # the clip's norm: over every rank (sync) or a pod's (hierarchical)
    norm_axes = tuple(a for a in sizes if a != "pod" or not hierarchical)
    opt = make_optimizer(lr, norm=shd.global_norm_fn(inner, mesh,
                                                     norm_axes))
    scale = 1.0 / n_batch

    def reported(loss):
        """The mean of the ranks' losses over every batch rank."""
        if n_batch == 1:
            return loss
        for a in ("data", "pod"):
            if a in sizes:
                loss = coll.all_reduce(loss, mesh.get_group(a))
        return loss / n_batch

    def step_fn(params, opt_state, step, batch, clock=None):
        clock = clock or _no_clock
        mine, state = params, opt_state
        if hierarchical:                 # this rank's pod's copy
            mine = tree_map(lambda x: x[0], params)
            state = tree_map(lambda x: x[0], opt_state)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(mine)]
        clock("forward")
        with pjit_hints.hints_ctx(hints):
            used = pjit_hints.use_params(leaves, paths, specs, model.cfg)
            loss = model.loss(tree_unflatten(mine, used), batch)
            clock("backward")
            grads = list(torch.autograd.grad(loss * scale, leaves))
        del used, leaves
        clock("optimizer")
        opt.apply_(grads, state, mine, step)
        clock("end")
        return params, opt_state, step + 1, reported(loss.detach())

    cloud_sync_fn = None
    if hierarchical:
        def cloud_sync(params, opt_state):
            """eq. (14): average parameters (and moments) across pods."""
            for leaf in tree_leaves(params) + tree_leaves(opt_state):
                leaf_c = leaf
                if compressor is not None:
                    mean = psum_mean(leaf, "pod", mesh=mesh)
                    delta, _ = compressor.compress(leaf - mean,
                                                   torch.zeros_like(leaf))
                    leaf_c = mean + delta       # pod-local residual, sparse
                leaf.copy_(psum_mean(leaf_c, "pod", mesh=mesh))
            return params, opt_state

        cloud_sync_fn = cloud_sync

    return TrainStepBundle(step_fn, cloud_sync_fn, batch_spec, opt, mode,
                           n_pods if hierarchical else 1, dev, mesh=mesh,
                           params_spec=params_spec, opt_spec=opt_spec,
                           params_shardings=p_shard, opt_shardings=o_shard,
                           batch_shardings=b_shard)


@dataclass
class ServeStepBundle:
    """What ``make_serve_step`` builds. ``step_fn(params, cache, tokens)
    -> (next_tokens int32, cache)``: one greedy decode step (the cache
    updated in place). On a mesh ``params`` is the layout a rank computes
    with (``compute_params`` of its blocks, gathered once: serving does not
    change them), ``cache`` its blocks under ``cache_shardings`` and
    ``tokens`` its rows under ``token_sharding``. ``decode_fn`` is the
    same step returning the whole logits (gathered over ``model``) instead
    of the tokens; ``init_cache`` builds a rank's cache blocks.

    ``params_spec`` and ``cache_spec`` are :class:`ShapeDtype` trees (the
    float32 params', and the cache's at the shape), the shardings
    :class:`launch.sharding.NamedSharding` trees (None without a mesh)."""

    step_fn: Callable
    params_spec: Any
    cache_spec: Any
    params_shardings: Any
    cache_shardings: Any
    token_sharding: Any
    decode_fn: Callable = None
    init_cache: Callable = None
    compute_params: Callable = None
    mesh: Any = None


def _cache_compute_spec(path, spec, tokens_split: bool, axes) -> tuple:
    """The layout a rank decodes a cache leaf in: its batch dim (dim 0 of
    ``position`` and of an unstacked layer's cache, else dim 1) over the
    batch axes when the tokens split; a k or v cache's head dim over
    ``model`` as the cache places it (``cached_attention`` reads the
    block); every other dim whole."""
    n = len(spec)
    out = [None] * n
    bdim = 0 if path[0] in ("dense", "position") else 1
    if tokens_split and n > bdim:
        out[bdim] = axes
    if n and path[-1] in ("k", "v") and spec[-1] == "model":
        out[-1] = "model"
    return tuple(out)


def make_serve_step(model: Model, mesh=None, shape: ShapeSpec | None = None,
                    *, sharding_mode: str = "fsdp") -> ServeStepBundle:
    """The greedy decode step of ``model``: on one card (``mesh=None``), or
    one rank's over ``mesh`` at ``shape`` (its batch split over the batch
    axes when they divide it, the cache placed as the JAX package places
    it, the vocab and the layers split over ``model`` as in training)."""
    params_spec = cache_spec = None
    if shape is not None:
        params_spec = model.param_specs()
        cache_spec, _ = model.decode_specs(shape)

    if mesh is None:
        @torch.inference_mode()
        def step_fn(params, cache, tokens):
            logits, cache = model.decode_step(params, cache, tokens)
            return torch.argmax(logits, dim=-1).to(torch.int32), cache

        @torch.inference_mode()
        def decode_fn(params, cache, tokens):
            return model.decode_step(params, cache, tokens)

        def init_cache(params, batch, max_len, dtype):
            return model.decode_init(params, batch, max_len, dtype=dtype)

        return ServeStepBundle(step_fn, params_spec, cache_spec, None, None,
                               None, decode_fn, init_cache,
                               lambda params: params)

    if shape is None:
        raise ValueError("a mesh's serve step needs the shape it serves")
    cfg = model.cfg
    hints = pjit_hints.from_mesh(mesh)
    p_shard = shd.param_shardings(params_spec, mesh, mode=sharding_mode)
    c_shard = shd.cache_shardings(cache_spec, mesh)
    tok_shard = shd.token_sharding(shape.global_batch, mesh)
    axes = tok_shard.spec[0]
    c_pairs = tree_leaves_with_path(c_shard)
    compute = tree_unflatten(c_shard, [
        shd.NamedSharding(mesh, _cache_compute_spec(
            path, sh.spec, axes is not None, axes)) for path, sh in c_pairs])
    p_pairs = tree_leaves_with_path(params_spec)
    p_paths = [shd._key_str(p) for p, _ in p_pairs]
    p_specs = [sh.spec for sh in shd._sharding_leaves(p_shard)]

    def relayout(cache, src, dst):
        return tree_map(lambda x, a, b: shd.relayout(x, mesh, a.spec,
                                                     b.spec), cache, src, dst)

    def compute_params(params):
        """The layout a rank computes with, from its parameter blocks."""
        with torch.no_grad(), pjit_hints.hints_ctx(hints):
            return tree_unflatten(params, pjit_hints.use_params(
                tree_leaves(params), p_paths, p_specs, cfg))

    def decode(params, cache, tokens):
        cache_c = relayout(cache, c_shard, compute)
        with pjit_hints.hints_ctx(hints):
            logits, cache_c = model.decode_step(params, cache_c, tokens)
        return logits, relayout(cache_c, compute, c_shard)

    @torch.inference_mode()
    def step_fn(params, cache, tokens):
        logits, cache = decode(params, cache, tokens)
        with pjit_hints.hints_ctx(hints):
            if not (pjit_hints.vocab_split(cfg.vocab_size)
                    and pjit_hints.model_active()):
                return torch.argmax(logits, dim=-1).to(torch.int32), cache
            # the best of each rank's vocab block, then the best rank (the
            # first on ties, as argmax over the whole vocab)
            best, idx = torch.max(logits.float(), dim=-1)
            idx = idx + pjit_hints.model_rank() * logits.shape[-1]
            best = pjit_hints.gather_from_model(best[:, None], 1)
            idx = pjit_hints.gather_from_model(idx[:, None], 1)
            pick = torch.argmax(best, dim=-1, keepdim=True)
        return torch.gather(idx, 1, pick)[:, 0].to(torch.int32), cache

    @torch.inference_mode()
    def decode_fn(params, cache, tokens):
        logits, cache = decode(params, cache, tokens)
        with pjit_hints.hints_ctx(hints):
            if pjit_hints.vocab_split(cfg.vocab_size):
                logits = pjit_hints.gather_from_model(logits, -1)
        return logits, cache

    @torch.inference_mode()
    def init_cache(params, batch, max_len, dtype):
        with pjit_hints.hints_ctx(hints):
            cache = model.decode_init(params, batch, max_len, dtype=dtype)
        batch_only = tree_map(lambda sh: shd.NamedSharding(mesh, tuple(
            e if e != "model" else None for e in sh.spec)), compute)
        # the cache is built for this rank's rows, whole over ``model``
        return relayout(cache, batch_only, c_shard)

    return ServeStepBundle(step_fn, params_spec, cache_spec, p_shard,
                           c_shard, tok_shard, decode_fn, init_cache,
                           compute_params, mesh)
