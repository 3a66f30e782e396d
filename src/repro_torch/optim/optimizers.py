"""Optimizers from scratch: SGD(+momentum), AdamW, global-norm clipping,
in the (init, update) transformation style. Port of
``repro.optim.optimizers``.

Trees are the nested dicts of tensors of ``repro_torch.utils.trees``;
``update`` returns new trees and leaves its inputs as they are. ``step``
is a 0-dim integer tensor (int32, as the JAX train step carries it), and
every scalar that JAX computes as a float32 array from it (the bias
corrections ``1 - b ** t``, the learning rate of a schedule) is a float32
tensor on the step's device here, and divides as a tensor: a CUDA
division by a Python scalar multiplies by its reciprocal, which rounds
otherwise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.utils import (tree_global_norm, tree_leaves, tree_map,
                               tree_unflatten)


class Optimizer(NamedTuple):
    init: Callable
    update: Callable      # (grads, state, params, step) -> (updates, state)
    # ``update`` then ``apply_updates``, the same numbers, written into
    # ``state`` and ``params`` in place one leaf at a time: (grads, state,
    # params, step) -> None, ``grads`` a list in leaf order whose entries
    # are released as they are used, so the transient is a few copies of
    # one leaf, not of the tree (as the JAX step's donated buffers give)
    apply_: Callable


def _lr_at(lr, step):
    return lr(step) if callable(lr) else lr


def _pow(base: float, t: torch.Tensor) -> torch.Tensor:
    """``base ** t`` in float32, as JAX computes a Python float to the
    power of an int32 array."""
    return torch.pow(torch.tensor(base, dtype=torch.float32,
                                  device=t.device), t.to(torch.float32))


def _update_tree(leaf, grads, states, params):
    """``leaf(g, p, *s) -> (*new s, update)`` over the leaves (``states``
    holds each leaf's tuple of state leaves): (the updates as a tree, the
    new state leaves as one list per tuple position)."""
    outs = [leaf(g, p, *s) for g, p, s in zip(tree_leaves(grads),
                                              tree_leaves(params), states)]
    cols = [list(col) for col in zip(*outs)]
    return tree_unflatten(params, cols[-1]), cols[:-1]


def _apply_in_place(leaf, grads, states, params) -> None:
    """``_update_tree`` and ``apply_updates`` one leaf at a time, into the
    state and parameter leaves, each gradient dropped once used."""
    for i, (p, s) in enumerate(zip(tree_leaves(params), states)):
        g, grads[i] = grads[i], None
        *new, u = leaf(g, p, *s)
        del g
        for old, n in zip(s, new):
            old.copy_(n)
        p.copy_(p + u.to(p.dtype))


def sgd(lr, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def states(state, params):
        if momentum == 0.0:
            return [()] * len(tree_leaves(params))
        return [(m,) for m in tree_leaves(state)]

    def leaf(step):
        lr_t = _lr_at(lr, step)

        def one(g, p, *m_):
            if momentum == 0.0:
                return (-lr_t * g,)
            m = momentum * m_[0] + g
            return m, (-lr_t * (momentum * m + g) if nesterov
                       else -lr_t * m)
        return one

    def update(grads, state, params, step):
        upd, new = _update_tree(leaf(step), grads, states(state, params),
                                params)
        return upd, (tree_unflatten(params, new[0]) if new else ())

    def apply_(grads, state, params, step):
        _apply_in_place(leaf(step), grads, states(state, params), params)

    return Optimizer(init, update, apply_)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def states(state):
        return list(zip(tree_leaves(state["m"]), tree_leaves(state["v"])))

    def leaf(step):
        lr_t = _lr_at(lr, step)
        t = step + 1
        bc1 = 1 - _pow(b1, t)
        bc2 = 1 - _pow(b2, t)

        def one(g, p, m_, v_):
            g = g.to(torch.float32)
            m = b1 * m_ + (1 - b1) * g
            v = b2 * v_ + (1 - b2) * torch.square(g)
            del g
            step_ = m / bc1 / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step_ = step_ + weight_decay * p.to(torch.float32)
            return m, v, (-lr_t * step_).to(p.dtype)
        return one

    def update(grads, state, params, step):
        upd, (m, v) = _update_tree(leaf(step), grads, states(state), params)
        return upd, {"m": tree_unflatten(params, m),
                     "v": tree_unflatten(params, v)}

    def apply_(grads, state, params, step):
        _apply_in_place(leaf(step), grads, states(state), params)

    return Optimizer(init, update, apply_)


def clip_by_global_norm(opt: Optimizer, max_norm: float, *,
                        norm: Callable = tree_global_norm) -> Optimizer:
    """Scale the gradients by ``min(1, max_norm / |g|)``. ``norm`` computes
    |g| of a gradient tree (or list); a rank of a mesh passes one that
    counts each distinct block once and sums over the ranks
    (``launch.sharding.global_norm_fn``)."""
    def clip_scale(grads):
        norm_ = norm(grads)
        return torch.clamp_max(torch.full_like(norm_, max_norm)
                               / torch.clamp_min(norm_, 1e-12), 1.0)

    def update(grads, state, params, step):
        scale = clip_scale(grads)
        clipped = tree_map(lambda g: g * scale.to(g.dtype), grads)
        return opt.update(clipped, state, params, step)

    def apply_(grads, state, params, step):
        scale = clip_scale(grads)
        # each entry replaced, not scaled in place: autograd may hand two
        # leaves one tensor
        for i in range(len(grads)):
            grads[i] = grads[i] * scale.to(grads[i].dtype)
        opt.apply_(grads, state, params, step)

    return Optimizer(opt.init, update, apply_)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
