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

from repro_torch.utils import tree_global_norm, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable      # (grads, state, params, step) -> (updates, state)


def _lr_at(lr, step):
    return lr(step) if callable(lr) else lr


def _pow(base: float, t: torch.Tensor) -> torch.Tensor:
    """``base ** t`` in float32, as JAX computes a Python float to the
    power of an int32 array."""
    return torch.pow(torch.tensor(base, dtype=torch.float32,
                                  device=t.device), t.to(torch.float32))


def sgd(lr, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params, step):
        lr_t = _lr_at(lr, step)
        if momentum == 0.0:
            return tree_map(lambda g: -lr_t * g, grads), ()
        new_m = tree_map(lambda m, g: momentum * m + g, state, grads)
        if nesterov:
            upd = tree_map(lambda m, g: -lr_t * (momentum * m + g), new_m,
                           grads)
        else:
            upd = tree_map(lambda m: -lr_t * m, new_m)
        return upd, new_m

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params, step):
        lr_t = _lr_at(lr, step)
        t = step + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) *
                     torch.square(g.to(torch.float32)), state["v"], grads)
        bc1 = 1 - _pow(b1, t)
        bc2 = 1 - _pow(b2, t)

        def upd(m_, v_, p):
            step_ = m_ / bc1 / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                step_ = step_ + weight_decay * p.to(torch.float32)
            return (-lr_t * step_).to(p.dtype)

        return tree_map(upd, m, v, params), {"m": m, "v": v}

    return Optimizer(init, update)


def clip_by_global_norm(opt: Optimizer, max_norm: float) -> Optimizer:
    def update(grads, state, params, step):
        norm = tree_global_norm(grads)
        scale = torch.clamp_max(torch.full_like(norm, max_norm)
                                / torch.clamp_min(norm, 1e-12), 1.0)
        clipped = tree_map(lambda g: g * scale.to(g.dtype), grads)
        return opt.update(clipped, state, params, step)

    return Optimizer(opt.init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
