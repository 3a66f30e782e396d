"""Learning-rate schedules (callables of the step index, a 0-dim integer
tensor), returning float32 tensors on the step's device. Port of
``repro.optim.schedules``."""

from __future__ import annotations

import math

import torch


def _f32(x, step) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32,
                           device=getattr(step, "device", None))


def constant(lr: float):
    return lambda step: _f32(lr, step)


def cosine_decay(peak: float, total_steps: int, floor: float = 0.0):
    def fn(step):
        frac = torch.clamp(_f32(step, step)
                           / _f32(float(max(total_steps, 1)), step), 0.0, 1.0)
        return floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))

    return fn


def linear_warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                         floor: float = 0.0):
    cos = cosine_decay(peak, max(total_steps - warmup_steps, 1), floor)

    def fn(step):
        step = torch.as_tensor(step)
        warm = (peak * _f32(step, step)
                / _f32(float(max(warmup_steps, 1)), step))
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))

    return fn
