"""The serve step for one card: a decode step, then greedy argmax. Port of
``repro.launch.steps.make_serve_step`` without meshes or shardings; the
train steps come with the training slice (ROADMAP queue 1 item 10(g)).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import Model


def make_serve_step(model: Model) -> Callable:
    """``step(params, cache, tokens (B,)) -> (next_tokens (B,) int32,
    cache)``, one greedy decode step. The cache is updated in place."""

    @torch.inference_mode()
    def serve_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step
