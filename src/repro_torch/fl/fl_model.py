"""The paper's federated learning tasks: multinomial logistic regression and
a small MLP (image-classification stand-ins for MNIST/FEMNIST), with masked
full-batch loss as the paper trains (full batch size). Port of
``repro.fl.fl_model``.

Every function takes params with optional leading batch axes: ``x`` (S, D)
with one model's params, or ``x`` (N, S, D) with client-stacked params
(N, ...), whose products are batched matrix products. Init draws from an
explicit ``torch.Generator``; it does not reproduce ``jax.random``, so
parity with the JAX package carries its initial params across
(:func:`repro_torch.convert.fl_params_from_numpy`).
"""

from __future__ import annotations

import torch


def mlr_init(gen: torch.Generator, dim: int, n_classes: int):
    return {"w": torch.randn(dim, n_classes, generator=gen) * 0.01,
            "b": torch.zeros(n_classes)}


def mlr_logits(params, x):
    return x @ params["w"] + params["b"][..., None, :]


def mlp_init(gen: torch.Generator, dim: int, n_classes: int,
             hidden: int = 128):
    return {"w1": torch.randn(dim, hidden, generator=gen) * dim ** -0.5,
            "b1": torch.zeros(hidden),
            "w2": torch.randn(hidden, n_classes, generator=gen)
            * hidden ** -0.5,
            "b2": torch.zeros(n_classes)}


def mlp_logits(params, x):
    h = torch.relu(x @ params["w1"] + params["b1"][..., None, :])
    return h @ params["w2"] + params["b2"][..., None, :]


def masked_loss(logits_fn, params, x, y):
    """Full-batch CE over the sample axis; y == -1 marks padding (clients
    have ragged data). One loss per leading batch entry."""
    logits = logits_fn(params, x)
    mask = (y >= 0).to(logits.dtype)
    y_safe = torch.clamp_min(y, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y_safe[..., None])[..., 0]
    return (torch.sum((logz - gold) * mask, dim=-1)
            / torch.clamp_min(torch.sum(mask, dim=-1), 1.0))


def accuracy(logits_fn, params, x, y):
    pred = torch.argmax(logits_fn(params, x), dim=-1)
    mask = (y >= 0).to(torch.float32)
    hits = (pred == y).to(torch.float32) * mask
    return torch.sum(hits, dim=-1) / torch.clamp_min(torch.sum(mask, dim=-1),
                                                     1.0)


MODELS = {
    "mlr": (mlr_init, mlr_logits),
    "mlp": (mlp_init, mlp_logits),
}
