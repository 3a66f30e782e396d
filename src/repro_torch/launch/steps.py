"""Train and serve steps for one card. Port of ``repro.launch.steps``
without meshes or shardings.

Two training modes realize the paper's Algorithm 1 at datacenter scale:

* ``sync`` — conventional fully-synchronous training: one parameter copy,
  one gradient over the whole batch. The flat-FedAvg analogue and the
  baseline.

* ``hierarchical`` (HFEL) — parameters and optimizer state carry a
  leading ``pod`` axis (one copy per pod); each step trains every pod on
  its own slice of the batch (eq. (8)'s edge tier), and
  ``cloud_sync_fn`` averages parameters and AdamW moments across pods
  (eq. (14)), once per I steps, optionally through a compressor.

On one card the pods are slices of one tensor and the step loops over
them: forward, backward and update per pod, so one pod's activations and
gradients live at a time. The result is JAX's: its loss is the mean of
the pod losses (so each pod's gradient carries 1/n_pods), and its
optimizer is vmapped over pods (so the global-norm clip is taken per
pod).

The step writes the new parameters and optimizer state into the trees it
was given, in place (the JAX step donates them), and returns them. The
update goes one leaf at a time (``Optimizer.apply_``), each gradient
released once used, so beside the parameters, moments and gradients it
holds a few copies of one leaf, not of the tree.

Serving (``make_serve_step``) is one greedy decode step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.models import Model, ShapeSpec
from repro_torch.optim import Optimizer, adamw, clip_by_global_norm
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

MODES = ("sync", "hierarchical")


def make_optimizer(lr: float = 3e-4, clip: float = 1.0) -> Optimizer:
    return clip_by_global_norm(adamw(lr), clip)


@dataclass
class TrainStepBundle:
    """What ``make_train_step`` builds. ``step_fn(params, opt_state, step,
    batch, clock=None) -> (params, opt_state, step + 1, loss)``;
    ``cloud_sync_fn(params, opt_state) -> (params, opt_state)`` in
    hierarchical mode, else None. ``clock``, when given, is called with
    "forward", "backward", "optimizer" and "end" at the boundaries of the
    step's parts (the first three once per pod), to time them."""

    step_fn: Callable
    cloud_sync_fn: Callable | None
    batch_spec: dict
    optimizer: Optimizer
    mode: str
    n_pods: int
    device: torch.device

    def init_state(self, params) -> tuple[Any, Any, torch.Tensor]:
        """(params, opt_state, step 0) to start from ``params`` (one
        model's tree): in hierarchical mode every pod gets its own copy."""
        if self.mode == "hierarchical":
            params = tree_map(lambda p: p.expand(self.n_pods, *p.shape)
                              .clone(), params)
        return (params, self.optimizer.init(params),
                torch.zeros((), dtype=torch.int32, device=self.device))


def _loss_and_grads(model: Model, params, batch, scale: float, clock):
    """(loss, grads of ``scale * loss`` with respect to every leaf, a list
    in ``tree_leaves`` order)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    clock("forward")
    loss = model.loss(tree_unflatten(params, leaves), batch)
    clock("backward")
    grads = torch.autograd.grad(loss * scale, leaves)
    return loss.detach(), list(grads)


def make_train_step(model: Model, shape: ShapeSpec, *, mode: str = "sync",
                    lr: float = 3e-4, compressor=None, n_pods: int = 2,
                    batch_override: int | None = None,
                    device=None) -> TrainStepBundle:
    """The train step of ``mode`` for ``model`` at ``shape`` (its batch
    ``batch_override`` or the shape's global batch), with
    :func:`make_optimizer`'s AdamW under a global-norm clip of 1.0.
    ``device=None`` means CUDA (raising without a card)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    dev = resolve_device(device)
    opt = make_optimizer(lr)
    hierarchical = mode == "hierarchical"
    if hierarchical and n_pods < 2:
        raise ValueError("hierarchical mode needs at least 2 pods")
    batch_spec = model.batch_specs(shape, batch_override=batch_override)
    b = batch_spec["tokens"][0][0]
    if hierarchical and b % n_pods:
        raise ValueError(f"batch {b} does not split into {n_pods} pods")

    def no_clock(_):
        return None

    def sync_step(params, opt_state, step, batch, clock=None):
        clock = clock or no_clock
        loss, grads = _loss_and_grads(model, params, batch, 1.0, clock)
        clock("optimizer")
        opt.apply_(grads, opt_state, params, step)
        clock("end")
        return params, opt_state, step + 1, loss

    def hier_step(params, opt_state, step, batch, clock=None):
        clock = clock or no_clock
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


def make_serve_step(model: Model) -> Callable:
    """``step(params, cache, tokens (B,)) -> (next_tokens (B,) int32,
    cache)``, one greedy decode step. The cache is updated in place."""

    @torch.inference_mode()
    def serve_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step
