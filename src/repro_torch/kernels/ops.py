"""Public entry points of the port's kernels (counterpart of
``repro.kernels.ops``).

Dispatch is by the tensors' device, inside each wrapper: CPU tensors take
the plain PyTorch version, CUDA tensors launch the hand-written kernel or
raise.

``flash_attention``, ``rmsnorm`` and ``ssd_state_scan`` are differentiable:
when an input needs a gradient the call goes through the kernel's
``torch.autograd.Function``, whose forward is the same dispatch. Flash's
backward dispatches the same way (its backward kernel on the card);
rmsnorm's and the scan's backward is one plain PyTorch function on both
devices. Without a gradient the call goes to the dispatch directly.

The dispatches are PyTorch operators (``torch.ops.repro_torch.
flash_attention_fwd``, ``flash_attention_backward``, ``rmsnorm``,
``ssd_state_scan``; the Functions call them too): each has a fake
implementation, so a step on fake tensors (``launch/dryrun.py``) sees the
kernel's outputs without running the plain version, and a FLOP formula,
so ``FlopCounterMode`` counts the kernel's work (the bound's count) on
either device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels import ssd_scan as _ssd_scan
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.golden_section import golden_section_solve
from repro_torch.kernels.hier_aggregate import hier_aggregate
from repro_torch.utils import tree_leaves, tree_unflatten

__all__ = ["flash_attention", "flash_attention_fwd", "golden_section_solve",
           "hier_aggregate", "hier_aggregate_tree", "rmsnorm",
           "ssd_state_scan"]


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def flash_attention(q, k, v, causal: bool = True, block_q: int = 512,
                    block_kv: int = 512, scale: float | None = None):
    """Flash attention with the JAX package's signature and an optional
    score ``scale`` (default hd ** -0.5), differentiable
    (:class:`flash_attention.FlashAttentionFn`)."""
    if _needs_grad(q, k, v):
        return _flash.FlashAttentionFn.apply(q, k, v, causal, block_q,
                                             block_kv, scale)
    return flash_attention_fwd(q, k, v, causal=causal, block_q=block_q,
                               block_kv=block_kv, softmax_scale=scale)


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """RMSNorm over the last axis, differentiable
    (:class:`rmsnorm.RMSNormFn`)."""
    if _needs_grad(x, scale):
        return _rmsnorm.RMSNormFn.apply(x, scale, eps)
    return _rmsnorm.rmsnorm_op(x, scale, eps)


def ssd_state_scan(states, decay, initial_state=None):
    """The SSD inter-chunk recurrence, differentiable
    (:class:`ssd_scan.SSDStateScanFn`)."""
    if _needs_grad(states, decay, initial_state):
        return _ssd_scan.SSDStateScanFn.apply(states, decay, initial_state)
    return _ssd_scan.ssd_state_scan_op(states, decay, initial_state)


def hier_aggregate_tree(trees: list, weights):
    """Weighted-average a list of trees through the kernel: flatten each
    tree, stack, one launch, unflatten into the first tree's structure."""
    stacked = torch.stack([torch.cat([leaf.reshape(-1)
                                      for leaf in tree_leaves(t)])
                           for t in trees])
    merged = hier_aggregate(stacked, torch.as_tensor(
        weights, dtype=torch.float32, device=stacked.device))
    out, off = [], 0
    for leaf in tree_leaves(trees[0]):
        out.append(merged[off:off + leaf.numel()].reshape(leaf.shape)
                   .to(leaf.dtype))
        off += leaf.numel()
    return tree_unflatten(trees[0], out)
