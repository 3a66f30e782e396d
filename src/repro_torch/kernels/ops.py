"""Public entry points of the port's kernels (counterpart of
``repro.kernels.ops``).

Dispatch is by the tensors' device, inside each wrapper: CPU tensors take
the plain PyTorch version, CUDA tensors launch the hand-written kernel or
raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels.golden_section import golden_section_solve
from repro_torch.kernels.hier_aggregate import hier_aggregate
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_scan import ssd_state_scan
from repro_torch.utils import tree_leaves, tree_unflatten

__all__ = ["flash_attention", "golden_section_solve", "hier_aggregate",
           "hier_aggregate_tree", "rmsnorm", "ssd_state_scan"]


def flash_attention(q, k, v, causal: bool = True, block_q: int = 512,
                    block_kv: int = 512):
    """Flash attention forward, with the JAX package's signature. Forward
    only: the backward (a reference-recompute ``torch.autograd.Function``,
    as the JAX package's custom VJP) comes with the training slice, so a
    call that would need a gradient raises."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward yet: ROADMAP queue 1 item "
            "10(g), training")
    return _flash.flash_attention(q, k, v, causal=causal, block_q=block_q,
                                  block_kv=block_kv)


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
