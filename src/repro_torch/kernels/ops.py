"""Public entry points of the port's kernels (counterpart of
``repro.kernels.ops``).

Dispatch is by the tensors' device, inside each wrapper: CPU tensors take
the plain PyTorch version, CUDA tensors launch the hand-written kernel or
raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.golden_section import golden_section_solve
from repro_torch.kernels.hier_aggregate import hier_aggregate
from repro_torch.utils import tree_leaves, tree_unflatten

__all__ = ["golden_section_solve", "hier_aggregate", "hier_aggregate_tree"]


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
