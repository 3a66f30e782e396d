"""Update compression for the expensive (cloud / pod-axis) tier. Port of
``repro.core.compression``.

The paper attacks WAN communication cost architecturally (edge aggregation);
these operators attack it numerically — the standard distributed-optimization
companions for hierarchical FL at datacenter scale:

* :class:`TopKCompressor` — magnitude top-k sparsification with error
  feedback (the residual is carried into the next round, preserving
  convergence).
* :class:`Int8Compressor` — symmetric per-tensor int8 quantization of
  updates (4x over f32, 2x over bf16 on the wire).

Both operate leaf-wise on trees of tensors and report their wire bytes so
the collective-term savings can be accounted.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.utils import (tree_leaves, tree_map, tree_unflatten,
                               tree_zeros_like)


@dataclass(frozen=True)
class TopKCompressor:
    """Keep the top ``ratio`` fraction of entries (by magnitude) per leaf."""

    ratio: float = 0.01

    def init_state(self, params):
        return tree_zeros_like(params)          # error-feedback residual

    def compress(self, update, state):
        """Returns (sparse_update, new_state). sparse_update is dense-shaped
        with zeros off-support (the wire format would ship indices+values;
        wire_bytes() accounts for that). Every entry whose magnitude ties
        the k-th largest is kept, as in the JAX package."""

        def one(u, e):
            x = u + e
            mag = torch.abs(x)
            k = max(int(x.numel() * self.ratio), 1)
            thresh = torch.topk(mag.reshape(-1), k, sorted=False).values.min()
            kept = torch.where(mag >= thresh, x, torch.zeros_like(x))
            return kept, x - kept

        pairs = [one(u, e) for u, e in zip(tree_leaves(update),
                                           tree_leaves(state))]
        return (tree_unflatten(update, [kept for kept, _ in pairs]),
                tree_unflatten(update, [resid for _, resid in pairs]))

    def wire_bytes(self, params) -> int:
        """4B value + 4B index per kept entry."""
        return sum(8 * max(int(leaf.numel() * self.ratio), 1)
                   for leaf in tree_leaves(params))


@dataclass(frozen=True)
class Int8Compressor:
    """Symmetric per-tensor int8 quantization with straight-through dequant.
    The scale is a tensor and divides as one; ``torch.round`` rounds half
    to even, as ``jnp.round`` does."""

    def init_state(self, params):
        return ()

    def compress(self, update, state):
        def one(u):
            scale = (torch.clamp_min(torch.max(torch.abs(u)), 1e-12)
                     / torch.tensor(127.0, dtype=u.dtype, device=u.device))
            q = torch.clamp(torch.round(u / scale), -127, 127).to(torch.int8)
            return q.to(u.dtype) * scale

        return tree_map(one, update), state

    def wire_bytes(self, params) -> int:
        return sum(leaf.numel() + 4 for leaf in tree_leaves(params))


def no_compression_bytes(params, dtype_bytes: int = 4) -> int:
    return sum(leaf.numel() * dtype_bytes for leaf in tree_leaves(params))
