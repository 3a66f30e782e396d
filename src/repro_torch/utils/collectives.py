"""Collectives over one process group, along tensor dims.

The mesh code (``launch.sharding``, ``models.pjit_hints``,
``core.hierarchy``) moves tensors between ranks through these
functions. Each returns its input unchanged on a group of one rank (so a
one-rank mesh computes the bits of no mesh), sums in float32 whatever the
input dtype and casts back, and moves bfloat16 and float16 as float32
(exact both ways), since gloo's support of the narrow types varies by
version.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_WIDE = (torch.bfloat16, torch.float16)


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: the ``op`` ("sum" or "max") of ``x`` over ``group``,
    computed in float32 for a floating ``x``, in ``x``'s dtype."""
    if size(group) == 1:
        return x
    wide = x.is_floating_point() and x.dtype != torch.float64
    out = x.to(torch.float32, copy=True) if wide else x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=group)
    return out.to(x.dtype)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order."""
    n = size(group)
    if n == 1:
        return x
    dim = dim % x.ndim
    src = x.movedim(dim, 0)
    src = (src.to(torch.float32) if x.dtype in _WIDE else src).contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(x.dtype).movedim(0, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of the ranks' ``x``
    (``x.shape[dim]`` a multiple of the group's size), summed in
    float32."""
    n = size(group)
    if n == 1:
        return x
    dim = dim % x.ndim
    src = x.movedim(dim, 0).to(torch.float32).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(x.dtype).movedim(0, dim)


def all_to_all(x: torch.Tensor, group, split_dim: int,
               cat_dim: int) -> torch.Tensor:
    """``x`` split along ``split_dim`` into one block a rank (block i to
    rank i), and the blocks this rank receives joined along ``cat_dim`` in
    group-rank order: a tensor split over the group on ``cat_dim`` becomes
    one split on ``split_dim``."""
    n = size(group)
    if n == 1:
        return x
    s, c = split_dim % x.ndim, cat_dim % x.ndim
    src = x.movedim(s, 0)
    src = (src.to(torch.float32) if x.dtype in _WIDE else src).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    # (n, block, *rest): rank i's block; n joins the cat dim as its major
    out = out.view(n, src.shape[0] // n, *src.shape[1:])
    at = 1 + [d for d in range(x.ndim) if d != s].index(c)
    out = out.movedim(0, at).flatten(at, at + 1)
    return out.to(x.dtype).movedim(0, s)


def probe(group, device) -> dict:
    """Whether the backend of ``group`` carries ``all_gather_into_tensor``,
    ``reduce_scatter_tensor`` and ``all_to_all_single`` on tensors of
    ``device`` (a collective call on every rank of the group)."""
    n = size(group)
    x = torch.arange(n * 2, dtype=torch.float32, device=device)
    got = {}
    for op, fn in (
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                x.new_empty(n * 2 * n), x, group=group)),
            ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
                x.new_empty(2), x, group=group)),
            ("all_to_all_single", lambda: dist.all_to_all_single(
                torch.empty_like(x), x, group=group))):
        try:
            fn()
            got[op] = True
        except (RuntimeError, NotImplementedError, ValueError) as exc:
            got[op] = f"refused: {str(exc).splitlines()[0][:120]}"
    return got
