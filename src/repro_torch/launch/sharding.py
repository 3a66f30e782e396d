"""Partition rules for the model zoo. Port of ``repro.launch.sharding``.

Rules map parameter path suffixes to logical roles and pick a spec subject
to divisibility by the mesh axis sizes (uneven dims fall back to the next
candidate or to replication — e.g. whisper's 51866 vocab is not
16-divisible, so its embedding shards d_model instead).

Modes:
  * ``tp``   — tensor parallelism over ``model`` only; replicated over data.
  * ``fsdp`` — tp + the complementary large dim sharded over ``data``
               (ZeRO-3-style: a rank gathers the leaf before use, and
               reduce-scatters its gradient).

Stacked block parameters carry a leading layer axis which is never sharded.

A spec is a tuple with one entry per tensor dim: an axis name, a tuple of
axis names (split pod-major: ``("pod", "data")`` puts pod p, data d at
block ``p * n_data + d``, as JAX lays it out), or None (replicated). The
rules take a ``torch.distributed`` device mesh or a plain mapping of axis
sizes, so the production meshes can be checked without their ranks.
:class:`NamedSharding` binds a spec to a mesh: its DTensor
``placements``, the shape and the slice of a rank's block.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.launch.mesh import axis_sizes, coordinates
from repro_torch.utils import (tree_leaves, tree_leaves_with_path, tree_map,
                               tree_unflatten)
from repro_torch.utils import collectives as coll


# (suffix regex, (model_dim_candidates, data_dim_candidates))
# dims are indices from the END of the shape (negative indexing), tried in
# order until one divides the axis size.
_RULES = [
    # embeddings: vocab over model ONLY — sharding D over data makes the
    # unembed contraction dim sharded, and the read-out would then gather
    # the full batch of float32 logits. V-over-model keeps both the embed
    # lookup and the logits product local.
    (r"embed/table$", ((-2, -1), ())),            # (V, D)
    (r"unembed/w$", ((-1, -2), ())),              # (D, V)
    (r"(wq|wk|wv|wi|wg)/w$", ((-1,), (-2,))),     # (D, F): F tp, D fsdp
    (r"wo/w$", ((-2,), (-1,))),                   # (F, D): F tp, D fsdp
    (r"wkv_a/w$", ((), (-2,))),                   # MLA down-proj (small)
    (r"wkv_b/w$", ((-1,), (-2,))),
    (r"router/w$", ((), (-2,))),
    (r"experts/.*?/w$", ((-3,), (-1,))),          # (E, a, b): experts -> EP
    (r"in_proj/w$", ((-1,), (-2,))),              # ssm
    (r"out_proj/w$", ((-2,), (-1,))),
    (r"conv_w$", ((-1,), ())),                    # (K, C): channels tp
    (r"pos_embed$", ((), (-2,))),
    (r"(a_log|d_skip|dt_bias|norm_scale|scale|bias|q_norm|k_norm|conv_b|/b)$",
     ((), ())),
]


def _key_str(path) -> str:
    return "/".join(str(p) for p in path)


def _pick(shape, candidates, axis_size, taken):
    for c in candidates:
        dim = len(shape) + c if c < 0 else c
        if 0 <= dim < len(shape) and dim not in taken \
                and shape[dim] % axis_size == 0 and shape[dim] >= axis_size:
            return dim
    return None


def param_pspec(path_str: str, shape, mesh, *, mode: str = "fsdp") -> tuple:
    """The spec of the parameter at ``path_str`` (its tree path joined by
    ``/``) of ``shape`` on ``mesh`` (a device mesh or a mapping of axis
    sizes with ``data`` and ``model``)."""
    shape = tuple(shape)
    if not shape:                       # scalars
        return ()
    sizes = axis_sizes(mesh)
    model_size = sizes["model"]
    data_size = sizes["data"]
    spec = [None] * len(shape)
    for pattern, (model_cands, data_cands) in _RULES:
        if re.search(pattern, path_str):
            taken = set()
            dim = _pick(shape, model_cands, model_size, taken)
            if dim is not None:
                spec[dim] = "model"
                taken.add(dim)
            if mode == "fsdp":
                dim = _pick(shape, data_cands, data_size, taken)
                if dim is not None:
                    spec[dim] = "data"
            return tuple(spec)
    # fallback heuristic: biggest divisible dim -> model, next -> data
    order = np.argsort(shape)[::-1]
    taken = set()
    for dim in order:
        dim = int(dim)
        if shape[dim] >= 1024 and shape[dim] % model_size == 0:
            spec[dim] = "model"
            taken.add(dim)
            break
    if mode == "fsdp":
        for dim in order:
            dim = int(dim)
            if dim not in taken and shape[dim] >= 1024 \
                    and shape[dim] % data_size == 0:
                spec[dim] = "data"
                break
    return tuple(spec)


def _axes(entry) -> tuple:
    """The axis names of one spec entry, outermost first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> dict:
    """``{axis name: tensor dim}`` of the axes that ``spec`` splits on."""
    return {a: d for d, entry in enumerate(spec) for a in _axes(entry)}


@dataclass(frozen=True)
class NamedSharding:
    """``spec`` laid over ``mesh`` (a device mesh, or a mapping of axis
    sizes for what needs no ranks)."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> list:
        """DTensor placements, one per mesh dim: ``Shard(d)`` where the
        mesh axis splits tensor dim ``d``, else ``Replicate()``. Two mesh
        axes on one dim split it left to right, pod-major, as the spec
        does."""
        from torch.distributed.tensor import Replicate, Shard
        on = spec_axes(self.spec)
        return [Shard(on[a]) if a in on else Replicate()
                for a in axis_sizes(self.mesh)]

    def block(self, shape, coords: dict | None = None) -> tuple:
        """The slices of the block of a tensor of ``shape`` that the rank
        at ``coords`` (default: this rank's coordinates) holds."""
        sizes = axis_sizes(self.mesh)
        coords = coordinates(self.mesh) if coords is None else coords
        out = []
        for n, entry in zip(shape, tuple(self.spec) + (None,) * len(shape)):
            parts, index = 1, 0
            for a in _axes(entry):
                parts, index = parts * sizes[a], index * sizes[a] + coords[a]
            step = n // parts
            out.append(slice(index * step, (index + 1) * step))
        return tuple(out)

    def shard_shape(self, shape) -> tuple:
        """The shape of one rank's block."""
        sizes = axis_sizes(self.mesh)
        out = list(shape)
        for d, entry in enumerate(self.spec):
            for a in _axes(entry):
                out[d] //= sizes[a]
        return tuple(out)

    def local(self, full: torch.Tensor, coords: dict | None = None):
        """This rank's block of ``full`` (a copy, contiguous)."""
        return full[self.block(full.shape, coords)].clone(
            memory_format=torch.contiguous_format)


def param_shardings(params_spec, mesh, *, mode: str = "fsdp"):
    """A tree of :class:`NamedSharding` matching a params tree (of tensors
    or anything with a ``shape``)."""
    pairs = tree_leaves_with_path(params_spec)
    return tree_unflatten(params_spec, [
        NamedSharding(mesh, param_pspec(_key_str(p), leaf.shape, mesh,
                                        mode=mode)) for p, leaf in pairs])


def hier_param_shardings(params_spec, mesh, *, mode: str = "fsdp"):
    """Shardings of pod-stacked parameters (leading pod dim):
    ``("pod", *<the per-param rule of the rest>)``."""
    pairs = tree_leaves_with_path(params_spec)
    return tree_unflatten(params_spec, [
        NamedSharding(mesh, ("pod",) + param_pspec(
            _key_str(p), tuple(leaf.shape)[1:], mesh, mode=mode))
        for p, leaf in pairs])


def batch_pspec(mesh) -> tuple:
    axes = ("pod", "data") if "pod" in axis_sizes(mesh) else "data"
    return (axes,)


def _batch(mesh) -> tuple[int, tuple]:
    sizes = axis_sizes(mesh)
    axes = ("pod", "data") if "pod" in sizes else ("data",)
    return sizes.get("data", 1) * sizes.get("pod", 1), axes


def batch_shardings(batch_spec, mesh, *, batch_divisible=True):
    """Shard every batch leaf on its leading (batch) dim when divisible."""
    n_batch_shards, axes = _batch(mesh)

    def one(leaf):
        shape = tuple(leaf.shape)
        if shape and shape[0] % n_batch_shards == 0 \
                and shape[0] >= n_batch_shards:
            return NamedSharding(mesh, (axes,) + (None,) * (len(shape) - 1))
        return NamedSharding(mesh, (None,) * len(shape))

    return tree_map(one, batch_spec)


def cache_shardings(cache_spec, mesh):
    """Decode-cache sharding: batch dim over (pod,)data when divisible,
    then a trailing structured dim (kv head dim, SSM head dim, MLA rank)
    over model when one divides; else replicated.

    Cache leaves are stacked (L, B, ...) — dim 1 is batch."""
    n_batch, axes = _batch(mesh)
    model_size = axis_sizes(mesh)["model"]

    def one(leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if len(shape) >= 2 and shape[1] % n_batch == 0 \
                and shape[1] >= n_batch:
            spec[1] = axes
        for dim in range(len(shape) - 1, 1, -1):
            if shape[dim] % model_size == 0 and shape[dim] >= model_size:
                spec[dim] = "model"
                break
        return NamedSharding(mesh, tuple(spec))

    return tree_map(one, cache_spec)


def token_sharding(batch: int, mesh) -> NamedSharding:
    """The greedy tokens' (B,) sharding: over the batch axes when they
    divide ``batch``."""
    n_batch, axes = _batch(mesh)
    split = batch % n_batch == 0 and batch >= n_batch
    return NamedSharding(mesh, (axes,) if split else (None,))


# ---------------------------------------------------------------------------
# Moving a rank's blocks (every rank of the mesh calls these together)
# ---------------------------------------------------------------------------

def _gather(x: torch.Tensor, mesh, spec, keep=()) -> torch.Tensor:
    """``x`` (this rank's block of ``spec``) gathered over every axis of
    the spec but those in ``keep``, innermost axis first."""
    for d, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            if a not in keep:
                x = coll.all_gather(x, mesh.get_group(a), d)
    return x


def relayout(x: torch.Tensor, mesh, src, dst) -> torch.Tensor:
    """``x``, this rank's block under spec ``src``, as its block under
    ``dst``: gathered over the axes ``src`` splits on and ``dst`` does not
    split on the same dim, then narrowed to ``dst``'s block; where the two
    differ only by one axis moved from one dim to another, one all-to-all
    over that axis (each rank sends the others their blocks, not the
    whole). Returns ``x`` itself when the two agree."""
    src, dst = tuple(src), tuple(dst)
    if src == dst:
        return x
    moved = [d for d, (s, t) in enumerate(zip(src, dst)) if s != t]
    if len(moved) == 2:
        a, b = moved
        if dst[a] is None and src[b] is None:
            a, b = b, a              # the axis moves from dim b to dim a
        axes = _axes(src[b])
        if src[a] is None and dst[b] is None and len(axes) == 1 \
                and _axes(dst[a]) == axes:
            return coll.all_to_all(x, mesh.get_group(axes[0]), a, b)
    keep = {a for d, (s, t) in enumerate(zip(src, dst))
            for a in _axes(s) if _axes(s) == _axes(t)}
    full = _gather(x, mesh, src, keep)
    kept = tuple(s if _axes(s) == _axes(t) else None
                 for s, t in zip(src, dst))
    if kept == dst:
        return full
    # narrow the dims dst splits and the gathered tensor does not
    sizes, coords = axis_sizes(mesh), coordinates(mesh)
    index = []
    for d, (k, t) in enumerate(zip(kept, dst)):
        if _axes(k) == _axes(t):
            index.append(slice(None))
            continue
        parts, i = 1, 0
        for a in _axes(t):
            parts, i = parts * sizes[a], i * sizes[a] + coords[a]
        step = full.shape[d] // parts
        index.append(slice(i * step, (i + 1) * step))
    return full[tuple(index)].contiguous()


def gather_full(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The whole tensor from every rank's block (all ranks get it)."""
    return _gather(x, sharding.mesh, sharding.spec)


def shard_tree(tree, shardings):
    """Each rank's blocks of a tree of whole tensors (the same on every
    rank)."""
    return tree_map(lambda x, s: s.local(x), tree, shardings)


def gather_tree(tree, shardings):
    """The whole tensors of a tree of this rank's blocks."""
    return tree_map(gather_full, tree, shardings)


def global_norm_fn(shardings, mesh, axes):
    """|g| of a gradient tree of this rank's blocks, over the ranks of
    ``axes`` (all of the mesh in sync mode, a pod's in hierarchical): the
    squares of each distinct block summed once (a block replicated over an
    axis counts on the axis's rank 0 alone), then all-reduced over
    ``axes``. On one rank it is ``tree_global_norm``'s sum, bit for bit."""
    coords = coordinates(mesh)
    specs = [s.spec for s in _sharding_leaves(shardings)]
    counted = [all(a in spec_axes(spec) or coords[a] == 0 for a in axes)
               for spec in specs]

    def norm(grads):
        leaves = tree_leaves(grads)
        total = sum(torch.sum(torch.square(g.float()))
                    for g, c in zip(leaves, counted) if c)
        if not isinstance(total, torch.Tensor):
            total = torch.zeros((), device=leaves[0].device)
        for a in axes:
            total = coll.all_reduce(total, mesh.get_group(a))
        return torch.sqrt(total)

    return norm


def _sharding_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sharding_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _sharding_leaves(t)]
    return [tree]
