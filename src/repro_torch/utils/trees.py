"""Tree arithmetic over the nested dicts, lists and tuples of tensors that
the FL models use (port of ``repro.utils.trees``).

Plain recursion stands in for ``jax.tree``: a dict's leaves come in sorted
key order, as JAX orders them, so a flattened tree lines up with the JAX
package's ``jax.tree.leaves`` of the same model.
"""

from __future__ import annotations

import torch


def tree_leaves(tree) -> list:
    """The tensors of ``tree`` in JAX's leaf order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_leaves_with_path(tree, prefix: tuple = ()) -> list:
    """``(path, leaf)`` pairs in :func:`tree_leaves` order; a path is the
    tuple of dict keys and sequence indices from the root, as
    ``jax.tree_util.tree_flatten_with_path`` gives them."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in tree_leaves_with_path(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, t in enumerate(tree)
                for pair in tree_leaves_with_path(t, prefix + (i,))]
    return [(prefix, tree)]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(t) for t in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_cast(a, dtype):
    return tree_map(lambda x: x.to(dtype), a)


def tree_weighted_mean(trees, weights):
    """Weighted mean of a list of trees: eq. (8)/(14) of the paper.

    ``weights`` is a 1-D array aligned with ``trees``; normalization is
    performed here so callers pass raw |D_n| sample counts.
    """
    w = torch.as_tensor(weights, dtype=torch.float32)
    w = w / torch.sum(w)

    def combine(*leaves):
        stacked = torch.stack(leaves)
        return torch.tensordot(w.to(stacked.device, stacked.dtype), stacked,
                               dims=1)

    return tree_map(combine, *trees)


def tree_global_norm(a):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(a)))


def tree_size(a) -> int:
    """Total number of scalar parameters in the tree."""
    return sum(int(x.numel()) for x in tree_leaves(a))
