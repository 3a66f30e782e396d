from repro_torch.utils.trees import (
    tree_add,
    tree_cast,
    tree_global_norm,
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
    tree_scale,
    tree_size,
    tree_sub,
    tree_unflatten,
    tree_weighted_mean,
    tree_zeros_like,
)

__all__ = [
    "tree_add",
    "tree_cast",
    "tree_global_norm",
    "tree_leaves",
    "tree_leaves_with_path",
    "tree_map",
    "tree_scale",
    "tree_size",
    "tree_sub",
    "tree_unflatten",
    "tree_weighted_mean",
    "tree_zeros_like",
]
