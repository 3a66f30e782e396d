"""Two-tier (edge/cloud) aggregation primitives — paper Algorithm 1.
Port of ``repro.core.hierarchy``.

* **Simulation scale** (the FL runtime): lists of per-client trees
  aggregated with :func:`repro_torch.utils.tree_weighted_mean` — eq. (8) at
  the edge, eq. (14) at the cloud.
* :class:`SyncSchedule` decides, per step, whether to run a local step, an
  edge sync or a cloud sync — the L(theta) / I(eps, theta) structure of
  Algorithm 1.
* **Datacenter scale**: :func:`psum_mean` and :func:`hierarchical_sync`
  average a tree of tensors across the ranks of a named
  ``torch.distributed`` device mesh (:mod:`repro_torch.launch.mesh`): eq.
  (8) over the ``data`` axis, eq. (14) over ``pod``. Every rank of the
  mesh calls them (the reference calls them inside ``shard_map``); the
  caller initialises the process group.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

import torch
import torch.distributed as dist

from repro_torch.utils import tree_leaves, tree_map, tree_weighted_mean


class SyncLevel(IntEnum):
    LOCAL = 0   # no cross-client communication this step
    EDGE = 1    # aggregate within the edge server (eq. 8)
    CLOUD = 2   # aggregate across edge servers (eq. 14)


@dataclass(frozen=True)
class SyncSchedule:
    """Algorithm 1's iteration structure.

    ``local_iters``  — L(theta): gradient steps between edge aggregations.
    ``edge_iters``   — I(eps, theta): edge aggregations between cloud syncs.

    Step indices are 1-based in the paper (t % L == 0 triggers aggregation);
    here ``level(step)`` takes the 0-based global step and returns what
    happens *after* that step's local update.
    """

    local_iters: int
    edge_iters: int

    def level(self, step: int) -> SyncLevel:
        s = step + 1
        if s % (self.local_iters * self.edge_iters) == 0:
            return SyncLevel.CLOUD
        if s % self.local_iters == 0:
            return SyncLevel.EDGE
        return SyncLevel.LOCAL

    def level_array(self, n_steps: int) -> torch.Tensor:
        """The schedule of ``n_steps`` steps as one int64 tensor."""
        s = torch.arange(1, n_steps + 1)
        period = self.local_iters * self.edge_iters
        return torch.where(s % period == 0, int(SyncLevel.CLOUD),
                           torch.where(s % self.local_iters == 0,
                                       int(SyncLevel.EDGE),
                                       int(SyncLevel.LOCAL)))

    @property
    def cloud_period(self) -> int:
        return self.local_iters * self.edge_iters


def edge_aggregate(client_models: list, client_samples):
    """omega_i = sum_n |D_n| omega_n / |D_{S_i}|  — eq. (8)."""
    return tree_weighted_mean(client_models, client_samples)


def cloud_aggregate(edge_models: list, edge_samples):
    """omega = sum_i |D_{S_i}| omega_i / |D|  — eq. (14)."""
    return tree_weighted_mean(edge_models, edge_samples)


def _all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group``, in float32, into a new tensor."""
    out = x.to(torch.float32, copy=True)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def psum_mean(tree, axis_name: str, weight=None, *, mesh):
    """Mean of ``tree``'s leaves over the ranks of mesh axis ``axis_name``:
    eq. (8) over ``data``, eq. (14) over ``pod``. Unweighted it is the
    all-reduced sum over the axis's size; with this rank's ``weight`` (a
    number or 0-d tensor) it is the all-reduced ``x * weight`` over the
    all-reduced weight. Accumulated in float32, each leaf returned in its
    own dtype, as the reference's ``psum`` of the leaf gives it; the inputs
    are left as they are."""
    group = mesh.get_group(axis_name)
    if weight is None:
        n = float(dist.get_world_size(group))
        return tree_map(lambda x: (_all_sum(x, group) / n).to(x.dtype), tree)
    leaves = tree_leaves(tree)
    w = torch.as_tensor(weight, dtype=torch.float32,
                        device=leaves[0].device if leaves else None)
    total_w = _all_sum(w, group)
    return tree_map(lambda x: (_all_sum(x.to(torch.float32) * w, group)
                               / total_w).to(x.dtype), tree)


def hierarchical_sync(tree, level, *, mesh, edge_axis: str = "data",
                      cloud_axis: str = "pod", weight=None):
    """The sync that ``level`` (an int or a 0-d tensor, the same on every
    rank, as :class:`SyncSchedule` gives it) asks for. LOCAL: the identity.
    EDGE: the ``weight``-weighted mean over ``edge_axis``. CLOUD: that,
    then the unweighted mean over ``cloud_axis`` (a cloud round includes
    Algorithm 1's last edge aggregation; the reference drops ``weight`` at
    the pod step, and so does this). A level outside 0-2 is clamped into
    it, as ``lax.switch`` does."""
    level = min(max(int(level), int(SyncLevel.LOCAL)), int(SyncLevel.CLOUD))
    if level == SyncLevel.LOCAL:
        return tree
    tree = psum_mean(tree, edge_axis, weight, mesh=mesh)
    if level == SyncLevel.EDGE:
        return tree
    return psum_mean(tree, cloud_axis, mesh=mesh)
