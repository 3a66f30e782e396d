"""Two-tier (edge/cloud) aggregation primitives — paper Algorithm 1.
Port of ``repro.core.hierarchy``.

* **Simulation scale** (the FL runtime): lists of per-client trees
  aggregated with :func:`repro_torch.utils.tree_weighted_mean` — eq. (8) at
  the edge, eq. (14) at the cloud.
* :class:`SyncSchedule` decides, per step, whether to run a local step, an
  edge sync or a cloud sync — the L(theta) / I(eps, theta) structure of
  Algorithm 1.

The datacenter-scale collectives of the reference (``psum_mean``,
``hierarchical_sync`` over a device mesh) need ``torch.distributed`` across
more than one GPU and are not ported yet (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

import torch

from repro_torch.utils import tree_weighted_mean


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


def psum_mean(tree, axis_name: str, weight=None):
    raise NotImplementedError(
        "psum_mean needs torch.distributed across more than one GPU; not "
        "ported yet (ROADMAP queue 1, item 7)")


def hierarchical_sync(tree, level, *, edge_axis: str = "data",
                      cloud_axis: str = "pod", weight=None):
    raise NotImplementedError(
        "hierarchical_sync needs torch.distributed across more than one GPU; "
        "not ported yet (ROADMAP queue 1, item 7)")
