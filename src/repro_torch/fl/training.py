"""Federated training loops — paper Algorithm 1 (HFEL) and FedAvg (§V.B).
Port of ``repro.fl.training``.

Client parameters live in ONE flat ``(n_clients, P)`` float32 buffer,
``FederatedTrainer.flat``; each leaf of the model's dict is a view of its
column range (leaves in sorted key order, as ``jax.tree.leaves`` orders
them). Local full-batch GD runs on the client-stacked views, as batched
matrix products. Both averages go through the hand-written kernel,
:func:`repro_torch.kernels.ops.hier_aggregate`, straight from the buffer
with no per-aggregation concatenation: eq. (8) with one launch per edge
server that has members (over its gathered rows), eq. (14) with one launch
over all clients. The JAX trainer computes the same means with
``jax.ops.segment_sum``.

The §V.B protocol is preserved: per global round both methods perform the
same TOTAL number of local iterations (L*I); HFEL interleaves I edge
aggregations, FedAvg aggregates only at the cloud.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch import DTYPE, resolve_device
from repro_torch.data.federated import FederatedDataset
from repro_torch.fl.fl_model import MODELS, accuracy, masked_loss
from repro_torch.kernels import ops


def _host_assignment(assignment, n_clients: int, n_servers: int) -> np.ndarray:
    """The (n_clients,) device -> server map as a host int64 array; raises
    on a wrong shape or a server outside [0, n_servers)."""
    a = torch.as_tensor(assignment, dtype=torch.int64).cpu().numpy()
    if a.shape != (n_clients,):
        raise ValueError(f"assignment has shape {a.shape}, expected "
                         f"{(n_clients,)}")
    if a.size and (a.min() < 0 or a.max() >= n_servers):
        raise ValueError(f"assignment names a server outside [0, "
                         f"{n_servers})")
    return a


def _group_means(flat: torch.Tensor, w: torch.Tensor, assignment: np.ndarray,
                 n_servers: int):
    """eq. (8) weighted group means of the client-stacked ``flat`` (N, P) —
    the ONE place the group-mean arithmetic lives. One kernel launch per
    server that has members, over that group's rows and weights. Returns
    ``(means (n_servers, P), live (n_servers,) bool)``; a mean is garbage
    wherever ``live`` is False (weight-0 group), so callers must gate on it.

    The kernel floors the weight sum at 1e-30 where the JAX trainer floors
    it at 1e-9. The two agree wherever a group is live: weights are sample
    counts (at least 20) times a 0/1 mask, so a positive sum is at least 20.
    """
    n = flat.shape[0]
    means = flat.new_zeros((n_servers, flat.shape[1]))
    for k in range(n_servers):
        idx = np.flatnonzero(assignment == k)
        if idx.size == n:          # the whole stack: no gather
            means[k] = ops.hier_aggregate(flat, w)
        elif idx.size:
            rows = torch.as_tensor(idx, device=flat.device)
            means[k] = ops.hier_aggregate(flat.index_select(0, rows),
                                          w.index_select(0, rows))
    den = w.new_zeros(n_servers).index_add_(
        0, torch.as_tensor(assignment, device=flat.device), w)
    return means, den > 0


@dataclass
class TrainHistory:
    test_acc: list = field(default_factory=list)
    train_acc: list = field(default_factory=list)
    train_loss: list = field(default_factory=list)
    # global-round index of each entry above (evaluation may be subsampled
    # via ``eval_every``; all four lists always share one length)
    eval_rounds: list = field(default_factory=list)

    def as_dict(self):
        return {"test_acc": self.test_acc, "train_acc": self.train_acc,
                "train_loss": self.train_loss,
                "eval_rounds": self.eval_rounds}


class FederatedTrainer:
    """Runs HFEL or FedAvg on a FederatedDataset.

    ``assignment``: (n_clients,) device -> edge-server map (HFEL only) —
    typically the output of the core edge-association algorithm.
    ``client_mask``: boolean participation mask, re-settable between rounds
    (straggler dropping / failure injection hook).
    ``client_params``: the model's dict of client-stacked (n_clients, ...)
    views of :attr:`flat`; setting it copies the given values in.
    ``device=None`` means CUDA and raises without a card.
    """

    def __init__(self, ds: FederatedDataset, *, model: str = "mlr",
                 lr: float = 0.01, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.ds = ds
        init_fn, self.logits_fn = MODELS[model]
        proto = init_fn(torch.Generator().manual_seed(seed), ds.dim,
                        ds.n_classes)
        self._shapes = {k: tuple(proto[k].shape) for k in sorted(proto)}
        # identical init across clients (the paper broadcasts omega^0)
        self.flat = torch.cat([proto[k].reshape(-1) for k in self._shapes]
                              ).to(self.device, DTYPE).repeat(ds.n_clients, 1)
        self.lr = lr
        self.sizes = torch.as_tensor(ds.client_sizes, dtype=DTYPE,
                                     device=self.device)
        self.x = torch.as_tensor(ds.client_x, device=self.device)
        self.y = torch.as_tensor(ds.client_y, device=self.device).long()
        self.test_x = torch.as_tensor(ds.test_x, device=self.device)
        self.test_y = torch.as_tensor(ds.test_y, device=self.device).long()
        self.client_mask = np.ones(ds.n_clients, bool)

    # -- parameters -----------------------------------------------------------

    def _views(self, flat: torch.Tensor) -> dict:
        """The model's dict over ``flat`` (P,) or (N, P), leaf by leaf."""
        out, off = {}, 0
        for k, shape in self._shapes.items():
            size = math.prod(shape)
            out[k] = flat[..., off:off + size].view(*flat.shape[:-1], *shape)
            off += size
        return out

    @property
    def client_params(self) -> dict:
        return self._views(self.flat)

    @client_params.setter
    def client_params(self, params) -> None:
        for k, view in self._views(self.flat).items():
            view.copy_(torch.as_tensor(params[k]))

    @property
    def client_mask(self) -> torch.Tensor:
        return self._mask

    @client_mask.setter
    def client_mask(self, mask) -> None:
        mask = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
        if mask.shape != (self.ds.n_clients,):
            raise ValueError(f"client_mask has shape {tuple(mask.shape)}, "
                             f"expected {(self.ds.n_clients,)}")
        self._mask = mask

    def global_params(self) -> dict:
        return self._views(self.flat[0])

    # -- local steps ----------------------------------------------------------

    def _local(self, n_steps: int) -> None:
        """``n_steps`` full-batch GD steps on every client, in place. The
        gradient of the sum of the per-client losses is each client's own
        gradient."""
        for _ in range(n_steps):
            leaves = {k: v.detach().requires_grad_()
                      for k, v in self.client_params.items()}
            loss = masked_loss(self.logits_fn, leaves, self.x, self.y).sum()
            grads = torch.autograd.grad(loss, list(leaves.values()))
            with torch.no_grad():
                for v, g in zip(leaves.values(), grads):
                    v.sub_(self.lr * g)

    # -- aggregation ---------------------------------------------------------

    def _weights(self) -> torch.Tensor:
        return self.sizes * self.client_mask.to(self.sizes.dtype)

    def edge_aggregate(self, assignment, n_servers: int) -> None:
        """eq. (8): weighted mean within each server group, broadcast back.

        A group whose participating weight is zero (every member masked out
        — e.g. a fully-departed edge server under churn) has no defined
        mean: its clients KEEP their current parameters. Masked clients of a
        live group still receive the group broadcast (re-sync on return),
        matching the cloud semantics below.
        """
        a = _host_assignment(assignment, self.ds.n_clients, n_servers)
        means, live = _group_means(self.flat, self._weights(), a, n_servers)
        at = torch.as_tensor(a, device=self.device)
        self.flat = torch.where(live[at][:, None], means[at], self.flat)

    def cloud_aggregate(self) -> None:
        """eq. (14): global weighted mean, broadcast back (to masked clients
        too — stragglers re-sync from the global model). With NO
        participating client at all there is no mean; everyone keeps their
        parameters."""
        mean, live = _group_means(self.flat, self._weights(),
                                  np.zeros(self.ds.n_clients, np.int64), 1)
        self.flat = torch.where(live[:, None], mean, self.flat)

    def readmit_clients(self, arrivals, assignment, n_servers: int) -> None:
        """Re-admit arriving clients with their edge's CURRENT parameters:
        each arrival's state is set to the eq.-(8) weighted mean of its
        assigned server's participating members (the arrivals themselves
        excluded as donors), falling back to the global weighted mean when
        that group is otherwise empty — and keeping the arrival's old
        parameters when nobody at all can donate."""
        arrivals = torch.as_tensor(arrivals, dtype=torch.bool,
                                   device=self.device)
        a = _host_assignment(assignment, self.ds.n_clients, n_servers)
        donors = self.client_mask & ~arrivals
        w = self.sizes * donors.to(self.sizes.dtype)
        means, grp_live = _group_means(self.flat, w, a, n_servers)
        gmean, any_live = _group_means(
            self.flat, w, np.zeros(self.ds.n_clients, np.int64), 1)
        at = torch.as_tensor(a, device=self.device)
        src = torch.where(grp_live[at][:, None], means[at], gmean)
        take = arrivals[:, None] & any_live
        self.flat = torch.where(take, src, self.flat)

    # -- rounds ---------------------------------------------------------------

    def hfel_round(self, assignment, n_servers: int, local_iters: int,
                   edge_iters: int) -> None:
        for _ in range(edge_iters):
            self._local(local_iters)
            self.edge_aggregate(assignment, n_servers)
        self.cloud_aggregate()

    def fedavg_round(self, local_iters: int, edge_iters: int) -> None:
        """Same local work (L*I), single cloud aggregation (McMahan et al.)."""
        self._local(local_iters * edge_iters)
        self.cloud_aggregate()

    # -- metrics --------------------------------------------------------------

    @torch.no_grad()
    def evaluate(self) -> dict:
        g = self.global_params()
        test_acc = accuracy(self.logits_fn, g, self.test_x, self.test_y)
        flat_x = self.x.reshape(-1, self.ds.dim)
        flat_y = self.y.reshape(-1)
        train_acc = accuracy(self.logits_fn, g, flat_x, flat_y)
        train_loss = masked_loss(self.logits_fn, g, flat_x, flat_y)
        return {"test_acc": float(test_acc), "train_acc": float(train_acc),
                "train_loss": float(train_loss)}


def train_federated(ds: FederatedDataset, *, method: str = "hfel",
                    assignment=None, n_servers: int = 5,
                    local_iters: int = 10, edge_iters: int = 5,
                    rounds: int = 50, lr: float = 0.01, model: str = "mlr",
                    seed: int = 0, eval_every: int = 1,
                    round_hook: Callable | None = None,
                    device=None) -> TrainHistory:
    """Run ``rounds`` global iterations of HFEL or FedAvg; returns history.

    ``round_hook`` runs before each round and is either

    * a plain callable ``hook(trainer, round_idx)`` (failure injection /
      straggler masking), or
    * a *round policy* object exposing
      ``begin_round(trainer, round_idx) -> assignment | None``: returning an
      (n_clients,) array hot-swaps the HFEL edge assignment for this round
      and every following one until the next swap. Swaps land between cloud
      aggregations (before the round's first local step), where the global
      weighted mean is invariant to the grouping.

    ``device=None`` means CUDA and raises without a card.
    """
    trainer = FederatedTrainer(ds, model=model, lr=lr, seed=seed,
                               device=device)
    if assignment is None:
        assignment = np.arange(ds.n_clients) % n_servers
    assignment = _host_assignment(assignment, ds.n_clients, n_servers)
    hist = TrainHistory()
    begin_round = getattr(round_hook, "begin_round", None)
    for r in range(rounds):
        if begin_round is not None:
            swapped = begin_round(trainer, r)
            if swapped is not None:
                assignment = _host_assignment(swapped, ds.n_clients,
                                              n_servers)
        elif round_hook is not None:
            round_hook(trainer, r)
        if method == "hfel":
            trainer.hfel_round(assignment, n_servers, local_iters, edge_iters)
        elif method == "fedavg":
            trainer.fedavg_round(local_iters, edge_iters)
        else:
            raise ValueError(method)
        if r % eval_every == 0 or r == rounds - 1:
            m = trainer.evaluate()
            hist.test_acc.append(m["test_acc"])
            hist.train_acc.append(m["train_acc"])
            hist.train_loss.append(m["train_loss"])
            hist.eval_rounds.append(r)
    return hist
