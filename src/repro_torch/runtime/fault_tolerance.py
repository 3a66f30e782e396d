"""Fault tolerance & elasticity for the HFEL runtime. Port of
``repro.runtime.fault_tolerance``; the re-association runs the port's
:class:`~repro_torch.core.edge_association.AssociationEngine`.

Three mechanisms, all driven by the paper's own cost machinery:

* :class:`StragglerPolicy` — the optimal resource allocation equalizes
  finish times at a deadline t* (Section III KKT structure); the runtime
  enforces that deadline. Participants whose realized round time exceeds
  ``slack * t*`` are dropped from the round and eq. (8)'s weights are
  renormalized over survivors.

* :class:`FailureInjector` — Bernoulli node failures (and recoveries) per
  round, for integration tests and chaos runs.

* :class:`ElasticReassociator` — on membership change, re-runs edge
  association *warm-started from the current stable point* (Alg. 3
  restricted to the perturbed state converges in a handful of adjustments —
  Thm. 3's argument applies from any initial strategy).

Plus :func:`retry_with_backoff` for transient launcher failures.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core.edge_association import (AssociationEngine,
                                               AssociationResult)
from repro_torch.core.scenario import Scenario


@dataclass
class StragglerPolicy:
    """Deadline-based straggler mitigation.

    ``deadline``: the scheduler's t* (seconds). ``slack``: multiplicative
    grace factor. ``mask(times)`` returns the participation mask for the
    round; aggregation weight renormalization happens in the trainer (its
    weighted means already honour the mask).
    """

    deadline: float
    slack: float = 1.10
    min_participants: int = 1

    def mask(self, realized_times: np.ndarray) -> np.ndarray:
        keep = realized_times <= self.deadline * self.slack
        if keep.sum() < self.min_participants:
            order = np.argsort(realized_times)
            keep = np.zeros_like(keep)
            keep[order[:self.min_participants]] = True
        return keep


class FailureInjector:
    """Per-round Bernoulli failures with geometric recovery."""

    def __init__(self, n_nodes: int, *, p_fail: float = 0.02,
                 p_recover: float = 0.5, seed: int = 0):
        self.alive = np.ones(n_nodes, bool)
        self.p_fail = p_fail
        self.p_recover = p_recover
        self.rng = np.random.default_rng(seed)

    def step(self) -> np.ndarray:
        dies = self.rng.random(self.alive.shape) < self.p_fail
        recovers = self.rng.random(self.alive.shape) < self.p_recover
        self.alive = np.where(self.alive, ~dies, recovers)
        return self.alive.copy()


class ElasticReassociator:
    """Incremental edge re-association on node arrival/departure
    (``device``: where the engine prices groups, ``None`` = CUDA)."""

    def __init__(self, sc: Scenario, *, kind: str = "fast", seed: int = 0,
                 device=None):
        self.sc = sc
        self.kind = kind
        self.seed = seed
        self.device = device
        self.current: AssociationResult | None = None

    def _engine(self, sc: Scenario) -> AssociationEngine:
        return AssociationEngine(sc, kind=self.kind, seed=self.seed,
                                 device=self.device)

    def initial(self) -> AssociationResult:
        self.current = self._engine(self.sc).run_batched("nearest")
        return self.current

    def on_membership_change(self, alive: np.ndarray) -> AssociationResult:
        """Re-associate with dead devices pinned out of every group.

        Dead devices keep an assignment slot (arrays stay fixed-size) but
        are excluded via the availability matrix and a zero-cost pin to
        their nearest server; live devices warm-start from the current
        stable assignment.
        """
        sc = copy.copy(self.sc)
        avail = self.sc.avail.copy()
        # dead devices are only "available" to a dummy nearest server so they
        # never enter a live group's cost
        nearest = np.argmin(self.sc.dist, axis=0)
        dead = ~alive
        avail[:, dead] = False
        avail[nearest[dead], dead] = True
        sc.avail = avail

        eng = self._engine(sc)
        warm = (self.current.assignment.copy() if self.current is not None
                else eng.initial_assignment("nearest"))
        warm[dead] = nearest[dead]
        res = eng.run_batched(assignment=warm)
        self.current = res
        return res


def retry_with_backoff(fn, *, max_attempts: int = 5, base_delay: float = 0.5,
                       retry_on: tuple = (RuntimeError, OSError),
                       sleep=time.sleep):
    """Launcher helper: call fn() with exponential backoff on failure."""
    last = None
    for attempt in range(max_attempts):
        try:
            return fn()
        except retry_on as e:          # noqa: PERF203
            last = e
            sleep(base_delay * (2 ** attempt))
    raise last
