"""Live HFEL co-simulation: edge re-association during federated training.

Port of ``repro.fl.live``. A :class:`LiveHFELRunner` drives
:class:`repro_torch.fl.training.FederatedTrainer` rounds while the
:class:`repro_torch.core.scenario.Scenario` churns underneath it. Every
global round

1. applies one seeded :func:`perturb_scenario` tick (drift, reach flips,
   arrivals and departures),
2. re-solves the edge association under a policy (below),
3. repairs the trainer's state for the churn: ``Scenario.active`` maps onto
   the trainer's ``client_mask`` through a :class:`DeviceClientBridge`,
   departed devices are parked (weight 0 in both means, kept in the
   fixed-size buffer), arrivals are re-admitted with their edge's current
   parameters (:meth:`FederatedTrainer.readmit_clients`),
4. hot-swaps the assignment between cloud aggregations, and
5. books the round's eq.-(17) cost of its assignment on its scenario.

Policies: ``static`` freezes the round-0 stable assignment and only repairs
it (:func:`repair_assignment`, no descent); ``periodic-cold`` builds a fresh
engine every ``resolve_every`` rounds and descends from the repaired last
swap; ``incremental-warm`` re-converges the round-0 engine with
:meth:`FastAssociationEngine.rerun_incremental` from the same repaired
point, with the single :func:`diff_scenarios` delta since the last swap.
The two re-association policies therefore land on the same assignment at
every swap, bit for bit. Every timed solve runs with ``finalize=False``;
the per-round cost comes from :func:`assignment_true_cost` with one
prebuilt default-profile solver, outside the association timer.

Streaming admission under capacities (``Scenario.max_devices``): the true
scenario keeps churning while the association sees the admitted view.
Arrivals wait in a FIFO overflow queue that an admission tick drains every
round by greedy nearest-feasible placement (after the descent on a swap
round), a device the capacitated repair cannot place is demoted to the
queue, and past ``overflow_max`` the oldest entries are dropped and
counted as rejected. Swap references are stored before the drain.

Everything runs on the runner's device (``device=None`` means CUDA): the
association engines, whose group costs are golden-section kernel launches,
and the trainer, whose eq. (8)/(14) means are hier_aggregate launches.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.assoc_fast import (DEFAULT_EXCHANGE_SAMPLES,
                                         FastAssociationEngine,
                                         _shard_devices,
                                         assignment_true_cost,
                                         repair_assignment)
from repro_torch.core.edge_association import (GroupSolver,
                                               NoFeasibleServerError,
                                               greedy_admission)
from repro_torch.core.scenario import (DeviceClientBridge, Scenario,
                                       device_client_bridge, diff_scenarios,
                                       perturb_scenario)
from repro_torch.data.federated import FederatedDataset
from repro_torch.fl.training import TrainHistory, train_federated

POLICIES = ("static", "periodic-cold", "incremental-warm")

# one mild mobility tick per global round: 5% of devices drift, 2% lose a
# reach bit, 2% depart, 10% of the inactive pool returns
DEFAULT_CHURN = {"drift_m": 60.0, "move_frac": 0.05, "flip_frac": 0.02,
                 "depart_frac": 0.02, "arrive_frac": 0.10}


@dataclass
class LiveHistory:
    """Per-round record of one live co-simulation. The round-indexed lists
    have length ``rounds`` whatever ``eval_every`` is (training metrics are
    in ``train`` with their own ``eval_rounds``); ``swap_rounds`` and
    ``swap_assignments`` record every hot swap, round 0's included."""

    policy: str
    resolve_every: int
    # -- round-indexed (length == rounds) --
    system_cost: list = field(default_factory=list)     # eq. (17)
    system_energy: list = field(default_factory=list)   # eq. (15)
    system_delay: list = field(default_factory=list)    # eq. (16)
    assoc_seconds: list = field(default_factory=list)
    swapped: list = field(default_factory=list)
    moves: list = field(default_factory=list)
    n_active: list = field(default_factory=list)
    n_arrived: list = field(default_factory=list)
    n_departed: list = field(default_factory=list)
    # -- streaming admission (all zero without caps) --
    n_queued: list = field(default_factory=list)     # queue depth at round end
    n_admitted: list = field(default_factory=list)   # streamed in this round
    n_rejected: list = field(default_factory=list)   # dropped from the queue
    # -- swap-indexed --
    swap_rounds: list = field(default_factory=list)
    swap_assignments: list = field(default_factory=list)
    train: TrainHistory | None = None

    @property
    def rounds(self) -> int:
        return len(self.system_cost)

    @property
    def cumulative_cost(self) -> float:
        """Sum of the per-round eq.-(17) costs."""
        return float(np.sum(self.system_cost))

    @property
    def assoc_seconds_total(self) -> float:
        return float(np.sum(self.assoc_seconds))

    def as_dict(self) -> dict:
        """JSON-friendly summary (swap assignments as counts only)."""
        return {
            "policy": self.policy, "resolve_every": self.resolve_every,
            "rounds": self.rounds,
            "system_cost": [float(c) for c in self.system_cost],
            "system_energy": [float(c) for c in self.system_energy],
            "system_delay": [float(c) for c in self.system_delay],
            "cumulative_cost": self.cumulative_cost,
            "assoc_seconds": [float(s) for s in self.assoc_seconds],
            "assoc_seconds_total": self.assoc_seconds_total,
            "swapped": [bool(s) for s in self.swapped],
            "moves": [int(m) for m in self.moves],
            "n_active": [int(a) for a in self.n_active],
            "n_arrived": [int(a) for a in self.n_arrived],
            "n_departed": [int(d) for d in self.n_departed],
            "n_queued": [int(q) for q in self.n_queued],
            "n_admitted": [int(a) for a in self.n_admitted],
            "n_rejected": [int(x) for x in self.n_rejected],
            "swap_rounds": [int(r) for r in self.swap_rounds],
            "train": self.train.as_dict() if self.train is not None else None,
        }


class LiveHFELRunner:
    """The round policy behind :func:`run_live`, usable directly as
    ``train_federated(..., round_hook=runner)``: ``begin_round(trainer,
    r)`` churns, re-associates and repairs, and returns the round's
    (n_clients,) assignment. ``device=None`` means CUDA. ``shards`` and
    ``shard_devices`` reach every engine the policies build (the engine's
    sharded sweep, the same assignments as without)."""

    def __init__(self, sc: Scenario, n_clients: int, *,
                 policy: str = "incremental-warm", resolve_every: int = 1,
                 churn: dict | None = None, seed: int = 0,
                 kind: str = "fast", profile: str = "coarse",
                 rel_tol: float = 1e-3, compact: bool | str = "auto",
                 shards: int | None = None, shard_devices=None,
                 max_moves: int = 10_000,
                 exchange_samples: int = DEFAULT_EXCHANGE_SAMPLES,
                 verify: bool = False, overflow_max: int = 64,
                 bridge: DeviceClientBridge | None = None, device=None):
        if policy not in POLICIES:
            raise ValueError(
                f"policy must be one of {POLICIES}, got {policy!r}")
        if resolve_every < 1:
            raise ValueError("resolve_every must be >= 1")
        if overflow_max < 0:
            raise ValueError("overflow_max must be >= 0")
        self.device = resolve_device(device)
        # streaming admission (caps only): the true scenario churns, the
        # association sees the admitted view
        self.sc = sc
        self._sc_full = sc
        self._cap = sc.capacity
        self.overflow_max = overflow_max
        self._queue: list[int] = []
        self._round_rejected = 0
        self._admitted: np.ndarray | None = None
        if self._cap is not None:
            admitted = sc.active_mask.copy()
            act = np.flatnonzero(admitted)
            load = np.zeros(sc.n_servers, dtype=np.int64)
            placed = greedy_admission(sc.dist, sc.eff_avail, load,
                                      self._cap, act)
            refused = act[placed < 0]
            admitted[refused] = False
            self._admitted = admitted
            self._queue = refused.tolist()
            self._round_rejected = self._trim_queue()
            self.sc = dataclasses.replace(sc, active=admitted.copy())
        self.policy = policy
        self.resolve_every = resolve_every
        self.churn = dict(DEFAULT_CHURN if churn is None else churn)
        self.seed = seed
        self.kind = kind
        self.profile = profile
        self.rel_tol = rel_tol
        self.compact = compact
        _shard_devices(shards, shard_devices, self.device)   # checks them
        self.shards = shards
        self.shard_devices = shard_devices
        self.max_moves = max_moves
        self.exchange_samples = exchange_samples
        self.verify = verify
        self.bridge = bridge or device_client_bridge(sc, n_clients)
        if self.bridge.n_devices != sc.n_devices:
            raise ValueError(
                "bridge does not match the scenario's device axis")
        if self.bridge.n_clients != n_clients:
            raise ValueError(
                f"bridge maps {self.bridge.n_clients} clients but the "
                f"dataset has {n_clients}")
        # reference-accuracy cost evaluator shared by every policy and kept
        # out of the association timer; valid across churn because the
        # physical parameters are churn-invariant ("proportional" reads
        # distances, so it builds one per round)
        self._eval_solver = (None if kind == "proportional" else
                             GroupSolver(sc, kind, seed=seed,
                                         profile="default",
                                         device=self.device))
        self.engine: FastAssociationEngine | None = None
        self.assignment: np.ndarray | None = None   # device axis, parked incl.
        # association-side round state tracks the view (self.sc)
        self._active_prev = self.sc.active_mask.copy()
        self._sc_at_swap = self.sc
        self._active_at_swap = self.sc.active_mask.copy()
        self._assign_at_swap: np.ndarray | None = None
        self.history = LiveHistory(policy=policy, resolve_every=resolve_every)

    # -- internals -----------------------------------------------------------

    def _tick_seed(self, r: int) -> int:
        # per (seed, round), the same for every policy: every policy sees
        # the same churn trajectory
        return (self.seed + 1) * 1_000_003 + r

    def _new_engine(self, sc: Scenario) -> FastAssociationEngine:
        return FastAssociationEngine(sc, kind=self.kind, seed=self.seed,
                                     rel_tol=self.rel_tol,
                                     profile=self.profile,
                                     compact=self.compact,
                                     shards=self.shards,
                                     shard_devices=self.shard_devices,
                                     device=self.device)

    # -- streaming admission (capacitated scenarios only) --------------------

    def _rebuild_view(self) -> None:
        self.sc = dataclasses.replace(self._sc_full,
                                      active=self._admitted.copy())

    def _trim_queue(self) -> int:
        """Drop the oldest queue entries beyond ``overflow_max``; returns
        how many went."""
        drop = len(self._queue) - self.overflow_max
        if drop > 0:
            self._queue = self._queue[drop:]
        return max(drop, 0)

    def _admission_tick(self) -> int:
        """Drain the overflow queue greedily against current loads, with no
        solve: admitted devices join the view with their placement; the
        rest stay queued in order. Returns how many were admitted."""
        if not self._queue:
            return 0
        k = self._sc_full.n_servers
        load = np.bincount(self.assignment[self._admitted], minlength=k)
        devices = np.asarray(self._queue, dtype=np.int64)
        placed = greedy_admission(self._sc_full.dist, self._sc_full.eff_avail,
                                  load, self._cap, devices)
        got = placed >= 0
        if got.any():
            self.assignment[devices[got]] = placed[got]
            self._admitted[devices[got]] = True
            self._queue = devices[~got].tolist()
            self._rebuild_view()
        return int(got.sum())

    def _repair_with_demotions(self, prev_assign: np.ndarray,
                               old_active: np.ndarray) -> np.ndarray:
        """Capacitated repair that demotes the devices
        :func:`repair_assignment` cannot place into the queue and repairs
        again on the smaller view, before any engine call (so the engine's
        own repair of the same inputs cannot raise). Each retry shrinks
        the admitted set. Leaves ``self.sc`` as the final view."""
        while True:
            self._rebuild_view()
            try:
                assign, *_ = repair_assignment(self.sc, prev_assign,
                                               old_active)
                return assign
            except NoFeasibleServerError as e:
                self._admitted[e.devices] = False
                self._queue.extend(int(d) for d in e.devices)

    def _record(self, *, assoc_s: float, swapped: bool, moves: int,
                arrived: int, departed: int, admitted: int = 0) -> None:
        h = self.history
        e, t, c = assignment_true_cost(self.sc, self.assignment,
                                       solver=self._eval_solver,
                                       kind=self.kind, seed=self.seed,
                                       device=self.device)
        h.system_cost.append(c)
        h.system_energy.append(e)
        h.system_delay.append(t)
        h.assoc_seconds.append(assoc_s)
        h.swapped.append(swapped)
        h.moves.append(moves)
        h.n_active.append(int(self.sc.active_mask.sum()))
        h.n_arrived.append(arrived)
        h.n_departed.append(departed)
        h.n_queued.append(len(self._queue))
        h.n_admitted.append(admitted)
        h.n_rejected.append(self._round_rejected)
        self._round_rejected = 0
        if swapped:
            h.swap_rounds.append(len(h.system_cost) - 1)
            h.swap_assignments.append(self.assignment.copy())

    # -- the round policy ----------------------------------------------------

    def begin_round(self, trainer, r: int):
        if r == 0:
            trainer.client_mask = self.bridge.client_mask(self.sc.active_mask)
            t0 = time.perf_counter()
            self.engine = self._new_engine(self.sc)
            assignment = self.engine.run(
                "nearest", max_moves=self.max_moves,
                exchange_samples=self.exchange_samples, finalize=False)
            assoc_s = time.perf_counter() - t0
            self.assignment = np.asarray(assignment)
            self._assign_at_swap = self.assignment.copy()
            self._record(assoc_s=assoc_s, swapped=True,
                         moves=self.engine.last_moves, arrived=0, departed=0)
            if self.policy != "incremental-warm":
                # only the warm policy re-enters the engine after round 0
                self.engine = None
            return self.bridge.client_assignment(self.assignment)

        capped = self._admitted is not None
        if capped:
            admitted_before = self._admitted.copy()
            self._sc_full, delta = perturb_scenario(
                self._sc_full, seed=self._tick_seed(r), **self.churn)
            full_active = self._sc_full.active_mask
            # true departures leave the admitted set and the queue; arrivals
            # join the queue, the only way into training under caps
            self._admitted &= full_active
            self._queue = [d for d in self._queue if full_active[d]]
            self._queue.extend(np.flatnonzero(delta.arrived).tolist())
            self._rebuild_view()
        else:
            self.sc, delta = perturb_scenario(self.sc,
                                              seed=self._tick_seed(r),
                                              **self.churn)
        assoc_s, moves, swapped, admitted_n = 0.0, 0, False, 0
        resolve = self.policy != "static" and r % self.resolve_every == 0
        if resolve and self.policy == "incremental-warm":
            # the delta derivation is part of the warm path's work, so it
            # is inside the timer (cold's timer spans its repair and build)
            t0 = time.perf_counter()
            if capped:
                self._repair_with_demotions(self.engine.stable_assignment,
                                            self._active_at_swap)
            combined = diff_scenarios(self._sc_at_swap, self.sc)
            self.assignment = self.engine.rerun_incremental(
                self.sc, combined, max_moves=self.max_moves,
                exchange_samples=self.exchange_samples, verify=self.verify,
                finalize=False)
            assoc_s = time.perf_counter() - t0
            moves, swapped = self.engine.last_moves, True
        elif resolve:   # periodic-cold
            t0 = time.perf_counter()
            if capped:
                assign0 = self._repair_with_demotions(self._assign_at_swap,
                                                      self._active_at_swap)
            else:
                assign0, *_ = repair_assignment(self.sc, self._assign_at_swap,
                                                self._active_at_swap)
            cold = self._new_engine(self.sc)
            assignment = cold.run(assignment=assign0,
                                  max_moves=self.max_moves,
                                  exchange_samples=self.exchange_samples,
                                  finalize=False)
            assoc_s = time.perf_counter() - t0
            self.assignment = np.asarray(assignment)
            moves, swapped = cold.last_moves, True
        else:
            # static, and the off-cycle rounds: repair only, no descent
            if capped:
                self.assignment = self._repair_with_demotions(
                    self.assignment, self._active_prev)
            else:
                self.assignment, *_ = repair_assignment(
                    self.sc, self.assignment, self._active_prev)
        if swapped:
            # swap references are stored before the drain, so the next
            # warm re-solve and cold rebuild start from the same state
            self._sc_at_swap = self.sc
            self._active_at_swap = self.sc.active_mask.copy()
            self._assign_at_swap = self.assignment.copy()
        if capped:
            # the admission tick; on swap rounds the post-descent drain
            admitted_n = self._admission_tick()
            self._round_rejected += self._trim_queue()
        active = self.sc.active_mask
        self._active_prev = active.copy()

        trainer.client_mask = self.bridge.client_mask(active)
        newly = (self._admitted & ~admitted_before if capped
                 else delta.arrived)
        arrivals_c = self.bridge.client_mask(newly)
        if arrivals_c.any():
            trainer.readmit_clients(
                arrivals_c, self.bridge.client_assignment(self.assignment),
                self.sc.n_servers)
        self._record(assoc_s=assoc_s, swapped=swapped, moves=moves,
                     arrived=int(delta.arrived.sum()),
                     departed=int(delta.departed.sum()),
                     admitted=admitted_n)
        return self.bridge.client_assignment(self.assignment)


def run_live(sc: Scenario, ds: FederatedDataset, *,
             policy: str = "incremental-warm", rounds: int = 10,
             resolve_every: int = 1, churn: dict | None = None, seed: int = 0,
             local_iters: int = 5, edge_iters: int = 2, lr: float = 0.05,
             model: str = "mlr", eval_every: int = 1, train_seed: int = 0,
             kind: str = "fast", profile: str = "coarse",
             rel_tol: float = 1e-3, compact: bool | str = "auto",
             shards: int | None = None, shard_devices=None,
             max_moves: int = 10_000,
             exchange_samples: int = DEFAULT_EXCHANGE_SAMPLES,
             verify: bool = False, overflow_max: int = 64,
             bridge: DeviceClientBridge | None = None,
             device=None) -> LiveHistory:
    """One live HFEL co-simulation end to end; returns its
    :class:`LiveHistory` (training metrics under ``.train``). Churn ticks
    are seeded from ``seed`` and the round alone, so the policies face the
    same scenario trajectory. With caps, arrivals the edges cannot admit
    wait in a queue bounded by ``overflow_max``. ``device=None`` means
    CUDA, for the association and the trainer alike."""
    runner = LiveHFELRunner(sc, ds.n_clients, policy=policy,
                            resolve_every=resolve_every, churn=churn,
                            seed=seed, kind=kind, profile=profile,
                            rel_tol=rel_tol, compact=compact, shards=shards,
                            shard_devices=shard_devices, max_moves=max_moves,
                            exchange_samples=exchange_samples, verify=verify,
                            overflow_max=overflow_max, bridge=bridge,
                            device=device)
    hist = train_federated(ds, method="hfel", n_servers=sc.n_servers,
                           local_iters=local_iters, edge_iters=edge_iters,
                           rounds=rounds, lr=lr, model=model, seed=train_seed,
                           eval_every=eval_every, round_hook=runner,
                           device=runner.device)
    runner.history.train = hist
    return runner.history
