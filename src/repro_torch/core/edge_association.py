"""Edge association across edge servers — paper Section IV.

Port of ``repro.core.edge_association``: the per-server group solver for
every §V.A scheme kind, the guarded feasibility helpers (numpy,
bit-identical to the reference), the host reference
:class:`AssociationEngine` — Algorithm 3 as written (``run``: every device
tries every permitted transfer, then sampled exchanges) and its batched
steepest-descent variant (``run_batched``) — and :func:`evaluate_scheme`,
the paper's seven §V.A comparison schemes.

The host engine keeps the reference's float64 bookkeeping, its memo of
group costs (the paper's history sets h_i) and its numpy draws, call for
call, so it draws the same exchanges. Its group costs come from
:class:`GroupSolver`: the ``fast`` kind through the golden-section kernel
on the card, the other kinds through the plain-PyTorch solvers of
:mod:`repro_torch.core.resource_allocation` on the solver's device.

Permission rules: ``permission="utilitarian"`` (default) permits an
adjustment iff the system-wide cost strictly decreases;
``permission="pareto"`` (the strict Definition 3) also forbids any involved
server's cost from rising. The objective is the sum-of-servers surrogate
sum_i [C_i + 1{S_i != {}} (lambda_e E^cloud_i + lambda_t T^cloud_i)] of
eq. (17); the true eqs. (15)-(17) costs are reported beside it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import resource_allocation as ra
from repro_torch.core.cost_model import (RAConstants, cloud_delay,
                                         cloud_energy, global_cost,
                                         ra_constants)
from repro_torch.core.scenario import Scenario
from repro_torch.kernels import ref

SCHEME_KINDS = ("optimal", "fast", "paper", "comp_only", "comm_only",
                "uniform", "proportional")


def _fixed_eval(c: RAConstants, mask, beta, random_f) -> ra.RASolution:
    """Problem (18) at a fixed (random f, given beta) point, for a batch of
    groups: no optimization."""
    f = torch.clamp(random_f, c.f_min, c.f_max)
    return ra._fixed_solution(c, mask, f, f, beta, ref.safe(beta, mask))


def solve_groups(kind: str, c: RAConstants, masks, *, random_f=None,
                 inv_dist=None, profile: str = "default") -> ra.RASolution:
    """Batched RA dispatch over ``(G, R)`` groups: ``c`` holds each group's
    constants (``w`` ``(G,)``), ``random_f`` and ``inv_dist`` the fixed
    decisions of the degenerate §V.A schemes per slot, ``profile`` the
    :data:`ra.SCREEN_PROFILES` preset of the ``fast`` kind."""
    if kind == "fast":
        return ra.solve_fixed_point_batched(c, masks,
                                            **ra.SCREEN_PROFILES[profile])
    if kind == "optimal":
        return ra.solve_exact(c, masks)
    if kind == "paper":
        return ra.solve_paper(c, masks)
    one = c.a.new_ones(())
    n_active = torch.clamp_min(masks.sum(-1, keepdim=True), 1).to(c.a.dtype)
    uniform = torch.where(masks, one / n_active, c.a.new_zeros(()))
    if kind == "comp_only":
        return ra.optimize_f_given_beta(c, masks, uniform)
    if kind == "comm_only":
        return ra.optimize_beta_given_f(c, masks, random_f)
    if kind == "uniform":
        return _fixed_eval(c, masks, uniform, random_f)
    if kind == "proportional":
        score = torch.where(masks, inv_dist, c.a.new_zeros(()))
        beta = score / torch.clamp_min(ra._msum(score, masks), 1e-12)
        return _fixed_eval(c, masks, beta, random_f)
    raise ValueError(f"unknown scheme kind {kind!r}")


def solve_group(kind: str, c: RAConstants, mask, *, random_f=None,
                inv_dist_row=None, profile: str = "default") -> ra.RASolution:
    """Single-group RA dispatch: ``c`` holds ONE server's constants,
    ``mask`` selects the group members; the batch at G = 1."""
    def one(x):
        return None if x is None else x[None]

    sol = solve_groups(kind, c.rows(None), mask[None].bool(),
                       random_f=one(random_f), inv_dist=one(inv_dist_row),
                       profile=profile)
    return ra.RASolution(f=sol.f[0], beta=sol.beta[0], cost=sol.cost[0],
                         deadline=sol.deadline[0])


class GroupSolver:
    """Caches the per-server RA constants ``(K, N)`` on one device and
    solves batches of (server, member-mask) groups under one §V.A scheme
    kind:

      optimal      — solve_exact            (full joint optimization)
      fast         — solve_fixed_point      (the golden-section kernel)
      paper        — solve_paper            (Algorithm 2 faithful)
      comp_only    — optimal f, uniform beta
      comm_only    — optimal beta, random fixed f
      uniform      — uniform beta, random fixed f
      proportional — beta inversely proportional to distance, random f

    ``random_f`` (N,) and ``inv_dist`` (K, N) are the reference's draws
    bit for bit: ``default_rng(seed).uniform`` on the float32 frequency
    bounds, and 1 / max(dist, 1), both rounded to float32.
    """

    def __init__(self, sc: Scenario, kind: str = "fast", *, seed: int = 0,
                 profile: str = "default", device=None):
        if kind not in SCHEME_KINDS:
            raise ValueError(f"unknown scheme kind {kind!r}")
        if profile not in ra.SCREEN_PROFILES:
            raise ValueError(f"unknown profile {profile!r}")
        self.device = resolve_device(device)
        self.sc = sc
        self.kind = kind
        self.profile = profile
        # every server at once: (K, 1) bandwidth/noise columns -> (K, N)
        consts = ra_constants(sc.dev, sc.srv.bandwidth[:, None],
                              sc.srv.noise[:, None], sc.lp)
        self.consts = RAConstants(**{
            k: v.to(self.device).contiguous() for k, v in vars(consts).items()})
        rng = np.random.default_rng(seed)
        fmin = sc.dev.f_min.cpu().numpy()
        fmax = sc.dev.f_max.cpu().numpy()
        self.random_f = torch.as_tensor(
            rng.uniform(fmin, fmax).astype(np.float32), device=self.device)
        inv = 1.0 / np.maximum(np.asarray(sc.dist), 1.0)
        self.inv_dist = torch.as_tensor(inv.astype(np.float32),
                                        device=self.device)

    def with_profile(self, profile: str) -> "GroupSolver":
        """A view at another iteration profile sharing the constants and
        the fixed draws."""
        if profile not in ra.SCREEN_PROFILES:
            raise ValueError(f"unknown profile {profile!r}")
        if profile == self.profile:
            return self
        clone = object.__new__(GroupSolver)
        clone.__dict__.update(self.__dict__)
        clone.profile = profile
        return clone

    def solve_batch(self, server_ids, masks) -> ra.RASolution:
        """Solve C candidate groups at once: ``server_ids`` (C,), ``masks``
        (C, N), as tensors or arrays. The ``fast`` kind is one kernel
        launch on the card, on each group's members packed into the
        leading slots (:meth:`_solve_packed`)."""
        server_ids = torch.as_tensor(server_ids, dtype=torch.int64,
                                     device=self.device)
        masks = torch.as_tensor(masks, dtype=torch.bool, device=self.device)
        if self.kind == "fast":
            return self._solve_packed(server_ids, masks)
        fixed_f = self.kind in ("comm_only", "uniform", "proportional")
        return solve_groups(
            self.kind, self.consts.rows(server_ids), masks,
            random_f=self.random_f.expand(masks.shape) if fixed_f else None,
            inv_dist=(self.inv_dist[server_ids]
                      if self.kind == "proportional" else None),
            profile=self.profile)

    def _solve_packed(self, server_ids, masks) -> ra.RASolution:
        """The ``fast`` kind on ``(C, N)`` masks, solved at the width of the
        largest group: each group's members, in device order, fill the
        leading slots of its row. The kernel and its plain version sum a
        group's active slots in row order whatever the width, so the result
        is the full-width solve's bit for bit, and a group of N devices no
        longer needs a kernel N slots wide. Masked slots come back as the
        full-width solve gives them: f at f_min, beta 0."""
        c, n = masks.shape
        rows, cols = masks.nonzero(as_tuple=True)      # row-major order
        width = max(int(masks.sum(1).max()) if c else 0, 1)
        slot = masks.cumsum(1)[rows, cols] - 1
        idx = torch.zeros(c, width, dtype=torch.int64, device=self.device)
        idx[rows, slot] = cols
        packed = torch.zeros(c, width, dtype=torch.bool, device=self.device)
        packed[rows, slot] = True
        sids = server_ids[:, None]
        consts = RAConstants(**{
            k: (v[server_ids] if k == "w" else v[sids, idx])
            for k, v in vars(self.consts).items()})
        sol = ra.solve_fixed_point_batched(consts, packed,
                                           **ra.SCREEN_PROFILES[self.profile])
        f = self.consts.f_min[server_ids].clone()
        f[rows, cols] = sol.f[rows, slot]
        beta = torch.zeros_like(f)
        beta[rows, cols] = sol.beta[rows, slot]
        return ra.RASolution(f=f, beta=beta, cost=sol.cost,
                             deadline=sol.deadline)


# ---------------------------------------------------------------------------
# Guarded feasibility helpers (numpy, bit-identical to the reference)
# ---------------------------------------------------------------------------

class NoFeasibleServerError(RuntimeError):
    """A device has no reachable (and, under capacities, no admitting)
    server. ``devices`` lists the offending device indices."""

    def __init__(self, devices, reason: str = "no feasible server"):
        self.devices = np.atleast_1d(np.asarray(devices, dtype=np.int64))
        super().__init__(f"{reason} for device(s) {self.devices.tolist()}")


def nearest_feasible(dist: np.ndarray, feasible: np.ndarray, *,
                     need: np.ndarray | None = None) -> np.ndarray:
    """Nearest feasible server per device ((K, N) inputs, (N,) int64);
    a needed device with an empty feasible column raises."""
    feasible = np.asarray(feasible, dtype=bool)
    any_ok = feasible.any(axis=0)
    satisfied = any_ok if need is None else any_ok | ~np.asarray(need, bool)
    if not satisfied.all():
        raise NoFeasibleServerError(np.flatnonzero(~satisfied))
    return np.argmin(np.where(feasible, np.asarray(dist), np.inf), axis=0)


def parked_slots(sc: Scenario) -> np.ndarray:
    """Bookkeeping slot per device: nearest raw-reachable server, else the
    globally nearest one (zero-raw-reach columns)."""
    dist = np.asarray(sc.dist)
    raw = np.asarray(sc.avail, dtype=bool)
    slots = np.argmin(np.where(raw, dist, np.inf), axis=0)
    orphan = ~raw.any(axis=0)
    if orphan.any():
        slots[orphan] = np.argmin(dist[:, orphan], axis=0)
    return slots


def greedy_admission(dist: np.ndarray, feasible: np.ndarray,
                     load: np.ndarray, cap: np.ndarray,
                     devices: np.ndarray) -> np.ndarray:
    """Sequential nearest-feasible placement under per-edge caps; ``load``
    is mutated in place, ``-1`` marks devices no server could admit."""
    dist = np.asarray(dist)
    feasible = np.asarray(feasible, dtype=bool)
    devices = np.asarray(devices, dtype=np.int64)
    out = np.full(devices.shape[0], -1, dtype=np.int64)
    for r, d in enumerate(devices):
        cand = feasible[:, d] & (load < cap)
        if not cand.any():
            continue
        j = int(np.argmin(np.where(cand, dist[:, d], np.inf)))
        out[r] = j
        load[j] += 1
    return out


def initial_assignment(sc: Scenario, avail: np.ndarray, rng,
                       init: str = "nearest") -> np.ndarray:
    """Initial association (Algorithm 3 line 2): 'nearest' or 'random',
    draw for draw the reference's, with parked slots for inactive devices
    and greedy admission under caps."""
    active = sc.active_mask
    cap = sc.capacity
    avail = np.asarray(avail, dtype=bool)
    out = np.empty(sc.n_devices, dtype=np.int64)
    out[~active] = parked_slots(sc)[~active]
    act = np.flatnonzero(active)
    if init == "nearest":
        if cap is None:
            out[active] = nearest_feasible(sc.dist, avail,
                                           need=active)[active]
            return out
        load = np.zeros(sc.n_servers, dtype=np.int64)
        placed = greedy_admission(sc.dist, avail, load, cap, act)
        if (placed < 0).any():
            raise NoFeasibleServerError(act[placed < 0],
                                        "no admitting server")
        out[act] = placed
        return out
    if init == "random":
        load = np.zeros(sc.n_servers, dtype=np.int64)
        for d in act:
            ok = avail[:, d] if cap is None else avail[:, d] & (load < cap)
            choices = np.flatnonzero(ok)
            if choices.size == 0:
                raise NoFeasibleServerError(
                    [d], "no feasible server" if cap is None
                    else "no admitting server")
            out[d] = rng.choice(choices)
            load[out[d]] += 1
        return out
    raise ValueError(init)


@dataclass
class AssociationResult:
    assignment: np.ndarray            # (N,) device -> server
    f: np.ndarray                     # (N,)
    beta: np.ndarray                  # (N,)
    server_cost: np.ndarray           # (K,) C_i at the stable point
    total_cost: float                 # surrogate objective
    true_energy: float                # eq. (15)
    true_delay: float                 # eq. (16)
    true_cost: float                  # eq. (17)
    n_adjustments: int                # applied permitted adjustments
    n_rounds: int
    cost_trace: list = field(default_factory=list)


def _true_cost_terms(sc: Scenario, active: np.ndarray, assignment: np.ndarray,
                     f: np.ndarray, beta: np.ndarray
                     ) -> tuple[float, float, float]:
    """Eqs. (15)-(17) over the active population; (0, 0, 0) when nobody is
    active."""
    act = np.flatnonzero(np.asarray(active, dtype=bool))
    if act.size == 0:
        return 0.0, 0.0, 0.0
    dev = sc.dev
    if act.size < sc.n_devices:
        dev = dev.take(torch.as_tensor(act, device=sc.device))

    def t(x):
        return torch.as_tensor(np.asarray(x)[act], device=sc.device)

    e, d, c = global_cost(dev, sc.srv, t(assignment), t(f),
                          t(np.maximum(np.asarray(beta), np.float32(1e-9))),
                          sc.lp)
    return tuple(torch.stack([e, d, c]).tolist())     # one host sync


def _gather_f_beta(masks: torch.Tensor, sols: ra.RASolution):
    """Per-device f and beta of a (K, N) membership's solutions (each
    device in at most one group)."""
    zero = sols.f.new_zeros(())
    return (torch.where(masks, sols.f, zero).sum(0).cpu().numpy(),
            torch.where(masks, sols.beta, zero).sum(0).cpu().numpy())


class AssociationEngine:
    """Runs initialization + adjustment iterations to a stable system point
    on the host, pricing groups through :class:`GroupSolver` (``device``:
    ``None`` = CUDA, raising without a card)."""

    def __init__(self, sc: Scenario, *, kind: str = "fast",
                 permission: str = "utilitarian", min_residual_group: int = 2,
                 seed: int = 0, rel_tol: float = 1e-5, device=None):
        if permission not in ("utilitarian", "pareto"):
            raise ValueError(f"unknown permission {permission!r}")
        self.sc = sc
        self.solver = GroupSolver(sc, kind, seed=seed, device=device)
        self.permission = permission
        self.min_residual = min_residual_group
        self.rel_tol = rel_tol
        self.rng = np.random.default_rng(seed)
        self._cache: dict[tuple[int, frozenset], float] = {}
        # inactive devices can associate with no one
        self.avail = np.asarray(sc.eff_avail)                 # (K, N)
        self._active = sc.active_mask
        # a server at cap rejects inbound transfers; exchanges are 1-for-1
        self.cap = sc.capacity
        self.cloud_const = (sc.lp.lambda_e * cloud_energy(sc.srv)
                            + sc.lp.lambda_t * cloud_delay(sc.srv)
                            ).cpu().numpy().astype(np.float64)

    # -- group cost with memoization (the paper's history sets h_i) ---------

    def group_cost(self, server: int, members: frozenset) -> float:
        key = (server, members)
        if key not in self._cache:
            self.group_costs_batch([key])
        return self._cache[key]

    def group_costs_batch(self, pairs: list[tuple[int, frozenset]]) -> np.ndarray:
        """Memoized batched evaluation of many (server, members) groups."""
        missing = [p for p in set(pairs) if p not in self._cache]
        if missing:
            servers = np.array([s for s, _ in missing])
            masks = np.zeros((len(missing), self.sc.n_devices), bool)
            for r, (_, mem) in enumerate(missing):
                masks[r, list(mem)] = True
            sols = self.solver.solve_batch(servers, masks)
            costs = sols.cost.cpu().numpy().astype(np.float64)
            for p, c in zip(missing, costs):
                self._cache[p] = float(c) + (self.cloud_const[p[0]]
                                             if p[1] else 0.0)
        return np.array([self._cache[p] for p in pairs])

    # -- initial association (Algorithm 3 line 2) ----------------------------

    def initial_assignment(self, init: str = "nearest") -> np.ndarray:
        return initial_assignment(self.sc, self.avail, self.rng, init)

    def _check_caps(self, groups) -> None:
        """An explicit assignment must enter the descent cap-feasible."""
        if self.cap is None:
            return
        over = [i for i, g in enumerate(groups) if len(g) > self.cap[i]]
        if over:
            raise ValueError(
                f"assignment exceeds max_devices at server(s) {over}")

    # -- permission test -----------------------------------------------------

    def _permitted(self, old_costs: list[float], new_costs: list[float]) -> bool:
        scale = max(sum(old_costs), 1e-9)
        improves = sum(new_costs) < sum(old_costs) - self.rel_tol * scale
        if self.permission == "utilitarian":
            return improves
        no_harm = all(nc <= oc + self.rel_tol * max(oc, 1e-9)
                      for oc, nc in zip(old_costs, new_costs))
        return improves and no_harm

    # -- faithful Algorithm 3 ------------------------------------------------

    def run(self, init: str = "nearest", *, max_rounds: int = 200,
            exchange_samples: int = 1,
            assignment: np.ndarray | None = None) -> AssociationResult:
        """Algorithm 3: each round every device tries every permitted
        transfer (lines 8-10), then ``exchange_samples`` random exchange
        attempts (line 11); stop on a round that changes nothing."""
        assignment = (self.initial_assignment(init) if assignment is None
                      else np.asarray(assignment).copy())
        groups = self._groups_of(assignment)
        self._check_caps(groups)
        n, k = self.sc.n_devices, self.sc.n_servers
        n_adj = 0
        trace = [self._total(groups)]

        for rnd in range(max_rounds):
            changed = False
            for dev in range(n):
                src = int(assignment[dev])
                if len(groups[src]) <= self.min_residual:
                    continue
                targets = [j for j in range(k)
                           if j != src and self.avail[j, dev]
                           and (self.cap is None
                                or len(groups[j]) < self.cap[j])]
                if not targets:
                    continue
                src_after = groups[src] - {dev}
                pairs = [(src, groups[src]), (src, src_after)]
                for j in targets:
                    pairs += [(j, groups[j]), (j, groups[j] | {dev})]
                self.group_costs_batch(pairs)     # warm the cache in one shot
                best = None
                for j in targets:
                    old = [self.group_cost(src, groups[src]),
                           self.group_cost(j, groups[j])]
                    new = [self.group_cost(src, src_after),
                           self.group_cost(j, groups[j] | {dev})]
                    if self._permitted(old, new):
                        delta = sum(new) - sum(old)
                        if best is None or delta < best[0]:
                            best = (delta, j)
                if best is not None:
                    j = best[1]
                    groups[src] = src_after
                    groups[j] = groups[j] | {dev}
                    assignment[dev] = j
                    n_adj += 1
                    changed = True
                    trace.append(self._total(groups))
            for _ in range(exchange_samples):
                if self._try_exchange(assignment, groups):
                    n_adj += 1
                    changed = True
                    trace.append(self._total(groups))
            if not changed:
                return self._finalize(assignment, groups, n_adj, rnd + 1, trace)
        return self._finalize(assignment, groups, n_adj, max_rounds, trace)

    def _try_exchange(self, assignment, groups) -> bool:
        k = self.sc.n_servers
        occupied = [i for i in range(k) if groups[i]]
        if len(occupied) < 2:
            return False
        i, j = self.rng.choice(occupied, size=2, replace=False)
        dev_n = int(self.rng.choice(sorted(groups[i])))
        dev_m = int(self.rng.choice(sorted(groups[j])))
        if not (self.avail[j, dev_n] and self.avail[i, dev_m]):
            return False
        gi = (groups[i] - {dev_n}) | {dev_m}
        gj = (groups[j] - {dev_m}) | {dev_n}
        old = [self.group_cost(i, groups[i]), self.group_cost(j, groups[j])]
        new = [self.group_cost(i, gi), self.group_cost(j, gj)]
        if self._permitted(old, new):
            groups[i], groups[j] = gi, gj
            assignment[dev_n], assignment[dev_m] = j, i
            return True
        return False

    # -- batched steepest-descent rounds --------------------------------------

    def run_batched(self, init: str = "nearest", *, max_moves: int = 10_000,
                    exchange_samples: int = 64,
                    assignment: np.ndarray | None = None) -> AssociationResult:
        """Evaluate ALL candidate transfers per round in one batched solve
        and apply the single best permitted move (steepest descent); when
        none is permitted, the best of a batch of sampled exchanges."""
        assignment = (self.initial_assignment(init) if assignment is None
                      else np.asarray(assignment).copy())
        groups = self._groups_of(assignment)
        self._check_caps(groups)
        n, k = self.sc.n_devices, self.sc.n_servers
        n_adj = 0
        trace = [self._total(groups)]
        moves = 0

        while moves < max_moves:
            cands = []
            pairs = []
            for dev in range(n):
                src = int(assignment[dev])
                if len(groups[src]) <= self.min_residual:
                    continue
                for dst in range(k):
                    if dst == src or not self.avail[dst, dev]:
                        continue
                    if (self.cap is not None
                            and len(groups[dst]) >= self.cap[dst]):
                        continue
                    cands.append((dev, src, dst))
                    pairs += [(src, groups[src]), (src, groups[src] - {dev}),
                              (dst, groups[dst]), (dst, groups[dst] | {dev})]
            best = None
            if cands:
                costs = self.group_costs_batch(pairs).reshape(-1, 4)
                for (dev, src, dst), row in zip(cands, costs):
                    old = [row[0], row[2]]
                    new = [row[1], row[3]]
                    if self._permitted(old, new):
                        delta = sum(new) - sum(old)
                        if best is None or delta < best[0]:
                            best = (delta, dev, src, dst)
            if best is not None:
                _, dev, src, dst = best
                groups[src] = groups[src] - {dev}
                groups[dst] = groups[dst] | {dev}
                assignment[dev] = dst
                n_adj += 1
                moves += 1
                trace.append(self._total(groups))
                continue
            if not self._batched_exchange(assignment, groups, exchange_samples):
                break
            n_adj += 1
            moves += 1
            trace.append(self._total(groups))
        return self._finalize(assignment, groups, n_adj, moves, trace)

    def _batched_exchange(self, assignment, groups, samples: int) -> bool:
        n = self.sc.n_devices
        cands = []
        pairs = []
        for _ in range(samples):
            dev_n, dev_m = self.rng.choice(n, size=2, replace=False)
            i, j = int(assignment[dev_n]), int(assignment[dev_m])
            if i == j or not (self.avail[j, dev_n] and self.avail[i, dev_m]):
                continue
            gi = (groups[i] - {dev_n}) | {dev_m}
            gj = (groups[j] - {dev_m}) | {dev_n}
            cands.append((dev_n, dev_m, i, j, gi, gj))
            pairs += [(i, groups[i]), (i, gi), (j, groups[j]), (j, gj)]
        if not cands:
            return False
        costs = self.group_costs_batch(pairs).reshape(-1, 4)
        best = None
        for (dev_n, dev_m, i, j, gi, gj), row in zip(cands, costs):
            if self._permitted([row[0], row[2]], [row[1], row[3]]):
                delta = (row[1] + row[3]) - (row[0] + row[2])
                if best is None or delta < best[0]:
                    best = (delta, dev_n, dev_m, i, j, gi, gj)
        if best is None:
            return False
        _, dev_n, dev_m, i, j, gi, gj = best
        groups[i], groups[j] = gi, gj
        assignment[dev_n], assignment[dev_m] = j, i
        return True

    # -- bookkeeping -----------------------------------------------------------

    def _groups_of(self, assignment) -> list[frozenset]:
        # inactive devices hold a parked slot but belong to no group
        return [frozenset(np.flatnonzero((assignment == i) & self._active))
                for i in range(self.sc.n_servers)]

    def _total(self, groups) -> float:
        return float(sum(self.group_cost(i, g) for i, g in enumerate(groups)))

    def _finalize(self, assignment, groups, n_adj, n_rounds, trace) -> AssociationResult:
        k = self.sc.n_servers
        masks = np.zeros((k, self.sc.n_devices), bool)
        for i, g in enumerate(groups):
            masks[i, list(g)] = True
        masks_t = torch.as_tensor(masks, device=self.solver.device)
        sols = self.solver.solve_batch(np.arange(k), masks_t)
        f, beta = _gather_f_beta(masks_t, sols)
        e, t, c = _true_cost_terms(self.sc, self._active, assignment, f, beta)
        return AssociationResult(
            assignment=assignment.copy(), f=f, beta=beta,
            server_cost=sols.cost.cpu().numpy(),
            total_cost=self._total(groups),
            true_energy=e, true_delay=t, true_cost=c,
            n_adjustments=n_adj, n_rounds=n_rounds, cost_trace=trace)


# ---------------------------------------------------------------------------
# §V.A benchmark schemes
# ---------------------------------------------------------------------------

SCHEMES = {"hfel": "fast", "random": "fast", "greedy": "fast",
           "comp_opt": "comp_only", "comm_opt": "comm_only",
           "uniform": "uniform", "proportional": "proportional"}


def evaluate_scheme(sc: Scenario, scheme: str, *, seed: int = 0,
                    batched: bool = True, engine: str = "fast",
                    profile: str = "default", tiers=None,
                    compact: bool | str = "auto",
                    device=None) -> AssociationResult:
    """Run one of the paper's §V.A comparison schemes end to end.

      hfel           — edge association + full joint RA (the paper's algorithm)
      random         — random association, full RA, no association iterations
      greedy         — nearest-server association, full RA, no iterations
      comp_opt       — association + optimal-f / uniform-beta RA
      comm_opt       — association + optimal-beta / random-f RA
      uniform        — association + uniform-beta / random-f (no RA opt.)
      proportional   — association + inverse-distance beta / random-f

    ``engine`` picks the association iterator of the iterative schemes:
    ``"fast"`` (:class:`~repro_torch.core.assoc_fast.FastAssociationEngine`,
    with its default of 64 sampled exchanges), ``"batched"``
    (:meth:`AssociationEngine.run_batched`) or ``"loop"`` (the faithful
    :meth:`AssociationEngine.run`); ``batched=False`` is an alias of
    ``"loop"``. ``tiers`` (a ``TIER_PLANS`` plan or profile tuple) runs the
    fast engine's :meth:`run_tiered`. ``compact`` is the fast engine's
    sweep space (``False``, ``True``, ``"bucketed"`` or ``"auto"``).
    ``device``: ``None`` = CUDA, raising without a card.
    """
    kind = SCHEMES[scheme]
    if scheme in ("random", "greedy"):
        eng = AssociationEngine(sc, kind=kind, seed=seed, device=device)
        init = "random" if scheme == "random" else "nearest"
        assignment = eng.initial_assignment(init)
        groups = eng._groups_of(assignment)
        return eng._finalize(assignment, groups, 0, 0, [eng._total(groups)])
    init = "random"
    if not batched:
        engine = "loop"
    if engine == "fast":
        from repro_torch.core.assoc_fast import FastAssociationEngine
        eng = FastAssociationEngine(sc, kind=kind, seed=seed, profile=profile,
                                    compact=compact, device=device)
        if tiers is not None:
            return eng.run_tiered(init, tiers=tiers)
        return eng.run(init)
    if tiers is not None:
        raise ValueError("tiered descent requires engine='fast'")
    eng = AssociationEngine(sc, kind=kind, seed=seed, device=device)
    if engine == "batched":
        return eng.run_batched(init)
    if engine == "loop":
        return eng.run(init)
    raise ValueError(engine)
