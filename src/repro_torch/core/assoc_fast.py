"""Edge association to a stable point: the dense device-resident engine.

Port of ``repro.core.assoc_fast.FastAssociationEngine`` for the dense sweep
space (``compact=False``), with Algorithm 3's transfers and sampled
exchanges. State is a dense ``(K, N)`` boolean membership mask plus a
toggle-cost cache::

    toggle[k, n] = group cost of  member[k] XOR {n}
    cur[k]       = group cost of  member[k]

XOR adds a device when it is absent and removes it when present, so the
cache holds both halves of every transfer and the delta of moving device n
from its server s to server k is pure arithmetic::

    delta = (toggle[s, n] - cur[s]) + (toggle[k, n] - cur[k])

Each round scans every candidate from the cache with no solve, picks the
best permitted move with the reference's explicit device-major tie-break
key (smallest ``n*K + k`` among equal deltas), applies it, and re-solves
the two touched servers' rows: ``N + 1`` groups of width ``N`` each, one
launch of the golden-section kernel per row for the ``fast`` kind.

A round with no permitted transfer tries sampled exchanges (Definition 5):
it splits the PRNG key (:mod:`repro_torch.core.prng`, the JAX engine's
threefry stream bit for bit; a transfer round leaves the key alone), draws
``exchange_samples`` device pairs, prices both swapped groups of every
pair in one batch of ``2 * exchange_samples`` groups (one kernel launch)
and applies the first best permitted swap, then refreshes both servers'
rows. The descent stops on a round where neither applies. The JAX engine
runs this loop as one ``lax.while_loop``; here it is a Python loop with
one host sync per round (fusing it is later work).

:meth:`FastAssociationEngine.run_tiered` runs the loop once per profile of
a ``TIER_PLANS`` plan, each tier warm-started from the last's assignment
with the key ``fold_in(PRNGKey(seed), tier)``.

Not ported yet, and raising ``NotImplementedError`` (ROADMAP queue 1): the
compact and bucketed slot spaces (item 6(b)), ``rerun_incremental`` (6(e))
and the sharded sweep (6, last).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.core import resource_allocation as ra
from repro_torch.core.cost_model import cloud_delay, cloud_energy
from repro_torch.core.edge_association import (AssociationResult, GroupSolver,
                                               _gather_f_beta,
                                               _true_cost_terms,
                                               initial_assignment)
from repro_torch.core.scenario import Scenario

#: The engine-wide sampled-exchange budget (Definition 5 escape moves per
#: stuck round), as in the JAX engine; pass ``exchange_samples=0`` for a
#: deterministic transfer-only sweep.
DEFAULT_EXCHANGE_SAMPLES = 64

_I64_BIG = torch.iinfo(torch.int64).max


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, item {item})")


def _dense_member(assignment: np.ndarray, active: np.ndarray,
                  n_servers: int) -> np.ndarray:
    """Dense (K, N) membership of an assignment, gated by the active mask."""
    member = np.zeros((n_servers, assignment.shape[0]), dtype=bool)
    act = np.asarray(active, dtype=bool)
    member[np.asarray(assignment)[act], np.flatnonzero(act)] = True
    return member


def assignment_true_cost(sc: Scenario, assignment: np.ndarray, *,
                         solver: GroupSolver | None = None,
                         kind: str = "fast", seed: int = 0, device=None
                         ) -> tuple[float, float, float]:
    """Eqs. (15)-(17) ``(energy, delay, cost)`` of an explicit assignment at
    reference RA accuracy, gated by the scenario's active mask."""
    if solver is None:
        solver = GroupSolver(sc, kind, seed=seed, profile="default",
                             device=device)
    elif solver.kind != kind:
        raise ValueError(f"prebuilt solver was built for kind="
                         f"{solver.kind!r}, not {kind!r}")
    else:
        solver = solver.with_profile("default")
    assignment = np.asarray(assignment)
    active = sc.active_mask
    member = torch.as_tensor(_dense_member(assignment, active, sc.n_servers),
                             device=solver.device)
    sols = solver.solve_batch(np.arange(sc.n_servers), member)
    f, beta = _gather_f_beta(member, sols)
    return _true_cost_terms(sc, active, assignment, f, beta)


class FastAssociationEngine:
    """Steepest permitted transfer per round, and the best of a batch of
    sampled exchanges when no transfer is permitted, to a stable point,
    with the reference's permission rules, tolerances, tie-breaking and
    PRNG stream. ``kind`` is any §V.A scheme kind of :class:`GroupSolver`.

    ``device=None`` means CUDA and raises without a card; pass
    ``device="cpu"`` for the plain PyTorch path. ``last_timing`` holds the
    seconds of the last sweep's cache init, of its moves (every round after
    the init) and, within them, of pricing its exchange rounds (draw,
    batch solve, pick); ``last_counts`` its transfers, exchanges and
    exchange rounds.
    """

    def __init__(self, sc: Scenario, *, kind: str = "fast",
                 permission: str = "utilitarian", min_residual_group: int = 2,
                 seed: int = 0, rel_tol: float = 1e-5,
                 profile: str = "default", compact: bool | str = False,
                 shards: int | None = None, device=None):
        if permission not in ("utilitarian", "pareto"):
            raise ValueError(f"unknown permission {permission!r}")
        if compact not in (False, "auto"):
            raise _not_ported(f"compact={compact!r}", "6(b)")
        if (compact == "auto"
                and int(sc.eff_avail.sum(axis=1).max()) < sc.n_devices):
            # the reference's "auto" stays dense only when a server
            # reaches every device
            raise _not_ported("compact='auto' on a sparse-reach scenario "
                              "(it resolves to a compact space)", "6(b)")
        if shards is not None:
            raise _not_ported("the sharded sweep (shards=p)", "6, last")
        self.device = resolve_device(device)
        self.solver = GroupSolver(sc, kind, seed=seed, profile=profile,
                                  device=self.device)
        # final reporting is always at reference accuracy
        self._eval_solver = self.solver.with_profile("default")
        self.sc = sc
        self.kind = kind
        self.profile = profile
        self.permission = permission
        self.min_residual = min_residual_group
        self.rel_tol = rel_tol
        self.rng = np.random.default_rng(seed)
        self._active = sc.active_mask
        self.avail = np.asarray(sc.eff_avail)
        self.cap = sc.capacity
        # uncapped engines pass N: never binding, since an inbound transfer
        # needs a donor group elsewhere
        self._cap = torch.as_tensor(
            np.full(sc.n_servers, sc.n_devices, np.int64)
            if self.cap is None else self.cap, device=self.device)
        self._ok = torch.as_tensor(self.avail, device=self.device)
        self.cloud_const = (sc.lp.lambda_e * cloud_energy(sc.srv)
                            + sc.lp.lambda_t * cloud_delay(sc.srv)
                            ).to(self.device)
        self.seed = seed
        self.last_moves: int | None = None
        self.last_tier_moves: list[int] | None = None
        self.last_timing: dict[str, float] | None = None
        self.last_counts: dict[str, int] | None = None

    def initial_assignment(self, init: str = "nearest") -> np.ndarray:
        return initial_assignment(self.sc, self.avail, self.rng, init)

    def _member_of(self, assignment: np.ndarray) -> np.ndarray:
        return _dense_member(np.asarray(assignment), self._active,
                             self.sc.n_servers)

    def evaluate_assignment(self, assignment: np.ndarray) -> float:
        """Reference-accuracy total system cost of an explicit assignment,
        the same evaluation ``_finalize`` applies to a stable point."""
        member = self._member_of(np.asarray(assignment))
        sols = self._eval_solver.solve_batch(np.arange(self.sc.n_servers),
                                             member)
        cloud = self.cloud_const.cpu().numpy()
        return float(np.sum(sols.cost.cpu().numpy()
                            + np.where(member.any(axis=1), cloud, 0.0)))

    def run(self, init: str = "nearest", *, max_moves: int = 10_000,
            exchange_samples: int = DEFAULT_EXCHANGE_SAMPLES,
            assignment: np.ndarray | None = None, finalize: bool = True):
        """One descent to the stable point with the key ``PRNGKey(seed)``.
        ``exchange_samples`` (default 64) device pairs are drawn on each
        round with no permitted transfer; 0 gives a deterministic
        transfer-only sweep. ``finalize=False`` returns just the (N,)
        stable assignment."""
        assignment = (self.initial_assignment(init) if assignment is None
                      else np.asarray(assignment))
        assignment, member, moves, trace = self._sweep(
            assignment, self.profile, max_moves, exchange_samples,
            prng.PRNGKey(self.seed))
        if not finalize:
            return assignment.copy()
        return self._finalize(assignment, member, moves, trace)

    def run_tiered(self, init: str = "nearest", *,
                   tiers: str | tuple[str, ...] = "two_tier",
                   max_moves: int = 10_000,
                   exchange_samples: int = DEFAULT_EXCHANGE_SAMPLES,
                   tier_rel_tols: tuple[float, ...] | None = None,
                   assignment: np.ndarray | None = None) -> AssociationResult:
        """Drive each profile of ``tiers`` (a ``TIER_PLANS`` plan name or a
        profile tuple) to its stable point, each tier warm-started from the
        previous tier's assignment with the key ``fold_in(PRNGKey(seed),
        tier)`` and its own stop tolerance (``tier_rel_tols``, default the
        engine's). The trace concatenates the tiers (monotone within each);
        ``last_tier_moves`` holds each tier's moves."""
        profiles = ra.resolve_tiers(tiers)
        rel_tols = (tuple(tier_rel_tols) if tier_rel_tols is not None
                    else (self.rel_tol,) * len(profiles))
        if len(rel_tols) != len(profiles):
            raise ValueError(
                f"tier_rel_tols has {len(rel_tols)} entries for "
                f"{len(profiles)} tiers")
        assignment = (self.initial_assignment(init) if assignment is None
                      else np.asarray(assignment))
        base_key = prng.PRNGKey(self.seed)
        total_moves = 0
        trace: list[float] = []
        tier_moves: list[int] = []
        member = None
        for i, (prof, tol) in enumerate(zip(profiles, rel_tols)):
            assignment, member, moves, tr = self._sweep(
                assignment, prof, max_moves, exchange_samples,
                prng.fold_in(base_key, i), rel_tol=tol)
            total_moves += moves
            tier_moves.append(moves)
            trace.extend(tr)
        self.last_tier_moves = tier_moves
        return self._finalize(assignment, member, total_moves, trace)

    def rerun_incremental(self, *args, **kwargs):
        raise _not_ported("rerun_incremental", "6(e)")

    def _sweep(self, assignment: np.ndarray, profile: str, max_moves: int,
               exchange_samples: int, key: torch.Tensor,
               rel_tol: float | None = None):
        """One profile's adjustment loop; returns (assignment, dense member,
        n_moves, trace)."""
        assignment = np.asarray(assignment, dtype=np.int64)
        k = self.sc.n_servers
        if self.cap is not None:
            # transfers are cap-gated and exchanges cap-neutral, so a sweep
            # keeps an assignment feasible only if it starts feasible
            load = np.bincount(assignment[self._active], minlength=k)
            over = np.flatnonzero(load > self.cap)
            if over.size:
                raise ValueError(
                    f"assignment exceeds max_devices at server(s) "
                    f"{over.tolist()[:8]} (load {load[over].tolist()[:8]} "
                    f"> cap {self.cap[over].tolist()[:8]})")
        member = torch.as_tensor(self._member_of(assignment),
                                 device=self.device)
        assign = assignment.copy()
        moves, trace = self._descend(
            member, assign, self.solver.with_profile(profile), max_moves,
            exchange_samples, key,
            self.rel_tol if rel_tol is None else rel_tol)
        self.last_moves = moves
        return assign, member.cpu().numpy(), moves, trace

    def _descend(self, member: torch.Tensor, assign: np.ndarray,
                 solver: GroupSolver, max_moves: int, exchange_samples: int,
                 key: torch.Tensor, rel_tol: float):
        """The adjustment loop (``_run_device_impl`` of the reference,
        dense bucket, single device). Updates ``member`` and ``assign`` in
        place; returns (n_moves, trace) and sets ``last_timing`` and
        ``last_counts``."""
        k, n = member.shape
        dev = self.device
        servers = torch.arange(k, device=dev)
        idx_n = torch.arange(n, device=dev)
        eye = torch.eye(n, dtype=torch.bool, device=dev)
        # device-major tie-break key: the smallest n*K + k among equal deltas
        order = idx_n[None, :] * k + servers[:, None]
        big = torch.tensor(_I64_BIG, device=dev)
        inf = torch.tensor(math.inf, device=dev)
        assign_t = torch.as_tensor(assign, device=dev)
        pareto = self.permission == "pareto"

        def harmless(new, old):
            return new <= old + rel_tol * torch.clamp_min(old, 1e-9)

        def group_costs(sids: torch.Tensor, masks: torch.Tensor, cloud):
            """Group costs plus the cloud constant ``cloud`` (per group, or
            one server's) of each non-empty one."""
            sol = solver.solve_batch(sids, masks)
            return sol.cost + torch.where(masks.any(-1), cloud, 0.0)

        t0 = time.perf_counter()
        cur = torch.zeros(k, device=dev)
        toggles = torch.empty(k, n, device=dev)

        def refresh(s: int) -> None:
            """Re-solve server s's group and its N single-slot toggles."""
            base = member[s][None]
            costs = group_costs(torch.full((n + 1,), s, device=dev),
                                torch.cat([base, base ^ eye]),
                                self.cloud_const[s])
            cur[s] = costs[0]
            toggles[s] = costs[1:]

        for s in range(k):
            refresh(s)
        trace = [cur.sum()]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)     # so init_s times the init
        t1 = time.perf_counter()

        def best_transfer():
            """Scan every transfer candidate from the cache, no solves:
            (delta, flat index) of the best permitted one."""
            cur_src = cur[assign_t]                              # (n,)
            minus = toggles[assign_t, idx_n]                     # (n,)
            gsize = member.sum(1)                                # (k,)
            cur_b = cur[:, None]
            delta = (minus - cur_src)[None, :] + toggles - cur_b
            scale = torch.clamp_min(cur_b + cur_src[None, :], 1e-9)
            valid = (self._ok & (assign_t[None, :] != servers[:, None])
                     & (gsize[assign_t] > self.min_residual)[None, :]
                     & (gsize < self._cap)[:, None])
            permitted = valid & (delta < -rel_tol * scale)
            if pareto:
                permitted &= (harmless(toggles, cur_b)
                              & harmless(minus, cur_src)[None, :])
            masked = torch.where(permitted, delta, inf)
            best = masked.min()
            return best, torch.where(masked == best, order, big).argmin()

        def best_exchange(pairs: torch.Tensor):
            """Price both swapped groups of every sampled pair in one
            batch: (delta, sample index) of the first best permitted one."""
            dn, dm = pairs[:, 0], pairs[:, 1]
            si, sj = assign_t[dn], assign_t[dm]
            okay = ((dn != dm) & (si != sj)
                    & self._ok[sj, dn] & self._ok[si, dm])
            hot_n = idx_n[None, :] == dn[:, None]
            hot_m = idx_n[None, :] == dm[:, None]
            sids = torch.cat([si, sj])
            costs = group_costs(sids,
                                torch.cat([member[si] ^ hot_n ^ hot_m,
                                           member[sj] ^ hot_m ^ hot_n]),
                                self.cloud_const[sids])
            ci, cj = costs[:exchange_samples], costs[exchange_samples:]
            old = cur[si] + cur[sj]
            delta = ci + cj - old
            permitted = okay & (delta < -rel_tol * torch.clamp_min(old, 1e-9))
            if pareto:
                permitted &= harmless(ci, cur[si]) & harmless(cj, cur[sj])
            masked = torch.where(permitted, delta, inf)
            e = masked.argmin()
            return masked[e], e

        def move(dev_: int, src: int, dst: int) -> None:
            member[src, dev_] = False
            member[dst, dev_] = True
            assign[dev_] = dst
            assign_t[dev_] = dst

        moves = transfers = exchanges = exchange_rounds = 0
        exchange_s = 0.0
        while moves < max_moves:
            best, p = best_transfer()
            best_v, p_v = torch.stack([best.double(), p.double()]).tolist()
            if math.isfinite(best_v):
                t_dst, t_dev = divmod(int(p_v), n)
                t_src = int(assign[t_dev])
                move(t_dev, t_src, t_dst)
                transfers += 1
            else:
                if not exchange_samples:
                    break
                # only a round with no permitted transfer splits the key
                te = time.perf_counter()
                key, sub = prng.split(key)
                pairs = prng.randint(sub, (exchange_samples, 2), 0, n)
                exchange_rounds += 1
                best, e = best_exchange(pairs.to(dev))
                best_v, e_v = torch.stack([best.double(),
                                           e.double()]).tolist()
                exchange_s += time.perf_counter() - te
                if not math.isfinite(best_v):
                    break
                dn, dm = pairs[int(e_v)].tolist()
                t_src, t_dst = int(assign[dn]), int(assign[dm])
                move(dn, t_src, t_dst)
                move(dm, t_dst, t_src)
                exchanges += 1
            refresh(t_src)
            refresh(t_dst)
            moves += 1
            trace.append(cur.sum())
        trace = torch.stack(trace).cpu().double().tolist()
        self.last_timing = {"init_s": t1 - t0,
                            "moves_s": time.perf_counter() - t1,
                            "exchange_pricing_s": exchange_s}
        self.last_counts = {"transfers": transfers, "exchanges": exchanges,
                            "exchange_rounds": exchange_rounds}
        return moves, trace

    def _finalize(self, assignment, member, moves, trace) -> AssociationResult:
        k = self.sc.n_servers
        masks = torch.as_tensor(member, device=self.device)
        sols = self._eval_solver.solve_batch(np.arange(k), masks)
        f, beta = _gather_f_beta(masks, sols)
        server_cost = sols.cost.cpu().numpy()
        cloud = self.cloud_const.cpu().numpy()
        total = float(np.sum(server_cost
                             + np.where(member.any(axis=1), cloud, 0.0)))
        e, t, c = _true_cost_terms(self.sc, self._active, assignment, f, beta)
        return AssociationResult(
            assignment=assignment.copy(), f=f, beta=beta,
            server_cost=server_cost, total_cost=total,
            true_energy=e, true_delay=t, true_cost=c,
            n_adjustments=moves, n_rounds=moves, cost_trace=trace)
