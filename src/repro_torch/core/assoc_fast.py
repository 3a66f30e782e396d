"""Edge association to a stable point: the dense, transfer-only engine.

Port of ``repro.core.assoc_fast.FastAssociationEngine`` for the dense sweep
space (``compact=False``) without sampled exchanges. State is a dense
``(K, N)`` boolean membership mask plus a toggle-cost cache::

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
launch of the golden-section kernel per row. The JAX engine runs this loop
as one ``lax.while_loop``; here it is a Python loop with one host sync per
move (fusing it is later work).

Not ported yet, and raising ``NotImplementedError`` (ROADMAP queue 1,
item 6): the compact and bucketed slot spaces (b), sampled exchanges (d),
``rerun_incremental`` (e), ``run_tiered`` (f) and the sharded sweep.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import resource_allocation as ra
from repro_torch.core.cost_model import cloud_delay, cloud_energy, global_cost
from repro_torch.core.edge_association import (AssociationResult, GroupSolver,
                                               initial_assignment)
from repro_torch.core.scenario import Scenario

#: The JAX engine's default sampled-exchange budget. Kept as the default so
#: no caller silently gets a transfer-only result: any value above 0 raises
#: until exchanges are ported; pass ``exchange_samples=0``.
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
    return float(e), float(d), float(c)


def _gather_f_beta(masks: torch.Tensor, sols: ra.RASolution):
    """Per-device f and beta of a dense (K, N) membership's solutions."""
    zero = sols.f.new_zeros(())
    return (torch.where(masks, sols.f, zero).sum(0).cpu().numpy(),
            torch.where(masks, sols.beta, zero).sum(0).cpu().numpy())


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
    """Steepest permitted transfer per round to a stable point, with the
    reference's permission rules, tolerances and tie-breaking.

    ``device=None`` means CUDA and raises without a card; pass
    ``device="cpu"`` for the plain PyTorch path. ``last_timing`` holds the
    seconds of the last sweep's cache init and of its moves.
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
        self.last_moves: int | None = None
        self.last_timing: dict[str, float] | None = None

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
        """One descent to the stable point. Only ``exchange_samples=0`` (a
        deterministic transfer-only sweep) is ported. ``finalize=False``
        returns just the (N,) stable assignment."""
        if exchange_samples:
            raise _not_ported(
                f"exchange_samples={exchange_samples} (sampled exchanges; "
                "pass exchange_samples=0 for a transfer-only sweep)", "6(d)")
        assignment = (self.initial_assignment(init) if assignment is None
                      else np.asarray(assignment))
        assignment, member, moves, trace = self._sweep(
            assignment, self.profile, max_moves)
        if not finalize:
            return assignment.copy()
        return self._finalize(assignment, member, moves, trace)

    def run_tiered(self, *args, **kwargs):
        raise _not_ported("run_tiered", "6(f)")

    def rerun_incremental(self, *args, **kwargs):
        raise _not_ported("rerun_incremental", "6(e)")

    def _sweep(self, assignment: np.ndarray, profile: str, max_moves: int):
        """One profile's adjustment loop; returns (assignment, dense member,
        n_moves, trace)."""
        assignment = np.asarray(assignment, dtype=np.int64)
        k = self.sc.n_servers
        if self.cap is not None:
            # transfers are cap-gated, so a sweep keeps an assignment
            # feasible only if it starts feasible
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
        moves, trace = self._descend(member, assign,
                                     self.solver.with_profile(profile),
                                     max_moves)
        self.last_moves = moves
        return assign, member.cpu().numpy(), moves, trace

    def _descend(self, member: torch.Tensor, assign: np.ndarray,
                 solver: GroupSolver, max_moves: int):
        """The adjustment loop (``_run_device_impl`` of the reference, dense
        bucket, transfers only). Updates ``member`` and ``assign`` in place;
        returns (n_moves, trace)."""
        k, n = member.shape
        dev = self.device
        servers = torch.arange(k, device=dev)
        idx_n = torch.arange(n, device=dev)
        eye = torch.eye(n, dtype=torch.bool, device=dev)
        # device-major tie-break key: the smallest n*K + k among equal deltas
        order = idx_n[None, :] * k + servers[:, None]
        big = torch.tensor(_I64_BIG, device=dev)
        inf = torch.tensor(math.inf, device=dev)
        rel_tol = self.rel_tol
        assign_t = torch.as_tensor(assign, device=dev)

        def harmless(new, old):
            return new <= old + rel_tol * torch.clamp_min(old, 1e-9)

        def row_costs(s: int) -> torch.Tensor:
            """Cost of server s's group and of its N single-slot toggles."""
            base = member[s][None]
            masks = torch.cat([base, base ^ eye])                # (N+1, N)
            sol = solver.solve_batch(torch.full((n + 1,), s, device=dev),
                                     masks)
            return sol.cost + torch.where(masks.any(-1), self.cloud_const[s],
                                          0.0)

        t0 = time.perf_counter()
        cur = torch.zeros(k, device=dev)
        toggles = torch.empty(k, n, device=dev)

        def refresh(s: int) -> None:
            costs = row_costs(s)
            cur[s] = costs[0]
            toggles[s] = costs[1:]

        for s in range(k):
            refresh(s)
        trace = [cur.sum()]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)     # so init_s times the init
        t1 = time.perf_counter()

        moves = 0
        while moves < max_moves:
            # scan every transfer candidate from the cache, no solves
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
            if self.permission == "pareto":
                permitted &= (harmless(toggles, cur_b)
                              & harmless(minus, cur_src)[None, :])
            masked = torch.where(permitted, delta, inf)
            best = masked.min()
            p = torch.where(masked == best, order, big).argmin()
            best_v, p_v = torch.stack([best.double(), p.double()]).tolist()
            if not math.isfinite(best_v):
                break
            t_dst, t_dev = divmod(int(p_v), n)
            t_src = int(assign[t_dev])
            member[t_src, t_dev] = False
            member[t_dst, t_dev] = True
            assign[t_dev] = t_dst
            assign_t[t_dev] = t_dst
            refresh(t_src)
            refresh(t_dst)
            moves += 1
            trace.append(cur.sum())
        trace = torch.stack(trace).cpu().double().tolist()
        self.last_timing = {"init_s": t1 - t0,
                            "moves_s": time.perf_counter() - t1}
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
