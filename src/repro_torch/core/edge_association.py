"""Edge association across edge servers — paper Section IV (port slice).

Port of ``repro.core.edge_association``: the per-server group solver for the
``fast`` scheme kind, the guarded feasibility helpers (numpy, bit-identical
to the reference) and :class:`AssociationResult`. The other §V.A scheme
kinds, the host reference ``AssociationEngine`` and ``evaluate_scheme`` are
not ported yet (ROADMAP queue 1, items 4 and 5).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import resource_allocation as ra
from repro_torch.core.cost_model import RAConstants, ra_constants
from repro_torch.core.scenario import Scenario

SCHEME_KINDS = ("optimal", "fast", "paper", "comp_only", "comm_only",
                "uniform", "proportional")


def _check_kind(kind: str) -> None:
    if kind not in SCHEME_KINDS:
        raise ValueError(f"unknown scheme kind {kind!r}")
    if kind != "fast":
        raise NotImplementedError(
            f"scheme kind {kind!r} is not ported yet (ROADMAP queue 1, "
            "items 4-5: the other solvers and scheme kinds); only 'fast'")


def solve_group(kind: str, c: RAConstants, mask, *,
                profile: str = "default") -> ra.RASolution:
    """Single-group RA dispatch: ``c`` holds ONE server's constants and
    ``mask`` selects the group members."""
    _check_kind(kind)
    return ra.solve_fixed_point(c, mask, **ra.SCREEN_PROFILES[profile])


class GroupSolver:
    """Caches the per-server RA constants ``(K, N)`` on one device and
    solves batches of (server, member-mask) groups through the kernel.
    ``seed`` keeps the reference's signature: the fixed random draws it
    seeds there serve only the scheme kinds not ported yet."""

    def __init__(self, sc: Scenario, kind: str = "fast", *, seed: int = 0,
                 profile: str = "default", device=None):
        _check_kind(kind)
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

    def with_profile(self, profile: str) -> "GroupSolver":
        """A view at another iteration profile sharing the constants."""
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
        (C, N), as tensors or arrays; one kernel launch on the card."""
        server_ids = torch.as_tensor(server_ids, dtype=torch.int64,
                                     device=self.device)
        masks = torch.as_tensor(masks, dtype=torch.bool, device=self.device)
        return ra.solve_fixed_point_batched(
            self.consts.rows(server_ids), masks,
            **ra.SCREEN_PROFILES[self.profile])


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
