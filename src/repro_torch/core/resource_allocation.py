"""Optimal computation/communication resource allocation — paper Section III.

Port of ``repro.core.resource_allocation``, main solver first. It solves
problem (18) for one edge server's training group S_i:

    min  C_i(f, beta) = sum_n [ a_n/beta_n + b_n f_n^2 ]
                        + w * max_n [ d_n/beta_n + e_n/f_n ]
    s.t. sum_n beta_n <= 1,  0 < beta_n <= 1,  f_min <= f_n <= f_max

along the KKT deadline path (golden section over the common deadline t,
bisection bracket, inner beta<->f fixed point). The arithmetic lives once,
in :mod:`repro_torch.kernels.ref`; the batched solve goes through
:func:`repro_torch.kernels.ops.golden_section_solve`, which is the CUDA
kernel on the card. The other solvers (``solve_exact``, ``solve_paper``,
``solve_reference``, the partial-optimization schemes) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.cost_model import RAConstants
from repro_torch.kernels import ops, ref


@dataclass(frozen=True)
class RASolution:
    f: torch.Tensor          # (..., N) CPU frequencies (inactive: f_min)
    beta: torch.Tensor       # (..., N) bandwidth shares (inactive: 0)
    cost: torch.Tensor       # (...) optimal value of (18); 0 for empty group
    deadline: torch.Tensor   # (...) t* = max_n d/beta + e/f


def _masked_beta_norm(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Normalize positive scores s to sum to 1 over the active set."""
    return ref.beta_norm(s, mask)


def _finalize(c: RAConstants, mask, f, beta) -> RASolution:
    """Clip/renormalize a batch of ``(G, R)`` solutions; empty groups
    cost 0."""
    return RASolution(*ref.finalize(c.a, c.b, c.d, c.e, c.w.reshape(-1, 1),
                                    mask.bool(), c.f_min, c.f_max, f, beta))


def beta_of_f(c: RAConstants, mask, f) -> torch.Tensor:
    """Theorem 2, eq. (19): beta*_n ~ (a_n + (2 b_n f_n^3 / e_n) d_n)^(1/3)."""
    return ref.beta_of_f(c.a, c.b, c.d, c.e, mask.bool(), f)


def _deadline_bracket(c: RAConstants, mask, n_bracket: int = 60):
    """Feasible deadline range ``(t_lo, t_hi)`` before widening: every
    device at f_max (lower) and at f_min (upper), bisected together."""
    return ref.deadline_bracket(c.d, c.e, mask.bool(), c.f_min, c.f_max,
                                n_bracket)


# Iteration presets for the fixed-point solver; "default" is the reference
# accuracy, "screen"/"coarse" trade deadline resolution for fewer steps.
SCREEN_PROFILES: dict[str, dict[str, int]] = {
    "default": dict(n_golden=48, n_inner=12, n_bracket=60),
    "screen": dict(n_golden=32, n_inner=8, n_bracket=40),
    "coarse": dict(n_golden=16, n_inner=6, n_bracket=24),
}

# Named multi-tier descent plans: SCREEN_PROFILES names run back to back.
TIER_PLANS: dict[str, tuple[str, ...]] = {
    "default_only": ("default",),
    "two_tier": ("coarse", "default"),
    "three_tier": ("coarse", "screen", "default"),
}


def resolve_tiers(tiers) -> tuple[str, ...]:
    """Normalize a tier spec (plan name, profile name or iterable of
    profile names) into a tuple of SCREEN_PROFILES names."""
    if isinstance(tiers, str):
        tiers = TIER_PLANS.get(tiers, (tiers,))
    tiers = tuple(tiers)
    if not tiers:
        raise ValueError("tier plan resolves to no profiles")
    unknown = [t for t in tiers if t not in SCREEN_PROFILES]
    if unknown:
        raise ValueError(
            f"unknown screening profile(s) {unknown}; expected names from "
            f"SCREEN_PROFILES {sorted(SCREEN_PROFILES)} or a TIER_PLANS "
            f"plan {sorted(TIER_PLANS)}")
    return tiers


def solve_fixed_point(c: RAConstants, mask, *, n_golden: int = 48,
                      n_inner: int = 12, n_bracket: int = 60) -> RASolution:
    """One group's KKT-path solve: constants ``(N,)``, ``w`` 0-dim. It is
    :func:`solve_fixed_point_batched` at G = 1 (the kernel on the card)."""
    sol = solve_fixed_point_batched(c.rows(None), mask[None],
                                    n_golden=n_golden, n_inner=n_inner,
                                    n_bracket=n_bracket)
    return RASolution(f=sol.f[0], beta=sol.beta[0], cost=sol.cost[0],
                      deadline=sol.deadline[0])


def solve_fixed_point_batched(c: RAConstants, masks, *, n_golden: int = 48,
                              n_inner: int = 12,
                              n_bracket: int = 60) -> RASolution:
    """Solve a batch of independent groups: ``c`` fields ``(G, R)``, ``w``
    ``(G,)``, ``masks`` ``(G, R)``. Always goes through
    :func:`repro_torch.kernels.ops.golden_section_solve` — the CUDA kernel
    for CUDA tensors, the plain version for CPU ones."""
    f, beta, cost, deadline = ops.golden_section_solve(
        *(x.contiguous() for x in (c.a, c.b, c.d, c.e, c.w, c.f_min,
                                   c.f_max)),
        masks.bool().contiguous(), n_golden=n_golden, n_inner=n_inner,
        n_bracket=n_bracket)
    return RASolution(f=f, beta=beta, cost=cost, deadline=deadline)
