"""Optimal computation/communication resource allocation — paper Section III.

Port of ``repro.core.resource_allocation``. Every solver takes problem (18)
for a batch of independent groups — constants ``(G, R)``, ``w`` ``(G,)``,
masks ``(G, R)`` — or for one group (``(N,)`` constants, 0-dim ``w``, which
is the batch at G = 1):

    min  C_i(f, beta) = sum_n [ a_n/beta_n + b_n f_n^2 ]
                        + w * max_n [ d_n/beta_n + e_n/f_n ]
    s.t. sum_n beta_n <= 1,  0 < beta_n <= 1,  f_min <= f_n <= f_max

* :func:`solve_fixed_point_batched` — the KKT deadline path (golden section
  over the common deadline t, bisection bracket, inner beta<->f fixed
  point); it goes through :func:`repro_torch.kernels.ops.
  golden_section_solve`, which is the CUDA kernel on the card. Its
  arithmetic lives once, in :mod:`repro_torch.kernels.ref`.
* :func:`solve_paper` — Algorithm 2: beta by eq. (19), Adam over f on an
  annealed log-sum-exp of the max term.
* :func:`solve_exact` — golden section over t, bisection over the bandwidth
  price nu, per-device golden section over beta.
* :func:`solve_reference` — projected subgradient on (f, beta), the oracle.
* :func:`optimize_f_given_beta` / :func:`optimize_beta_given_f` — the
  partial optimizations of the §V.A schemes.

In the JAX package these five are XLA programs with no Pallas kernel behind
them; here they are plain PyTorch on the caller's device, with the
reference's iteration counts. Their masked sums take a halving tree over
the slot axis (:func:`_msum`), elementwise adds whose order does not depend
on the device, so a batch gives the same bits on the card and on the CPU
wherever the other operations round alike (divisions are by tensors, never
by Python scalars, which CUDA turns into a multiply by the reciprocal).
"""

from __future__ import annotations

import functools
import math
from dataclasses import astuple, dataclass

import numpy as np
import torch

from repro_torch.core.cost_model import RAConstants
from repro_torch.kernels import ops, ref


@dataclass(frozen=True)
class RASolution:
    f: torch.Tensor          # (..., N) CPU frequencies (inactive: f_min)
    beta: torch.Tensor       # (..., N) bandwidth shares (inactive: 0)
    cost: torch.Tensor       # (...) optimal value of (18); 0 for empty group
    deadline: torch.Tensor   # (...) t* = max_n d/beta + e/f


# ---------------------------------------------------------------------------
# Shared pieces of the plain-PyTorch solvers
# ---------------------------------------------------------------------------

GOLDEN = ref.GOLDEN
EPS = ref.EPS


def _msum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked sum over the last axis by a halving tree over the axis padded
    to a power of two: the same adds in the same order on every device.
    Returns the reduced shape with a trailing axis of 1."""
    x = torch.where(mask, x, x.new_zeros(()))
    r = x.shape[-1]
    width = 1 << max(r - 1, 0).bit_length()
    if width != r:
        x = torch.nn.functional.pad(x, (0, width - r))
    while width > 1:
        width //= 2
        x = x[..., :width] + x[..., width:]
    return x


def _mmax(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked max over the last axis (masked slots count as 0), keepdim."""
    return torch.where(mask, x, x.new_zeros(())).amax(-1, keepdim=True)


def _objective(c: RAConstants, mask, f, safe_beta) -> torch.Tensor:
    """Problem (18) per group, ``(G, 1)``, with ``w`` broadcast per row."""
    return (_msum(c.a / safe_beta + c.b * torch.square(f), mask)
            + c.w[:, None] * _mmax(c.d / safe_beta + c.e / f, mask))


def _golden_min(fn, lo, hi, n_iter: int):
    """Golden-section minimize with the single-evaluation recurrence (the
    surviving probe is reused via G^2 = 1 - G), elementwise over ``lo`` /
    ``hi``: each element is its own search. Returns the bracket midpoint."""
    m1 = hi - GOLDEN * (hi - lo)
    m2 = lo + GOLDEN * (hi - lo)
    c1, c2 = fn(m1), fn(m2)
    for _ in range(n_iter):
        go_right = c1 > c2
        lo = torch.where(go_right, m1, lo)
        hi = torch.where(go_right, hi, m2)
        m1n = hi - GOLDEN * (hi - lo)
        m2n = lo + GOLDEN * (hi - lo)
        point = torch.where(go_right, m2n, m1n)
        cp = fn(point)
        m1, m2, c1, c2 = (torch.where(go_right, m2, point),
                          torch.where(go_right, point, m1),
                          torch.where(go_right, c2, cp),
                          torch.where(go_right, cp, c1))
    return 0.5 * (lo + hi)


def _bisect(pred, lo, hi, n_iter: int):
    """``n_iter`` halvings of ``[lo, hi]`` keeping ``pred(mid)`` on the
    upper side: ``lo <- mid`` where it holds, ``hi <- mid`` elsewhere."""
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        up = pred(mid)
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
    return lo, hi


def _grow(over, hi, n_iter: int):
    """``n_iter`` steps of ``hi <- 8 hi`` while ``over(hi)`` holds (``over``
    falls as hi grows). The steps run at once: ``over`` takes every
    candidate hi * 8^j, j < n_iter, stacked on a new leading axis (the
    same elementwise arithmetic as one at a time, so the same bits), and
    hi grows by 8 for each leading candidate that is over."""
    # 8^j in integers (exact), made on the device: no host copy, no sync
    scale = torch.pow(8, torch.arange(n_iter, device=hi.device)).to(
        hi.dtype).reshape(-1, *([1] * hi.dim()))
    steps = over(hi * scale).to(torch.int64).cumprod(0).sum(0)
    return hi * torch.pow(8, steps).to(hi.dtype)


def _one_or_many(fn):
    """Let a batched solver take one group: ``(N,)`` constants, 0-dim
    ``w``, ``(N,)`` mask and per-slot arguments run as the batch at G = 1."""

    @functools.wraps(fn)
    def solve(c: RAConstants, mask, *args, **kwargs) -> RASolution:
        mask = torch.as_tensor(mask, device=c.a.device).bool()
        if mask.dim() == 2:
            return fn(c, mask, *args, **kwargs)
        sol = fn(c.rows(None), mask[None], *(x[None] for x in args),
                 **kwargs)
        return RASolution(*(x[0] for x in astuple(sol)))

    return solve


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


#: One group's or a batch's KKT-path solve; one group is the batch at G = 1
#: (the kernel on the card).
solve_fixed_point = _one_or_many(solve_fixed_point_batched)


# ---------------------------------------------------------------------------
# Solver 1 — Algorithm 2 (paper-faithful)
# ---------------------------------------------------------------------------

@_one_or_many
def solve_paper(c: RAConstants, mask, *, n_steps: int = 400) -> RASolution:
    """Algorithm 2: replace beta by eq. (19), solve (32) over f only, by
    Adam on an annealed log-sum-exp of the max term with f kept in its box
    by projection. The gradient of the batch's summed objective is each
    group's own gradient. Adam's bias corrections and the temperature
    decay are float32 as in the reference: 0.9^(k+1) and 0.999^(k+1) are
    the float32 bases raised in float64 and rounded, as XLA's float32
    ``pow`` gives them."""
    dev = c.a.device
    w = c.w[:, None]
    ninf = c.a.new_full((), -math.inf)

    def objective(f, temp):
        beta = beta_of_f(c, mask, f)
        safe_beta = ref.safe(beta, mask)
        s = _msum(c.a / safe_beta + c.b * torch.square(f), mask)
        per_max = torch.where(mask, c.d / safe_beta + c.e / f, ninf)
        m = temp * torch.logsumexp(per_max / temp, dim=-1, keepdim=True)
        return s + w * m

    f = torch.sqrt(c.f_min * c.f_max)
    scale = c.f_max - c.f_min
    decay = (1e-4 / 1e2) ** (1.0 / max(n_steps - 1, 1))
    powers = np.arange(1, n_steps + 1, dtype=np.float64)
    bias1, bias2 = (torch.tensor(
        1.0 - (float(np.float32(base)) ** powers).astype(np.float32),
        device=dev) for base in (0.9, 0.999))
    temp = torch.tensor(1e2, dtype=torch.float32, device=dev)
    m1 = torch.zeros_like(f)
    m2 = torch.zeros_like(f)
    with torch.enable_grad():
        for k in range(n_steps):
            fv = f.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(objective(fv, temp).sum(), fv)
            g = g * scale                       # precondition by box width
            m1 = 0.9 * m1 + 0.1 * g
            m2 = 0.999 * m2 + 0.001 * g * g
            m1h = m1 / bias1[k]
            m2h = m2 / bias2[k]
            f = f - 0.02 * scale * m1h / (torch.sqrt(m2h) + 1e-8)
            f = torch.clamp(f, c.f_min, c.f_max)
            temp = temp * decay
    f = f.detach()
    return _finalize(c, mask, f, beta_of_f(c, mask, f))


# ---------------------------------------------------------------------------
# Solver 3 — exact nested parametric solver
# ---------------------------------------------------------------------------

def _inner_beta_f(c: RAConstants, mask, t, nu, n_beta: int = 32):
    """For fixed deadline ``t`` and bandwidth price ``nu`` (each ``(G,
    1)``), per device minimize psi(beta) = a/beta + b f(beta)^2 + nu beta
    with f(beta) = clip(e / (t - d/beta), box), over beta in
    [beta_feas(t), 1], by a golden section per device."""
    slack_max = t - c.e / c.f_max
    b_lo = torch.where(slack_max > 0, c.d / torch.clamp_min(slack_max, EPS),
                       c.a.new_ones(()))
    b_lo = torch.clamp(b_lo, EPS, 1.0)
    b_hi = torch.ones_like(b_lo)

    def f_of_beta(beta):
        slack = t - c.d / torch.clamp_min(beta, EPS)
        f = torch.where(slack > 0, c.e / torch.clamp_min(slack, EPS),
                        c.f_max)
        return torch.clamp(f, c.f_min, c.f_max)

    def psi(beta):
        f = f_of_beta(beta)
        return c.a / torch.clamp_min(beta, EPS) + c.b * torch.square(f) \
            + nu * beta

    beta = _golden_min(psi, b_lo, b_hi, n_beta)
    return beta, f_of_beta(beta)


def _solve_fixed_t(c: RAConstants, mask, t, n_nu: int = 40):
    """Exact inner solve at fixed deadline ``t``: bisect the bandwidth
    price nu so that the active betas sum to 1 (the sum falls in nu)."""
    def over(nu):
        return _msum(_inner_beta_f(c, mask, t, nu)[0], mask) > 1.0

    one = torch.ones_like(t)
    hi = _grow(over, one, 12)
    simplex_binds = over(torch.zeros_like(t))
    lo, hi = _bisect(over, torch.zeros_like(t), hi, n_nu)
    nu = torch.where(simplex_binds, 0.5 * (lo + hi), torch.zeros_like(t))
    beta, f = _inner_beta_f(c, mask, t, nu)
    value = _msum(c.a / torch.clamp_min(beta, EPS) + c.b * torch.square(f),
                  mask)
    return beta, f, value


@_one_or_many
def solve_exact(c: RAConstants, mask, *, n_outer: int = 44) -> RASolution:
    """Golden section over t of J(t) = inner_value(t) + w t (convex)."""
    t_lo, t_hi = _deadline_bracket(c, mask)
    t_lo = t_lo * (1.0 + 1e-6)
    t_hi = torch.maximum(t_hi * 2.0, t_lo * 4.0)
    w = c.w[:, None]

    def j_of_t(t):
        return _solve_fixed_t(c, mask, t)[2] + w * t

    t_star = _golden_min(j_of_t, t_lo, t_hi, n_outer)
    beta, f, _ = _solve_fixed_t(c, mask, t_star)
    return _finalize(c, mask, f, beta)


# ---------------------------------------------------------------------------
# Solver 4 — projected subgradient reference (test oracle)
# ---------------------------------------------------------------------------

def _project_simplex_cap(beta, mask, lo: float = 1e-6):
    """Euclidean projection of each row onto {lo <= beta_n <= 1,
    sum_active beta <= 1}: bisection on a common shift."""
    zero = beta.new_zeros(())
    beta = torch.clamp(torch.where(mask, beta, zero), lo, 1.0)
    need = _msum(beta, torch.ones_like(mask)) > 1.0

    def over(s):
        return _msum(torch.clamp(beta - s, lo, 1.0), mask) > 1.0

    l, h = _bisect(over, torch.zeros_like(beta[..., :1]),
                   beta.amax(-1, keepdim=True), 50)
    shifted = torch.clamp(beta - 0.5 * (l + h), lo, 1.0)
    return torch.where(mask, torch.where(need, shifted, beta), zero)


@_one_or_many
def solve_reference(c: RAConstants, mask, *, n_steps: int = 4000,
                    seed: int = 0) -> RASolution:
    """Projected subgradient on (f, beta) jointly; keeps the best iterate.
    ``seed`` keeps the reference's signature; the method draws nothing."""
    def objective(f, beta):
        return _objective(c, mask, f, ref.safe(beta, mask))

    f = torch.sqrt(c.f_min * c.f_max)
    n_act = torch.clamp_min(mask.sum(-1, keepdim=True), 1).to(f.dtype)
    beta = _project_simplex_cap(
        torch.where(mask, f.new_ones(()), f.new_zeros(())) / n_act, mask)
    best_f, best_b, best_v = f, beta, objective(f, beta)
    box = c.f_max - c.f_min
    steps = np.arange(1, n_steps + 1, dtype=np.float32)
    lrs = torch.tensor(np.float32(1.0) / np.sqrt(steps), device=f.device)
    for k in range(n_steps):
        with torch.enable_grad():
            fv = f.detach().requires_grad_(True)
            bv = beta.detach().requires_grad_(True)
            gf, gb = torch.autograd.grad(objective(fv, bv).sum(), (fv, bv))
        lr = lrs[k]
        f = torch.clamp(f - lr * box * 0.1 * gf / (gf.abs() + 1e-20),
                        c.f_min, c.f_max)
        norm = torch.sqrt(_msum(gb * gb, mask))
        beta = _project_simplex_cap(beta - lr * 0.05 * gb / (norm + 1e-20),
                                    mask)
        v = objective(f, beta)
        better = v < best_v
        best_f = torch.where(better, f, best_f)
        best_b = torch.where(better, beta, best_b)
        best_v = torch.where(better, v, best_v)
    return _finalize(c, mask, best_f, best_b)


# ---------------------------------------------------------------------------
# Partial-optimization variants for the paper's §V.A benchmark schemes
# ---------------------------------------------------------------------------

@_one_or_many
def optimize_f_given_beta(c: RAConstants, mask, beta) -> RASolution:
    """"Computation optimization" scheme: optimal f under a fixed beta, by
    golden section on the deadline (at fixed t, f_n(t) = clip(e_n / (t -
    d_n/beta_n), box); U(t) = sum b f(t)^2 + w t is convex)."""
    safe_beta = ref.safe(beta, mask)
    floor = c.d / safe_beta
    t_lo = _mmax(floor + c.e / c.f_max, mask) * (1 + 1e-6)
    t_hi = _mmax(floor + c.e / c.f_min, mask) * 1.5 + 1.0
    w = c.w[:, None]

    def f_of_t(t):
        slack = t - floor
        f = torch.where(slack > 0, c.e / torch.clamp_min(slack, EPS),
                        c.f_max)
        return torch.clamp(f, c.f_min, c.f_max)

    def u_of_t(t):
        return _msum(c.b * torch.square(f_of_t(t)), mask) + w * t

    f = f_of_t(_golden_min(u_of_t, t_lo, t_hi, 48))
    return _fixed_solution(c, mask, torch.where(mask, f, c.f_min), f, beta,
                           safe_beta)


def _fixed_solution(c: RAConstants, mask, f_out, f, beta, safe_beta
                    ) -> RASolution:
    """The solution at a given (f, beta), costed as is (empty groups 0);
    ``f_out`` is the f reported."""
    cost = torch.where(mask.any(-1, keepdim=True),
                       _objective(c, mask, f, safe_beta), f.new_zeros(()))
    deadline = _mmax(c.d / safe_beta + c.e / f, mask)
    return RASolution(f=f_out, beta=torch.where(mask, beta, f.new_zeros(())),
                      cost=cost[:, 0], deadline=deadline[:, 0])


@_one_or_many
def optimize_beta_given_f(c: RAConstants, mask, f) -> RASolution:
    """"Communication optimization" scheme: optimal beta under a fixed f,
    by golden section over t with an inner water-filling beta_n(t, nu) =
    max(d_n / (t - e_n/f_n), sqrt(a_n / nu)) and bisection on nu for
    sum beta = 1."""
    e_over_f = c.e / torch.clamp(f, c.f_min, c.f_max)
    one = c.a.new_ones(())
    w = c.w[:, None]

    def betas(b_floor, nu):
        b_free = torch.sqrt(c.a / torch.clamp_min(nu, EPS))
        return torch.clamp(torch.maximum(b_floor, b_free), EPS, 1.0)

    def beta_of_t(t):
        """The water-filling betas at deadline t, nu bisected so that they
        sum to 1 (the floor, fixed by t, is computed once)."""
        b_floor = torch.where(t > e_over_f,
                              c.d / torch.clamp_min(t - e_over_f, EPS), one)

        def over(nu):
            return _msum(betas(b_floor, nu), mask) > 1

        hi = _grow(over, torch.ones_like(t), 14)
        lo, hi = _bisect(over, torch.zeros_like(t), hi, 44)
        return betas(b_floor, 0.5 * (lo + hi))

    def feasible(t):
        b = torch.where(t > e_over_f,
                        c.d / torch.clamp_min(t - e_over_f, EPS),
                        c.a.new_full((), 1e6))
        return _msum(b, mask) <= 1.0

    lo0 = _mmax(e_over_f + c.d, mask)
    hi0 = lo0 + _msum(c.d, mask) * 1e4 + 1.0
    _, t_lo = _bisect(lambda t: ~feasible(t), lo0, hi0, 60)
    t_hi = t_lo * 4.0 + 1.0

    def v_of_t(t):
        return _msum(c.a / beta_of_t(t), mask) + w * t

    t_star = _golden_min(v_of_t, t_lo * (1 + 1e-6), t_hi, 44)
    beta = _masked_beta_norm(beta_of_t(t_star), mask)
    return _finalize(c, mask, torch.clamp(f, c.f_min, c.f_max), beta)


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------

SOLVERS = {
    "paper": solve_paper,
    "fixed_point": solve_fixed_point,
    "exact": solve_exact,
    "reference": solve_reference,
}


def solve(c: RAConstants, mask, method: str = "exact") -> RASolution:
    """Solve problem (18). ``method`` in {paper, fixed_point, exact,
    reference}."""
    return SOLVERS[method](c, mask)
