"""Plain PyTorch versions of the port's kernels (the allclose targets).

``rmsnorm_ref`` is the plain version of ``csrc/rmsnorm.cu``, RMSNorm with
float32 statistics, its sum of squares taken in that kernel's order.
``flash_attention_ref`` is the plain version of ``csrc/flash_attention.cu``:
attention computed whole, in float32, with the Pallas kernel's top-left
causal mask.

``hier_aggregate_ref`` is the plain version of ``csrc/hier_aggregate.cu``,
the eq. (8)/(14) weighted mean, summed in that kernel's order.

``ssd_state_scan_ref`` is the plain version of ``csrc/ssd_scan.cu``, the
Mamba2 inter-chunk state recurrence with a float32 carry.

``golden_section_ref`` is the plain version of the CUDA kernel in
``csrc/golden_section.cu`` and the counterpart of
``repro.kernels.ref.golden_section_ref``: the KKT-path solve of problem (18)
batched over ``(G, R)`` candidate groups, op for op in the reference's
order, with its sums taken in the kernel's reduction order and its cube
root rounded as the kernel rounds it, so that the two agree bit for bit on
the card. The CPU tests hold it against the JAX solver; ``chip_smoke.py``
holds the kernel against it on the card. The helpers below are shared with
:mod:`repro_torch.core.resource_allocation`, so the solver's arithmetic has
one source.
"""

from __future__ import annotations

import torch

GOLDEN = 0.6180339887498949
EPS = 1e-12


# Thread layout of the CUDA kernel: a group of width R runs on NT threads
# holding IT slots each (slot r = thread + i * NT), the first (R limit, NT,
# IT) row that fits. The wrapper passes it to the kernel; block_sum follows
# it. csrc/golden_section.cu instantiates exactly these (NT, IT) pairs.
KERNEL_LAYOUTS = ((64, 64, 1), (256, 256, 1), (512, 256, 2), (1024, 256, 4),
                  (2048, 512, 4), (4096, 512, 8))
MAX_R = KERNEL_LAYOUTS[-1][0]


def kernel_layout(r: int) -> tuple[int, int]:
    """(NT, IT) the kernel uses for groups of width ``r``."""
    for limit, nt, it in KERNEL_LAYOUTS:
        if r <= limit:
            return nt, it
    raise ValueError(f"group width {r} exceeds the kernel's {MAX_R}")


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root of a positive float32 tensor, taken in float64 and rounded
    to float32 (PyTorch has no ``cbrt``). The kernel takes the same route,
    so both round the same root to the same float."""
    return torch.pow(x.double(), 1.0 / 3.0).to(x.dtype)


def block_sum(x: torch.Tensor,
              layout: tuple[int, int] | None = None) -> torch.Tensor:
    """Sum over the last axis of ``(G, R)`` in a kernel's order, so the
    plain version and the kernel round alike. ``layout`` is the kernel's
    (threads, slots per thread), slot r on thread r % threads; by default
    the golden-section kernel's :func:`kernel_layout`. Each thread adds its
    slots in turn; each warp's xor-shuffle reduction leaves lane 0 the
    halving tree of its 32 lanes (lane l adds lane l + w at width w); one
    warp then reduces the warp partials the same way (its lanes past the
    warp count hold exact zeros, so that is the halving tree of the
    partials). Returns ``(G, 1)``."""
    g, r = x.shape
    nt, it = layout or kernel_layout(r)
    slots = torch.nn.functional.pad(x, (0, nt * it - r)).view(g, it, nt)
    part = slots[:, 0]
    for i in range(1, it):
        part = part + slots[:, i]
    for rows, width in ((g * nt // 32, 32), (g, nt // 32)):
        part = part.reshape(rows, width)
        while width > 1:
            width //= 2
            part = part[:, :width] + part[:, width:]
    return part


def beta_norm(score, mask):
    """Normalize positive scores to sum to 1 over the active set."""
    zero = score.new_zeros(())
    score = torch.where(mask, score, zero)
    tot = torch.clamp_min(block_sum(score), EPS)
    return torch.where(mask, score / tot, zero)


def beta_of_f(a, b, d, e, mask, f):
    """Eq. (19): beta_n proportional to cbrt(a_n + (2 b_n f_n^3 / e_n) d_n)."""
    tau = 2.0 * b * (f * f * f) / torch.clamp_min(e, EPS)
    return beta_norm(cbrt(torch.clamp_min(a + tau * d, EPS)), mask)


def safe(beta, mask):
    return torch.where(mask, torch.clamp_min(beta, EPS), beta.new_ones(()))


def deadline_bracket(d, e, mask, f_min, f_max, n_bracket: int):
    """Feasible deadline bounds ``(G, 1)``: the smallest t with
    sum_n d_n / (t - e_n / f_x) <= 1, bisected with every device at f_max
    (lower bound) and at f_min (upper bound)."""
    zero = d.new_zeros(())
    d_sum = block_sum(torch.where(mask, d, zero))

    def bound_hi(fx):
        e_fx = e / fx
        lo = torch.where(mask, e_fx + d, zero).amax(-1, keepdim=True)
        hi = lo + d_sum * 1e4 + 1.0
        for _ in range(n_bracket):
            mid = 0.5 * (lo + hi)
            slack = mid - e_fx
            bb = torch.where(mask, d / torch.clamp_min(slack, EPS), zero)
            bb = torch.where(mask & (slack <= 0), bb.new_full((), 1e6), bb)
            ok = block_sum(bb) <= 1.0
            lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
        return hi

    return bound_hi(f_max), bound_hi(f_min)


def objective(a, b, d, e, w, mask, f, safe_beta):
    """Problem (18) per group, ``w`` shaped ``(G, 1)``; returns ``(G, 1)``
    costs and the ``(G, 1)`` deadline max_n d/beta + e/f."""
    zero = a.new_zeros(())
    per_sum = a / safe_beta + b * torch.square(f)
    per_max = d / safe_beta + e / f
    worst = torch.where(mask, per_max, zero).amax(-1, keepdim=True)
    return block_sum(torch.where(mask, per_sum, zero)) + w * worst, worst


def finalize(a, b, d, e, w, mask, f_min, f_max, f, beta):
    """Clip/renormalize a solution; empty groups cost 0. ``w`` is (G, 1)."""
    any_active = mask.any(-1, keepdim=True)
    f = torch.where(mask, torch.clamp(f, f_min, f_max), f_min)
    beta = beta_norm(torch.clamp_min(beta, EPS), mask)
    cost, deadline = objective(a, b, d, e, w, mask, f, safe(beta, mask))
    cost = torch.where(any_active, cost, cost.new_zeros(()))
    return f, beta, cost[:, 0], deadline[:, 0]


def golden_section_ref(a, b, d, e, w, f_min, f_max, mask, *,
                       n_golden: int = 48, n_inner: int = 12,
                       n_bracket: int = 60):
    """Batched KKT-path RA solve. Constants ``(G, R)``, ``w`` ``(G,)``;
    returns ``(f (G, R), beta (G, R), cost (G,), deadline (G,))``."""
    mask = mask.bool()
    w = w[:, None]
    hi_max, hi_min = deadline_bracket(d, e, mask, f_min, f_max, n_bracket)
    t_lo = hi_max * (1.0 + 1e-6)
    t_hi = torch.maximum(hi_min * 1.5, t_lo * 4.0) + 1.0
    f0 = torch.sqrt(f_min * f_max)

    def fb_of_t(t):
        f = f0
        for _ in range(n_inner):
            beta = beta_of_f(a, b, d, e, mask, f)
            slack = t - d / safe(beta, mask)
            f_new = torch.where(slack > 0, e / torch.clamp_min(slack, EPS),
                                f_max)
            f = torch.clamp(f_new, f_min, f_max)
        return f, beta_of_f(a, b, d, e, mask, f)

    def cost_of_t(t):
        f, beta = fb_of_t(t)
        return objective(a, b, d, e, w, mask, f, safe(beta, mask))[0]

    # golden section over t, single-eval recurrence (G^2 = 1 - G)
    lo, hi = t_lo, t_hi
    m1 = hi - GOLDEN * (hi - lo)
    m2 = lo + GOLDEN * (hi - lo)
    c1, c2 = cost_of_t(m1), cost_of_t(m2)
    for _ in range(n_golden):
        go_right = c1 > c2
        lo = torch.where(go_right, m1, lo)
        hi = torch.where(go_right, hi, m2)
        m1n = hi - GOLDEN * (hi - lo)
        m2n = lo + GOLDEN * (hi - lo)
        point = torch.where(go_right, m2n, m1n)
        cp = cost_of_t(point)
        m1, m2, c1, c2 = (torch.where(go_right, m2, point),
                          torch.where(go_right, point, m1),
                          torch.where(go_right, c2, cp),
                          torch.where(go_right, cp, c1))
    f, beta = fb_of_t(0.5 * (lo + hi))
    return finalize(a, b, d, e, w, mask, f_min, f_max, f, beta)


# Threads per block of csrc/hier_aggregate.cu; its weight sum follows
# block_sum with the layout (AGG_THREADS, ceil(C / AGG_THREADS)).
AGG_THREADS = 256


def hier_aggregate_ref(updates: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """Weighted mean over the leading client axis, eq. (8)/(14).

    ``updates`` (C, P), ``weights`` (C,); returns (P,) in ``updates``'
    dtype. The weights are normalised by ``max(sum, 1e-30)`` in float32,
    the sum taken in the kernel's reduction order, and the products are
    accumulated in float32 row by row, c = 0 to C - 1, as each kernel thread
    does: with ``-fmad=false`` the two agree bit for bit."""
    c = updates.shape[0]
    w = weights.to(torch.float32)
    total = block_sum(w[None], (AGG_THREADS, -(-c // AGG_THREADS)))[0, 0]
    w = w / torch.clamp_min(total, 1e-30)
    u = updates.to(torch.float32)
    acc = torch.zeros_like(u[0])
    for i in range(c):
        acc = acc + w[i] * u[i]
    return acc.to(updates.dtype)


# Warps (rows) per block of csrc/rmsnorm.cu; one warp normalises one row,
# so the plain version's order follows the lanes of one warp, whatever the
# rows per block.
RMSNORM_WARPS = 8


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
                vec: int = 1) -> torch.Tensor:
    """RMSNorm over the last axis: ``x * rsqrt(mean(x^2) + eps) * scale``
    with float32 statistics, returned in ``x``'s dtype (the function of
    ``repro.kernels.ref.rmsnorm_ref``). The sum of squares follows the
    kernel's order for vector width ``vec``: lane l of the row's warp adds
    the squares of the vectors l, l + 32, ... element by element, then the
    halving tree of the 32 lane sums; the mean is a true division and the
    reciprocal square root ``1 / sqrt``. With ``-fmad=false`` the kernel
    agrees bit for bit."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).to(torch.float32)
    nv = d // vec
    k = -(-nv // 32)
    sq = torch.nn.functional.pad((xf * xf).view(-1, nv, vec),
                                 (0, 0, 0, 32 * k - nv))
    sq = sq.view(-1, k, 32, vec)
    acc = torch.zeros_like(sq[:, 0, :, 0])
    for i in range(k):
        for j in range(vec):
            acc = acc + sq[:, i, :, j]
    width = 32
    while width > 1:
        width //= 2
        acc = acc[:, :width] + acc[:, width:]
    # divide by a tensor: PyTorch's CUDA division by a scalar multiplies by
    # its reciprocal, which rounds otherwise than the kernel's division
    inv = torch.reciprocal(torch.sqrt(acc / torch.full_like(acc, d) + eps))
    y = xf * inv * scale.to(torch.float32)
    return y.to(x.dtype).reshape(x.shape)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """Attention computed whole. q (B, Sq, Hq, hd); k, v (B, Skv, Hkv, hd)
    with Hq % Hkv == 0 (q head h reads kv head h // (Hq // Hkv)); scores
    scaled by hd ** -0.5; float32 throughout, output in q's dtype. The causal mask keeps kv_pos <= q_pos,
    aligned top-left as the Pallas kernel aligns it; the JAX reference
    aligns it bottom-right (``tril(k=skv - sq)``), which is the same only
    when Sq == Skv."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qr = q.reshape(b, sq, hkv, g, hd).to(torch.float32) * hd ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.to(torch.float32))
    if causal:
        mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.to(torch.float32))
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd).to(q.dtype)


def ssd_state_scan_ref(states: torch.Tensor, decay: torch.Tensor,
                       initial_state: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inter-chunk SSD recurrence ``S_{c+1} = decay_c * S_c + states_c``.

    ``states`` (NC, B, H, N, P) per-chunk states, ``decay`` (NC, B, H) each
    chunk's total decay, ``initial_state`` (B, H, N, P) or None (zeros).
    Returns (entering (NC, B, H, N, P), final (B, H, N, P)), both in
    ``states``' dtype; ``entering[c]`` is the carry at the START of chunk c
    (the function of ``repro.kernels.ref.ssd_state_scan_ref``). The carry
    is float32, and each step rounds ``carry * decay`` and then the sum, as
    the kernel does with ``-fmad=false``: the two agree bit for bit."""
    nc, b, h, n, p = states.shape
    f32 = torch.float32
    carry = (torch.zeros((b, h, n, p), dtype=f32, device=states.device)
             if initial_state is None else initial_state.to(f32))
    dec = decay.to(f32)[..., None, None]
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = carry * dec[c] + states[c].to(f32)
    return (torch.stack(entering).to(states.dtype), carry.to(states.dtype))
