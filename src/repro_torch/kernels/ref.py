"""Plain PyTorch versions of the port's kernels (the allclose targets).

``rmsnorm_ref`` is the plain version of ``csrc/rmsnorm.cu``, RMSNorm with
float32 statistics, its sum of squares taken in that kernel's order.
``flash_attention_ref`` is the plain version of ``csrc/flash_attention.cu``:
attention computed whole, in float32, with the Pallas kernel's top-left
causal mask; on request it also returns each row's logsumexp in the
kernel's log2 units. ``flash_attention_bwd_ref`` is the plain version of
``csrc/flash_attention_bwd.cu``: the gradients from the forward's saved
output and logsumexp, by the kernel's formulas.

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
LOG2E = 1.4426950408889634


# The golden-section kernel's dispatch table (csrc/golden_section.cu: kWarps,
# kRegSteps, kWideThreads, kMaxR and its GS_SOLVE instantiations; a CPU test
# checks that both agree). The threads of a group pack its active slots, the
# j-th in row order on thread j % L at step j // L. A group of at most
# 32 * max(GS_REG_STEPS) active slots is solved by one warp (L = 32,
# GS_WARPS groups a block), a wider one by a block of L = GS_WIDE_THREADS
# threads; a thread holding s steps runs the first instantiation of
# GS_REG_STEPS that holds s. block_sum follows the same choice, made from
# each row's active count alone.
GS_WARPS = 4
GS_REG_STEPS = (1, 2, 3, 4, 6, 8)
GS_WIDE_THREADS = 512
MAX_R = GS_WIDE_THREADS * max(GS_REG_STEPS)


def gs_lanes(n_active: torch.Tensor) -> torch.Tensor:
    """Threads (L) the kernel gives each group, from its active count."""
    return torch.where(n_active > 32 * max(GS_REG_STEPS), GS_WIDE_THREADS, 32)


def golden_section_paths(mask: torch.Tensor) -> dict[str, int]:
    """How many of the ``(G, R)`` mask's groups the kernel solves on each
    path: ``empty`` (no active slot, no arithmetic), ``warp`` and
    ``block``."""
    n = mask.sum(-1)
    wide = gs_lanes(n) > 32
    return {"empty": int((n == 0).sum()),
            "warp": int(((n > 0) & ~wide).sum()),
            "block": int(wide.sum())}


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root of a positive float32 tensor, taken in float64 and rounded
    to float32 (PyTorch has no ``cbrt``). The kernel takes the same route,
    so both round the same root to the same float."""
    return torch.pow(x.double(), 1.0 / 3.0).to(x.dtype)


def halving_tree(part: torch.Tensor) -> torch.Tensor:
    """Sum ``(M, W)`` over its last axis, W a power of two, as a warp's xor
    shuffles do: lane l adds lane l + w at width w = W/2, W/4, ..., 1.
    Returns ``(M, 1)``."""
    width = part.shape[-1]
    while width > 1:
        width //= 2
        part = part[:, :width] + part[:, width:]
    return part


def lane_sum(x: torch.Tensor, mask: torch.Tensor, lanes: int) -> torch.Tensor:
    """Sum of ``x`` over the active slots of each row of ``(G, R)`` as
    ``lanes`` threads sum it: the j-th active slot in row order goes to
    thread j % lanes at step j // lanes (a rank taken with ``cumsum`` and a
    scatter), each thread adds its steps in turn, each warp takes the
    halving tree of its 32 lanes, then the halving tree of the warp
    partials. Masked slots take no part, whatever ``x`` holds there.
    Returns ``(G, 1)``."""
    g, r = x.shape
    steps = -(-r // lanes)
    # active slot -> its rank; masked ones -> a spare column, dropped
    slot = torch.where(mask, mask.cumsum(-1) - 1, lanes * steps)
    packed = x.new_zeros(g, lanes * steps + 1).scatter_(
        1, slot, torch.where(mask, x, x.new_zeros(())))
    packed = packed[:, :-1].reshape(g, steps, lanes)
    part = packed[:, 0]
    for i in range(1, steps):
        part = part + packed[:, i]
    part = halving_tree(part.reshape(g * lanes // 32, 32))
    return halving_tree(part.reshape(g, lanes // 32))


def block_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over the active slots of each row of ``(G, R)``, in the
    golden-section kernel's order: :func:`lane_sum` over the threads
    :func:`gs_lanes` gives the row. Returns ``(G, 1)``."""
    out = lane_sum(x, mask, 32)
    if x.shape[1] > 32 * max(GS_REG_STEPS):    # a row may be wide
        wide = gs_lanes(mask.sum(-1, keepdim=True)) > 32
        out = torch.where(wide, lane_sum(x, mask, GS_WIDE_THREADS), out)
    return out


def thread_block_sum(x: torch.Tensor, threads: int) -> torch.Tensor:
    """Sum over the last axis of ``(G, C)`` as a block of ``threads``
    threads sums it in the aggregation kernel: thread t adds x[t],
    x[t + threads], ... in turn; each warp's halving tree; then one warp's
    halving tree over the warp partials (its lanes past the warp count hold
    exact zeros, so that is the halving tree of the partials). Returns
    ``(G, 1)``."""
    g, c = x.shape
    per = -(-c // threads)
    slots = torch.nn.functional.pad(x, (0, threads * per - c)).view(
        g, per, threads)
    part = slots[:, 0]
    for i in range(1, per):
        part = part + slots[:, i]
    part = halving_tree(part.reshape(g * threads // 32, 32))
    return halving_tree(part.reshape(g, threads // 32))


def beta_norm(score, mask):
    """Normalize positive scores to sum to 1 over the active set."""
    zero = score.new_zeros(())
    score = torch.where(mask, score, zero)
    tot = torch.clamp_min(block_sum(score, mask), EPS)
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
    d_sum = block_sum(d, mask)

    def bound_hi(fx):
        e_fx = e / fx
        lo = torch.where(mask, e_fx + d, zero).amax(-1, keepdim=True)
        hi = lo + d_sum * 1e4 + 1.0
        for _ in range(n_bracket):
            mid = 0.5 * (lo + hi)
            slack = mid - e_fx
            bb = torch.where(mask, d / torch.clamp_min(slack, EPS), zero)
            bb = torch.where(mask & (slack <= 0), bb.new_full((), 1e6), bb)
            ok = block_sum(bb, mask) <= 1.0
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
    return block_sum(per_sum, mask) + w * worst, worst


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
# thread_block_sum with these threads. The client axis is split over the
# blocks of a thread block cluster, at most AGG_MAX_SPLITS (the portable
# cluster size), enough for AGG_BLOCKS blocks (4 on each of the H100's 132
# SMs), each split at least AGG_MIN_ROWS rows: below that the cluster costs
# more than it gains (PERF.md, PR 16).
AGG_THREADS = 256
AGG_MAX_SPLITS = 8
AGG_BLOCKS = 4 * 132
AGG_MIN_ROWS = 40


def agg_splits(c: int, p: int) -> tuple[int, int]:
    """``(splits, rows)`` of the aggregation kernel for ``(C, P)``: the
    blocks that share a tile of columns and the rows each streams, split q
    taking rows ``[q * rows, min(C, (q + 1) * rows))``, none empty, and
    more than one split only where each gets ``AGG_MIN_ROWS`` rows. Tiles
    are counted at two columns a thread, whatever the vector width, so the
    rule rests on the shape alone."""
    tiles = -(-p // (2 * AGG_THREADS))
    want = max(1, min(AGG_MAX_SPLITS, c // AGG_MIN_ROWS,
                      -(-AGG_BLOCKS // tiles)))
    rows = -(-c // want)
    return -(-c // rows), rows


def hier_aggregate_ref(updates: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """Weighted mean over the leading client axis, eq. (8)/(14).

    ``updates`` (C, P), ``weights`` (C,); returns (P,) in ``updates``'
    dtype. The weights are normalised by ``max(sum, 1e-30)`` in float32,
    the sum taken in the kernel's order (:func:`thread_block_sum`). The
    products are accumulated in float32 in the kernel's order: the rows are
    cut into the splits of :func:`agg_splits`, each split sums its rows in
    turn from 0, then the split sums are added in split order. With
    ``-fmad=false`` the two agree bit for bit."""
    c, p = updates.shape
    w = weights.to(torch.float32)
    total = thread_block_sum(w[None], AGG_THREADS)[0, 0]
    w = w / torch.clamp_min(total, 1e-30)
    splits, rows = agg_splits(c, p)
    # pad to splits * rows rows of zero weight: adding their +0 products
    # leaves a sum unchanged
    pad = splits * rows - c
    u = torch.nn.functional.pad(updates.to(torch.float32), (0, 0, 0, pad))
    w = torch.nn.functional.pad(w, (0, pad))
    u, w = u.view(splits, rows, p), w.view(splits, rows, 1)
    acc = torch.zeros_like(u[:, 0])
    for i in range(rows):
        acc = acc + w[:, i] * u[:, i]
    out = acc[0]
    for q in range(1, splits):
        out = out + acc[q]
    return out.to(updates.dtype)


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
                        causal: bool = True, scale: float | None = None,
                        return_lse: bool = False):
    """Attention computed whole. q (B, Sq, Hq, hd); k, v (B, Skv, Hkv, hd)
    with Hq % Hkv == 0 (q head h reads kv head h // (Hq // Hkv)); scores
    scaled by ``scale`` (default hd ** -0.5); float32 throughout, output in
    q's dtype. The causal mask keeps kv_pos <= q_pos,
    aligned top-left as the Pallas kernel aligns it; the JAX reference
    aligns it bottom-right (``tril(k=skv - sq)``), which is the same only
    when Sq == Skv. With ``return_lse``, also each row's logsumexp of the
    scaled, masked scores in log2 units (float32 (B, Hq, Sq)), the
    kernel's residual for :func:`flash_attention_bwd_ref`."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qr = (q.reshape(b, sq, hkv, g, hd).to(torch.float32)
          * (hd ** -0.5 if scale is None else scale))
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.to(torch.float32))
    if causal:
        mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.to(torch.float32))
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd).to(q.dtype)
    if not return_lse:
        return o
    # logsumexp = m - ln(max P), P's largest entry being exp(m - lse): no
    # score-sized temporary beside s and p
    lse = s.amax(-1) - torch.log(p.amax(-1))
    return o, (lse * LOG2E).reshape(b, hq, sq)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, g: torch.Tensor, *,
                            causal: bool = True, scale: float | None = None,
                            magnitudes: bool = False, o_err: bool = False):
    """The gradients of attention (the function of
    :func:`flash_attention_ref`) for the output cotangent ``g``, from the
    forward's output ``o`` and logsumexp ``lse`` (float32 (B, Hq, Sq), log2
    units), as the kernel computes them, in float32: with c = ``scale``
    (default hd ** -0.5), P = 2^(c log2(e) q k^T - lse) (0 where the
    top-left causal mask hides kv_pos > q_pos), D = rowsum(g o), dS = P (g
    v^T - D), dq = c dS k, dk = c dS^T q, dv = P^T g. One batch element at
    a time, so the transient score-sized tensors are those of one
    sequence. Returns (dq, dk, dv) in the inputs' dtype.

    With ``magnitudes``, returns ((dq, dk, dv), A): A, float32, the
    magnitudes of the terms the bf16 kernel rounds, the scale of its
    tolerance (``chip_smoke.FLASH_BWD_TOL``): (c |dS| |k|, c |dS|^T |q|,
    P^T |g|) for (dq, dk, dv). With ``o_err`` too, the kernel read another
    forward's o, within that forward's tolerance 2u (|o| + P|v|) of this
    ``o`` (``chip_smoke.FLASH_TOL``): |dS| widens by P rowsum(|g| (|o| +
    P|v|)), u times which bounds how far D can move."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    grp = hq // hkv
    c = hd ** -0.5 if scale is None else scale
    f32 = torch.float32
    hide = (~torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril()
            if causal else None)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    mags = [torch.empty(t.shape, dtype=f32, device=q.device)
            for t in (q, k, v)] if magnitudes else None
    for i in range(b):
        qi, gi = (x[i].to(f32).reshape(sq, hkv, grp, hd) for x in (q, g))
        ki, vi = k[i].to(f32), v[i].to(f32)
        oi = o[i].to(f32).reshape(sq, hkv, grp, hd)
        d = (gi * oi).sum(-1)
        s = torch.einsum("qhgd,khd->hgqk", qi, ki)
        p = torch.exp2(s * (c * LOG2E)
                       - lse[i].reshape(hkv, grp, sq, 1))
        del s
        if causal:
            p.masked_fill_(hide, 0.0)
        dv[i] = torch.einsum("hgqk,qhgd->khd", p, gi).to(v.dtype)
        ds = torch.einsum("qhgd,khd->hgqk", gi, vi)
        ds.sub_(d.permute(1, 2, 0)[..., None]).mul_(p)
        if magnitudes:
            mags[2][i] = torch.einsum("hgqk,qhgd->khd", p, gi.abs())
            ds_abs = ds.abs()
            if o_err:
                pv_abs = torch.einsum("hgqk,khd->qhgd", p, vi.abs())
                d_abs = (gi.abs() * (oi.abs() + pv_abs)).sum(-1)
                ds_abs.add_(p * d_abs.permute(1, 2, 0)[..., None])
        del p
        dq[i] = (torch.einsum("hgqk,khd->qhgd", ds, ki) * c).reshape(
            sq, hq, hd).to(q.dtype)
        dk[i] = (torch.einsum("hgqk,qhgd->khd", ds, qi) * c).to(k.dtype)
        del ds
        if magnitudes:
            mags[0][i] = c * torch.einsum("hgqk,khd->qhgd", ds_abs,
                                          ki.abs()).reshape(sq, hq, hd)
            mags[1][i] = c * torch.einsum("hgqk,qhgd->khd", ds_abs,
                                          qi.abs())
            del ds_abs
    return ((dq, dk, dv), tuple(mags)) if magnitudes else (dq, dk, dv)


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
