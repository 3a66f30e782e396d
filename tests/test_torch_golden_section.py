"""Port parity: the golden-section RA solve.

The plain PyTorch version (``repro_torch.kernels.ref.golden_section_ref``)
and ``repro_torch.core.resource_allocation.solve_fixed_point_batched`` on
CPU tensors are held against two oracles at every ``SCREEN_PROFILES``
entry: the jitted JAX solver (``backend="xla"``) and the JAX package's
Pallas kernel, which runs in interpret mode off the TPU.

Tolerance: the pin of ``tests/test_assoc_sharded.py`` — cost, deadline and
f at rtol 2e-4, beta at rtol 2e-4 / atol 1e-7. The golden section's
``c1 > c2`` branch can flip when a change of op order changes the rounding
on a flat objective, moving f while the cost stays put. A group outside
the pin is accepted only if both solutions are feasible and their costs
agree to 2e-2, and only one such group per fixture.

The CUDA kernel itself is held against the plain version on the card by
the ``gpu`` test at the end (and by ``chip_smoke.py``). A machine with a
card may have no JAX: there the oracle tests skip and the ``gpu`` test
runs alone, on groups built from the port's own ``make_scenario``, e.g.
``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_golden_section.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import cost_model as tcm
from repro_torch.core import resource_allocation as tra
from repro_torch.core import scenario as tsc
from repro_torch.kernels import golden_section as tgs
from repro_torch.kernels import ref as tref

try:                     # the oracle; absent on a machine with only torch
    import jax.numpy as jnp

    from repro.core import cost_model as jcm
    from repro.core import resource_allocation as jra
    from repro.core import scenario as jsc
    from repro.kernels import ops as jops
except ImportError:
    jnp = jcm = jra = jsc = jops = None

torch.set_num_threads(2)

NAMES = ("a", "b", "d", "e", "w", "f_min", "f_max")
# (G, R, seed): ragged widths; group 0 is a singleton, group 1 is empty
FIXTURES = [(8, 16, 1), (6, 37, 2), (9, 23, 4)]
PROFILES = sorted(tra.SCREEN_PROFILES)


def need_jax():
    if jnp is None:
        pytest.skip("needs JAX, the oracle")


def make_groups(g, r, seed):
    """(G, R) constants built from one server of a ``make_scenario`` (the
    JAX package's where JAX is installed, else the port's), jittered per
    group with numpy (one factor per group keeps the f box ordered), and a
    random membership mask."""
    if jsc is not None:
        sc = jsc.make_scenario(r, 2, seed=seed)
        c = jcm.ra_constants(sc.dev, sc.srv.bandwidth[0], sc.srv.noise[0],
                             sc.lp)
    else:
        sc = tsc.make_scenario(r, 2, seed=seed, device="cpu")
        c = tcm.ra_constants(sc.dev, sc.srv.bandwidth[0], sc.srv.noise[0],
                             sc.lp)
    rng = np.random.default_rng(seed + 13)
    scale = rng.uniform(0.7, 1.3, (g, 1)).astype(np.float32)
    fields = {k: (np.asarray(getattr(c, k))[None, :] * scale
                  ).astype(np.float32) for k in NAMES if k != "w"}
    fields["w"] = np.full(g, np.asarray(c.w), np.float32)
    mask = rng.uniform(size=(g, r)) < 0.7
    mask[0] = np.arange(r) == 0
    mask[1] = False
    return fields, mask


def check_pin(got, want, fields, mask):
    """Assert the pin on every group but at most one flipped group, which
    must be feasible on both sides with costs within 2e-2."""
    gf, gb, gc, gd = (np.asarray(x, np.float64) for x in got)
    wf, wb, wc, wd = (np.asarray(x, np.float64) for x in want)
    out = (~np.isclose(gc, wc, rtol=2e-4, atol=0)
           | ~np.isclose(gd, wd, rtol=2e-4, atol=0)
           | ~np.isclose(gf, wf, rtol=2e-4, atol=0).all(1)
           | ~np.isclose(gb, wb, rtol=2e-4, atol=1e-7).all(1))
    flipped = np.flatnonzero(out)
    assert flipped.size <= 1, f"groups {flipped} outside the pin"
    keep = ~out
    np.testing.assert_allclose(gc[keep], wc[keep], rtol=2e-4)
    np.testing.assert_allclose(gd[keep], wd[keep], rtol=2e-4)
    np.testing.assert_allclose(gf[keep], wf[keep], rtol=2e-4)
    np.testing.assert_allclose(gb[keep], wb[keep], rtol=2e-4, atol=1e-7)
    lo, hi = fields["f_min"], fields["f_max"]
    for g in flipped:
        m = mask[g]
        for f, beta in ((gf[g], gb[g]), (wf[g], wb[g])):
            assert beta[m].sum() <= 1 + 1e-5
            assert (f[m] >= lo[g][m] * (1 - 1e-6)).all()
            assert (f[m] <= hi[g][m] * (1 + 1e-6)).all()
        assert abs(gc[g] - wc[g]) <= 2e-2 * abs(wc[g])
    return flipped.size


def port_inputs(fields, mask, device="cpu"):
    return ([torch.tensor(fields[k], device=device) for k in NAMES]
            + [torch.tensor(mask, device=device)])


def xla_oracle(fields, mask, iters):
    c = jcm.RAConstants(**{k: jnp.asarray(v) for k, v in fields.items()})
    sol = jra.solve_fixed_point_batched(c, jnp.asarray(mask), backend="xla",
                                        **iters)
    return sol.f, sol.beta, sol.cost, sol.deadline


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("fixture", FIXTURES)
def test_plain_version_matches_jax_oracles(fixture, profile):
    need_jax()
    iters = jra.SCREEN_PROFILES[profile]
    fields, mask = make_groups(*fixture)
    plain = tref.golden_section_ref(*port_inputs(fields, mask), **iters)
    assert plain[2][1].item() == 0.0 and plain[3][1].item() == 0.0
    assert torch.equal(plain[0][1], torch.tensor(fields["f_min"][1]))
    check_pin([x.numpy() for x in plain], xla_oracle(fields, mask, iters),
              fields, mask)
    pallas = jops.golden_section_solve(
        *(jnp.asarray(fields[k]) for k in NAMES), jnp.asarray(mask), **iters)
    check_pin([x.numpy() for x in plain], pallas, fields, mask)


@pytest.mark.parametrize("profile", PROFILES)
def test_solve_fixed_point_batched_matches_xla(profile):
    """The port's batched solver (the kernel's dispatch, plain on the CPU)
    against the jitted JAX solver; its single-group solver is the same
    arithmetic at G = 1."""
    need_jax()
    assert tra.SCREEN_PROFILES == jra.SCREEN_PROFILES
    iters = jra.SCREEN_PROFILES[profile]
    fields, mask = make_groups(7, 29, 6)
    c = convert.ra_constants_from_numpy(fields, device="cpu")
    before = tgs.LAUNCHES
    sol = tra.solve_fixed_point_batched(c, torch.tensor(mask), **iters)
    assert tgs.LAUNCHES == before     # the plain version launches nothing
    want = xla_oracle(fields, mask, iters)
    check_pin([sol.f, sol.beta, sol.cost, sol.deadline], want, fields, mask)
    for g in (0, 3):
        one = tra.solve_fixed_point(c.rows(g), torch.tensor(mask[g]), **iters)
        assert torch.equal(one.cost, sol.cost[g])
        assert torch.equal(one.f, sol.f[g])


def test_finalize_and_beta_of_f_match_jax():
    need_jax()
    fields, mask = make_groups(5, 11, 7)
    rng = np.random.default_rng(3)
    f = rng.uniform(1e9, 1e10, (5, 11)).astype(np.float32)
    beta = rng.uniform(0.0, 0.3, (5, 11)).astype(np.float32)
    c = convert.ra_constants_from_numpy(fields, device="cpu")
    got = tra._finalize(c, torch.tensor(mask), torch.tensor(f),
                        torch.tensor(beta))
    got_b = tra.beta_of_f(c, torch.tensor(mask), torch.tensor(f))
    for g in range(5):
        cj = jcm.RAConstants(**{k: jnp.asarray(v[g]) for k, v in
                                fields.items()})
        want = jra._finalize(cj, jnp.asarray(mask[g]), jnp.asarray(f[g]),
                             jnp.asarray(beta[g]))
        np.testing.assert_allclose(got.f[g], want.f, rtol=1e-6)
        np.testing.assert_allclose(got.beta[g], want.beta, rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(got.cost[g], want.cost, rtol=1e-6)
        np.testing.assert_allclose(got.deadline[g], want.deadline, rtol=1e-6)
        np.testing.assert_allclose(
            got_b[g], jra.beta_of_f(cj, jnp.asarray(mask[g]),
                                    jnp.asarray(f[g])), rtol=1e-6, atol=1e-9)


def test_wrapper_checks_its_inputs():
    fields, mask = make_groups(3, 5, 8)
    ins = port_inputs(fields, mask)
    with pytest.raises(ValueError):
        tgs.golden_section_solve(*ins[:4], ins[4][:2], *ins[5:])
    with pytest.raises(TypeError):
        tgs.golden_section_solve(ins[0].double(), *ins[1:])
    with pytest.raises(TypeError):
        tgs.golden_section_solve(*ins[:7], ins[7].float())
    with pytest.raises(ValueError):
        tgs.golden_section_solve(*(x[:, :4] if x.dim() == 2 and i == 2
                                   else x for i, x in enumerate(ins)))


def test_kernel_instantiates_every_layout():
    """The CUDA source's dispatch table (groups per block, steps per lane
    a thread holds, threads of a wide group, widest group) and its
    instantiations per steps a thread are the ones ``ref``
    reads, and the wrapper's width limit is the kernel's."""
    src = (Path(tref.__file__).parent / "csrc" / "golden_section.cu"
           ).read_text()
    table = {name: int(v) for name, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert table == {"kWarps": tref.GS_WARPS,
                     "kRegSteps": max(tref.GS_REG_STEPS),
                     "kWideThreads": tref.GS_WIDE_THREADS,
                     "kMaxR": tref.MAX_R}
    assert tref.MAX_R == tref.GS_WIDE_THREADS * max(tref.GS_REG_STEPS)
    found = re.findall(r"if \(steps <= (\d+)\) GS_SOLVE\((\d+)\);", src)
    last = re.search(r"else GS_SOLVE\((\d+)\);", src)
    steps = [int(b) for a, b in found] + [int(last.group(1))]
    assert all(a == b for a, b in found)
    assert tuple(steps) == tref.GS_REG_STEPS
    assert list(steps) == sorted(set(steps))
    assert tgs.MAX_R == tref.MAX_R


def emulate_lanes(x, mask):
    """The kernel's sum of one row, thread by thread in float32: L = 32
    threads (one warp) for up to 256 active slots, else 512; the j-th
    active slot in row order is added to thread j % L's sum at its step
    j // L; then each warp's lane l adds lane l + w at w = 16, 8, 4, 2, 1,
    and the same over the warp partials."""
    vals = x[mask]
    lanes = 32 if vals.size <= 256 else 512
    sums = [np.float32(0)] * lanes
    for j, v in enumerate(vals):
        sums[j % lanes] = np.float32(sums[j % lanes] + v)

    def tree(part):
        while len(part) > 1:
            h = len(part) // 2
            part = [np.float32(part[i] + part[i + h]) for i in range(h)]
        return part[0]

    return tree([tree(sums[k:k + 32]) for k in range(0, lanes, 32)])


@pytest.mark.parametrize("active", [0, 1, 31, 32, 33, 130, 256, 257, 300,
                                    1000])
def test_block_sum_follows_the_kernels_lanes(active):
    """``block_sum`` against a scalar emulation of the kernel's threads,
    bit for bit, on rows of 1000 slots with the given number active (up to
    256 one warp, above that a block of 512; 1000 is a fully active row);
    what masked slots hold does not matter."""
    rng = np.random.default_rng(active)
    x = rng.lognormal(0.0, 3.0, size=(3, 1000)).astype(np.float32)
    mask = np.zeros((3, 1000), dtype=bool)
    for row in range(3):
        mask[row, rng.choice(1000, active, replace=False)] = True
    if active > 256:                 # one narrow row beside the wide ones
        mask[2, :] = False
        mask[2, :40] = True
    got = tref.block_sum(torch.tensor(x), torch.tensor(mask))
    assert got.shape == (3, 1)
    want = [emulate_lanes(x[row], mask[row]) for row in range(3)]
    assert got[:, 0].numpy().tobytes() == np.asarray(want, np.float32
                                                     ).tobytes()
    x[~mask] = np.nan
    assert torch.equal(tref.block_sum(torch.tensor(x), torch.tensor(mask)),
                       got)


def test_paths_follow_the_active_count():
    wide = 32 * max(tref.GS_REG_STEPS)
    mask = torch.zeros(4, tref.MAX_R, dtype=torch.bool)
    mask[1, :1] = True
    mask[2, :wide] = True
    mask[3, :wide + 1] = True
    assert tref.golden_section_paths(mask) == {
        "empty": 1, "warp": 2, "block": 1}
    assert tref.gs_lanes(mask.sum(-1)).tolist() == [32, 32, 32,
                                                     tref.GS_WIDE_THREADS]


def main_path_inputs(n, device):
    """The main path's first batch at width ``n``: the group of server 0 at
    the nearest start of ``make_scenario(n, 20)``, and its n toggles."""
    from repro_torch.core.edge_association import (GroupSolver,
                                                   initial_assignment)
    sc = tsc.make_scenario(n, 20, seed=0, device=device)
    start = initial_assignment(sc, sc.eff_avail, np.random.default_rng(0))
    base = torch.as_tensor(start == 0, device=device)[None]
    masks = torch.cat([base, base ^ torch.eye(n, dtype=torch.bool,
                                              device=device)])
    c = GroupSolver(sc, device=device).consts.rows(
        torch.zeros(n + 1, dtype=torch.int64, device=device))
    return [x.contiguous() for x in (c.a, c.b, c.d, c.e, c.w, c.f_min,
                                     c.f_max)] + [masks]


@pytest.mark.gpu
@pytest.mark.parametrize("profile", PROFILES)
def test_kernel_matches_plain_version_on_card(profile):
    """The CUDA kernel against the plain version on the same card tensors
    (same pin and flip rule), plus a launch count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    iters = tra.SCREEN_PROFILES[profile]
    for fixture in FIXTURES:
        fields, mask = make_groups(*fixture)
        ins = port_inputs(fields, mask, device="cuda")
        before = tgs.LAUNCHES
        got = tgs.golden_section_solve(*ins, **iters)
        torch.cuda.synchronize()
        assert tgs.LAUNCHES == before + 1
        want = tref.golden_section_ref(*ins, **iters)
        check_pin([x.cpu().numpy() for x in got],
                  [x.cpu().numpy() for x in want], fields, mask)
    with pytest.raises(ValueError):
        tgs.golden_section_solve(
            *(torch.ones(1, tgs.MAX_R + 1, device="cuda")
              for _ in range(4)), torch.ones(1, device="cuda"),
            *(torch.ones(1, tgs.MAX_R + 1, device="cuda") for _ in range(2)),
            torch.ones(1, tgs.MAX_R + 1, dtype=torch.bool, device="cuda"))


@pytest.mark.gpu
def test_kernel_is_bitwise_the_plain_version_on_card():
    """At the main path's (1001, 1000) batch (``base ^ eye`` masks) and at
    a fully active (8, 1000) batch, which runs a block per group: every
    output of every group bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    iters = tra.SCREEN_PROFILES["default"]
    main = main_path_inputs(1000, "cuda")
    full = [x[:8] for x in main[:7]] + [torch.ones(8, 1000, dtype=torch.bool,
                                                   device="cuda")]
    assert tref.golden_section_paths(full[7])["block"] == 8
    for ins in (main, full):
        got = tgs.golden_section_solve(*ins, **iters)
        torch.cuda.synchronize()
        want = tref.golden_section_ref(*ins, **iters)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
