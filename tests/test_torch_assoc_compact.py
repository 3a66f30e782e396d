"""Port parity: the compacted sweep spaces. The port's flat, bucketed and
``"auto"`` engines against the JAX engine in the same space, on the
fixtures of ``tests/test_assoc_compact.py`` (sparse and dense reach),
pareto permission, sampled exchanges, the scheme kinds, binding caps and
the bucketed promotion of ``make_large_scenario(120, 8)``: the same
assignment and move count, costs at the solver pin (rtol 2e-4). Within the
port, the ``fast`` kind lands on the same bits in the dense, flat and
bucketed spaces (the kernel's plain version sums a group's active slots in
slot order, which is device order in every space); the other kinds are
held to the same stable point with costs at 2e-4, as the JAX test holds
them. Also: an out-of-reach assignment is rejected, toggle caches equal
fresh solves, a group wider than the kernel takes raises, and the packed
solve of ``GroupSolver.solve_batch`` equals the full-width one bit for
bit."""

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

from repro.core import assoc_fast as jaf
from repro.core import scenario as jsc
from repro_torch.core import assoc_fast as taf
from repro_torch.core import edge_association as tea
from repro_torch.core import scenario as tsc
from repro_torch.kernels import golden_section as tgs

from test_torch_assoc_fast import port_scenario
from test_torch_ra_solvers import PAPER_RTOL

torch.set_num_threads(2)

RTOL = 2e-4


def both(js, *, run=None, **opts):
    """The JAX and the port engine on ``js`` with ``opts`` (at the coarse
    profile unless ``opts`` says otherwise, to keep the plain solves
    short), each run with ``run`` (default: nearest start, transfers
    only)."""
    run = dict(init="nearest", exchange_samples=0) if run is None else run
    opts.setdefault("profile", "coarse")
    jeng = jaf.FastAssociationEngine(js, **opts)
    teng = taf.FastAssociationEngine(port_scenario(js), device="cpu", **opts)
    return jeng, jeng.run(**run), teng, teng.run(**run)


def assert_same_point(want, got):
    assert np.array_equal(want.assignment, got.assignment)
    assert want.n_adjustments == got.n_adjustments
    assert got.total_cost == pytest.approx(want.total_cost, rel=RTOL)
    assert got.true_cost == pytest.approx(want.true_cost, rel=RTOL)


# name -> (JAX scenario, engine options, run options)
CASES = {
    "sparse_flat": (lambda: jsc.make_scenario(16, 4, seed=2, reach_m=300.0),
                    dict(compact=True), None),
    "sparse_bucketed": (lambda: jsc.make_scenario(18, 4, seed=1,
                                                  reach_m=300.0),
                        dict(compact="bucketed"), None),
    "sparse_auto": (lambda: jsc.make_scenario(16, 4, seed=1, reach_m=300.0),
                    dict(), None),
    "dense_flat": (lambda: jsc.make_scenario(14, 3, seed=0),
                   dict(compact=True), None),
    "pareto_flat": (lambda: jsc.make_scenario(12, 3, seed=7, reach_m=300.0),
                    dict(compact=True, permission="pareto"), None),
    "exchanges_flat": (lambda: jsc.make_scenario(16, 4, seed=1,
                                                 reach_m=300.0),
                       dict(compact=True),
                       dict(init="nearest", exchange_samples=64)),
    "exchanges_bucketed": (lambda: jsc.make_scenario(16, 4, seed=1,
                                                     reach_m=300.0),
                           dict(compact="bucketed", seed=3),
                           dict(init="random", exchange_samples=64)),
    "binding_caps_flat": (lambda: jsc.make_large_scenario(20, 4, seed=2,
                                                          cap_slack=1.0),
                          dict(compact=True), None),
    "promoted_bucketed_coarse": (lambda: jsc.make_large_scenario(120, 8,
                                                                 seed=0),
                                 dict(),
                                 dict(init="nearest", max_moves=8,
                                      exchange_samples=0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compact_spaces_match_jax(case):
    make, opts, run = CASES[case]
    js = make()
    jeng, want, teng, got = both(js, run=run, **opts)
    assert teng.compact == jeng.compact
    if case == "promoted_bucketed_coarse":
        assert teng.compact == "bucketed" and len(teng._buckets) > 1
    if case == "sparse_auto":
        assert teng.compact is True
    assert_same_point(want, got)
    if case.startswith("exchanges"):
        assert teng.last_counts["exchanges"] >= 1
    if js.max_devices is not None:
        load = np.bincount(got.assignment[js.active_mask],
                           minlength=js.n_servers)
        assert (load <= js.max_devices).all()
        assert (load == js.max_devices).any()       # the caps bind
    avail = np.asarray(js.avail)
    assert all(avail[s, d] for d, s in enumerate(got.assignment))


@pytest.mark.parametrize("kind", ["comp_only", "comm_only", "uniform",
                                  "proportional"])
def test_compact_scheme_kinds_match_jax(kind):
    """The plain-solver kinds in the flat space against JAX's (the JAX
    test's fixture and its 8 exchanges); the proportional kind also in
    the bucketed space, whose per-row distance gather it adds."""
    js = jsc.make_scenario(12, 3, seed=6, reach_m=300.0)
    run = dict(init="nearest", exchange_samples=8)
    spaces = (True, "bucketed") if kind == "proportional" else (True,)
    for compact in spaces:
        _, want, _, got = both(js, run=run, kind=kind, compact=compact)
        assert_same_point(want, got)
        assert np.isfinite(got.total_cost) and got.total_cost > 0


def test_compact_paper_kind_matches_jax():
    """``solve_paper`` in the flat space, one move from the nearest start
    on a small sparse fixture: JAX's move and assignment, the total cost at
    the JAX solver's own 2.5e-2 spread. Its f and beta are not pinned (the
    objective is flat at its minimum), so neither is the true cost. (The
    ``optimal`` kind takes the same bucket path; its plain ``solve_exact``
    needs about 8 s a batch on the CPU, so no engine run of it is here.)"""
    js = jsc.make_scenario(9, 3, seed=6, reach_m=300.0)
    run = dict(init="nearest", exchange_samples=0, max_moves=1)
    _, want, _, got = both(js, run=run, kind="paper", compact=True)
    assert np.array_equal(want.assignment, got.assignment)
    assert want.n_adjustments == got.n_adjustments == 1
    assert got.total_cost == pytest.approx(want.total_cost, rel=PAPER_RTOL)
    assert np.isfinite(got.true_cost)


def _three_spaces(ts, **run):
    out = {}
    for compact in (False, True, "bucketed"):
        eng = taf.FastAssociationEngine(ts, compact=compact, device="cpu",
                                        profile="coarse")
        res = eng.run(**run)
        out[compact] = (eng, res)
    return out


@pytest.mark.parametrize("fixture", ["uniform_16_4_reach300",
                                     "large_40_5"])
def test_fast_kind_bit_equal_across_the_ports_spaces(fixture):
    js = (jsc.make_scenario(16, 4, seed=2, reach_m=300.0)
          if fixture.startswith("uniform")
          else jsc.make_large_scenario(40, 5, seed=0))
    out = _three_spaces(port_scenario(js), init="random",
                        exchange_samples=16)
    eng0, ref = out[False]
    assert ref.n_adjustments > 0
    for compact in (True, "bucketed"):
        eng, res = out[compact]
        assert np.array_equal(res.assignment, ref.assignment), compact
        assert res.n_adjustments == ref.n_adjustments
        assert eng.last_counts == eng0.last_counts
        assert res.cost_trace == ref.cost_trace          # the same bits
        assert res.total_cost == ref.total_cost
        assert np.array_equal(eng.last_state["cur_cost"].view(np.int32),
                              eng0.last_state["cur_cost"].view(np.int32))


def test_other_kinds_across_the_ports_spaces():
    """The plain solvers' halving tree depends on the width, so other kinds
    may differ between spaces in the last ulp: the same stable point,
    costs at 2e-4."""
    ts = port_scenario(jsc.make_scenario(12, 3, seed=6, reach_m=300.0))
    res = [taf.FastAssociationEngine(ts, kind="uniform", compact=c,
                                     device="cpu").run(exchange_samples=0)
           for c in (False, True, "bucketed")]
    for r in res[1:]:
        assert np.array_equal(r.assignment, res[0].assignment)
        assert r.n_adjustments == res[0].n_adjustments
        assert r.total_cost == pytest.approx(res[0].total_cost, rel=RTOL)


def test_compact_rejects_out_of_reach_assignment():
    ts = port_scenario(jsc.make_scenario(16, 4, seed=2, reach_m=300.0))
    dev = int(np.argmin(ts.avail.sum(axis=0)))
    srv = int(np.flatnonzero(~ts.avail[:, dev])[0])
    for compact in (True, "bucketed"):
        eng = taf.FastAssociationEngine(ts, compact=compact, device="cpu")
        bad = eng.initial_assignment("nearest")
        bad[dev] = srv
        with pytest.raises(ValueError, match="within\\s+reach"):
            eng.run(assignment=bad, exchange_samples=0)
        with pytest.raises(ValueError, match="within\\s+reach"):
            eng.run_tiered(assignment=bad, exchange_samples=0)
    # the dense space prices the placement, as the reference does
    dense = taf.FastAssociationEngine(ts, compact=False, device="cpu")
    assert dense.run(assignment=bad, exchange_samples=0,
                     max_moves=1).n_adjustments <= 1


def test_compact_rejects_unreachable_device_and_auto_goes_dense():
    js = jsc.make_scenario(10, 3, seed=0)
    js.avail[:, 0] = False
    ts = port_scenario(js)
    for compact in (True, "bucketed"):
        with pytest.raises(ValueError):
            taf.FastAssociationEngine(ts, compact=compact, device="cpu")
    assert taf.FastAssociationEngine(ts, device="cpu").compact is False


@pytest.mark.parametrize("compact", [True, "bucketed"])
def test_toggle_caches_equal_fresh_solves(compact):
    """Every valid slot of the stable point's cache, and every server's
    current cost, against a fresh ``solve_batch`` of the same dense mask
    plus the cloud constant: the same bits (the packed solve and the
    bucket row sum the same active slots in the same order)."""
    ts = port_scenario(jsc.make_scenario(16, 4, seed=2, reach_m=300.0))
    eng = taf.FastAssociationEngine(ts, compact=compact, device="cpu",
                                    profile="coarse")
    eng.run("nearest", exchange_samples=0)
    st = eng.last_state
    member = st["member"]
    cloud = eng.cloud_const.numpy()
    solver = eng.solver
    if compact == "bucketed":
        rbk = st["reach_buckets"]
        rows = [(b, r, int(srv)) for b, bk in enumerate(rbk.buckets)
                for r, srv in enumerate(bk.servers)]
        valid = {(b, r): bk.valid[r] for b, bk in enumerate(rbk.buckets)
                 for r in range(len(bk.servers))}
        idx = {(b, r): bk.idx[r] for b, bk in enumerate(rbk.buckets)
               for r in range(len(bk.servers))}
        cache = {(b, r): st["toggle_cost_buckets"][b][r] for b, r, _ in rows}
    else:
        reach = st["reach"]
        rows = [(0, s, s) for s in range(ts.n_servers)]
        valid = {(0, s): reach.valid[s] for s in range(ts.n_servers)}
        idx = {(0, s): reach.idx[s] for s in range(ts.n_servers)}
        cache = {(0, s): st["toggle_cost_compact"][s]
                 for s in range(ts.n_servers)}
        assert np.array_equal(st["member_compact"][:, :],
                              member[np.arange(ts.n_servers)[:, None],
                                     reach.idx] & reach.valid)
    for b, r, s in rows:
        slots = np.flatnonzero(valid[(b, r)])
        masks = np.repeat(member[s][None], slots.size + 1, axis=0)
        masks[np.arange(1, slots.size + 1), idx[(b, r)][slots]] ^= True
        fresh = solver.solve_batch(np.full(slots.size + 1, s), masks)
        cost = fresh.cost.numpy() + np.where(masks.any(1), cloud[s], 0.0
                                             ).astype(np.float32)
        assert cost[0] == st["cur_cost"][s]
        assert np.array_equal(cost[1:], cache[(b, r)][slots])


def test_packed_solve_batch_equals_the_full_width_solve():
    """``GroupSolver.solve_batch`` solves the ``fast`` kind on each group's
    members packed into the leading slots: the same bits as the
    full-width batch, masked slots at (f_min, 0)."""
    ts = port_scenario(jsc.make_scenario(30, 4, seed=3))
    solver = tea.GroupSolver(ts, "fast", device="cpu", profile="coarse")
    rng = np.random.default_rng(0)
    masks = torch.as_tensor(rng.uniform(size=(9, 30)) < 0.3)
    masks[0] = False
    masks[1] = True
    sids = torch.as_tensor(np.arange(9) % 4)
    got = solver.solve_batch(sids, masks)
    want = tea.solve_groups("fast", solver.consts.rows(sids), masks,
                            profile="coarse")
    for x, y in zip((got.f, got.beta, got.cost, got.deadline),
                    (want.f, want.beta, want.cost, want.deadline)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_a_space_wider_than_the_kernel_raises():
    ts = tsc.make_scenario(tgs.MAX_R + 4, 2, seed=0, device="cpu")
    with pytest.raises(ValueError, match=str(tgs.MAX_R + 4)):
        taf.FastAssociationEngine(ts, compact=False, device="cpu")
    # another kind runs the plain solvers, which take any width
    assert taf.FastAssociationEngine(ts, kind="uniform", compact=False,
                                     device="cpu").compact is False


def test_last_state_layouts():
    ts = port_scenario(jsc.make_scenario(12, 3, seed=7, reach_m=300.0))
    keys = {False: {"toggle_cost"},
            True: {"toggle_cost_compact", "member_compact", "reach"},
            "bucketed": {"toggle_cost_buckets", "reach_buckets"}}
    for compact, extra in keys.items():
        eng = taf.FastAssociationEngine(ts, compact=compact, device="cpu",
                                        profile="coarse")
        eng.run(exchange_samples=0, max_moves=1)
        assert set(eng.last_state) == {"member", "cur_cost"} | extra
