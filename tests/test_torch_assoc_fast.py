"""Port parity: the dense association engine.

The port's scenario is built from the JAX scenario's fields
(``repro_torch.convert``), then both packages descend from the nearest
initial assignment with ``exchange_samples=0`` at the default profile: the
same assignment and move count, costs at the solver pin (rtol 2e-4), and a
monotone cost trace. Beyond those dense default fixtures, one
parametrised test covers inactive devices, the screening profiles, a
random start and a sparse-reach ``make_large_scenario``. With the default
of 64 sampled exchanges (the same threefry stream as JAX's), and with
``run_tiered``, the port lands on JAX's stable point too, on fixtures
where JAX applies exchanges. The port runs on the CPU (the kernel's plain
version, which sums in the kernel's order); ``chip_smoke.py`` repeats the
comparison with the kernel on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import assoc_fast as jaf
from repro.core import scenario as jsc
from repro_torch import convert
from repro_torch.core import assoc_fast as taf
from repro_torch.core import edge_association as tea
from repro_torch.kernels import golden_section as tgs

torch.set_num_threads(2)

FIXTURES = [(14, 3, 0), (20, 5, 0)]


def port_scenario(js):
    def params(obj):
        return {f.name: np.asarray(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}

    return convert.scenario_from_numpy(
        {"dev": params(js.dev), "srv": params(js.srv), "avail": js.avail,
         "dist": js.dist, "lp": dataclasses.asdict(js.lp),
         "active": js.active, "dev_xy": js.dev_xy, "srv_xy": js.srv_xy,
         "reach_m": js.reach_m, "max_devices": js.max_devices},
        device="cpu")


@pytest.fixture(scope="module", params=FIXTURES, ids=lambda f: "n%d_k%d_s%d" % f)
def pair(request):
    n, k, seed = request.param
    js = jsc.make_scenario(n, k, seed=seed)
    ts = port_scenario(js)
    want = jaf.FastAssociationEngine(js, kind="fast", seed=seed,
                                     compact=False).run(
        "nearest", exchange_samples=0)
    eng = taf.FastAssociationEngine(ts, seed=seed, device="cpu")
    before = tgs.LAUNCHES
    got = eng.run("nearest", exchange_samples=0)
    assert tgs.LAUNCHES == before     # CPU tensors never launch the kernel
    return js, ts, eng, want, got


def test_same_stable_point(pair):
    _, _, _, want, got = pair
    assert np.array_equal(want.assignment, got.assignment)
    assert want.n_adjustments == got.n_adjustments > 0
    assert got.total_cost == pytest.approx(want.total_cost, rel=2e-4)
    assert got.true_cost == pytest.approx(want.true_cost, rel=2e-4)
    assert got.true_energy == pytest.approx(want.true_energy, rel=2e-4)
    assert got.true_delay == pytest.approx(want.true_delay, rel=2e-4)
    np.testing.assert_allclose(got.server_cost, want.server_cost, rtol=2e-4)
    np.testing.assert_allclose(got.cost_trace, want.cost_trace, rtol=2e-4)


def _with_inactive(n, k, seed, off):
    js = jsc.make_scenario(n, k, seed=seed)
    active = np.ones(n, dtype=bool)
    active[list(off)] = False
    return dataclasses.replace(js, active=active)


def _random_start(js):
    return jaf.FastAssociationEngine(js, compact=False,
                                     seed=3).initial_assignment("random")


# name -> (JAX scenario, engine options, explicit start or None)
CASES = {
    "inactive_3_of_20": lambda: (_with_inactive(20, 5, 0, (3, 9, 14)), {},
                                 None),
    "profile_screen": lambda: (jsc.make_scenario(20, 5, seed=1),
                               {"profile": "screen"}, None),
    "profile_coarse": lambda: (jsc.make_scenario(20, 5, seed=1),
                               {"profile": "coarse"}, None),
    "random_start": lambda: (lambda js: (js, {}, _random_start(js)))(
        jsc.make_scenario(20, 5, seed=2)),
    "large_sparse_reach": lambda: (jsc.make_large_scenario(40, 6, seed=0),
                                   {}, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_stable_point_beyond_the_dense_default(case):
    """Port against JAX (dense, transfer-only) off the default fixtures:
    the same assignment and move count, true cost at rtol 2e-4."""
    js, opts, start = CASES[case]()
    if case == "large_sparse_reach":
        assert not js.avail.all()            # reach really is sparse
    if start is not None:
        assert not np.array_equal(start, jaf.FastAssociationEngine(
            js, compact=False).initial_assignment("nearest"))
    want = jaf.FastAssociationEngine(js, compact=False, **opts).run(
        "nearest", exchange_samples=0, assignment=start)
    got = taf.FastAssociationEngine(port_scenario(js), compact=False,
                                    device="cpu", **opts).run(
        "nearest", exchange_samples=0, assignment=start)
    assert np.array_equal(want.assignment, got.assignment)
    assert want.n_adjustments == got.n_adjustments > 0
    assert got.true_cost == pytest.approx(want.true_cost, rel=2e-4)
    assert got.total_cost == pytest.approx(want.total_cost, rel=2e-4)


def test_cost_trace_monotone(pair):
    _, _, _, _, got = pair
    trace = np.asarray(got.cost_trace)
    assert trace.shape == (got.n_adjustments + 1,)
    assert np.all(np.diff(trace) <= 0)
    assert trace[-1] < trace[0]


def test_evaluation_helpers_match(pair):
    js, ts, eng, want, _ = pair
    jeng = jaf.FastAssociationEngine(js, kind="fast", compact=False)
    a = want.assignment
    assert eng.evaluate_assignment(a) == pytest.approx(
        jeng.evaluate_assignment(a), rel=2e-4)
    np.testing.assert_allclose(
        taf.assignment_true_cost(ts, a, device="cpu"),
        jaf.assignment_true_cost(js, a), rtol=2e-4)
    assert np.array_equal(taf._dense_member(a, ts.active_mask, ts.n_servers),
                          jaf._dense_member(a, js.active_mask, js.n_servers))


def test_explicit_assignment_and_finalize_off():
    js = jsc.make_scenario(14, 3, seed=0)
    ts = port_scenario(js)
    start = jaf.FastAssociationEngine(js, compact=False).initial_assignment(
        "random")
    ref = jaf.FastAssociationEngine(js, compact=False).run(
        assignment=start, exchange_samples=0, finalize=False)
    got = taf.FastAssociationEngine(ts, device="cpu").run(
        assignment=start, exchange_samples=0, finalize=False)
    assert np.array_equal(ref, got)


def test_engine_raises_for_what_is_not_ported():
    """Nothing raises for want of a port: the compact and bucketed spaces
    and the sharded sweep build (it refuses a shard count below 1),
    ``rerun_incremental`` asks for a prior run, and every scheme kind and
    the default of 64 exchanges run."""
    ts = port_scenario(jsc.make_scenario(8, 2, seed=0))
    eng = taf.FastAssociationEngine(ts, device="cpu")
    assert eng.compact is False               # "auto" on a dense scenario
    for compact in (True, "bucketed"):
        assert taf.FastAssociationEngine(ts, compact=compact,
                                         device="cpu").compact == compact
    assert taf.FastAssociationEngine(ts, shards=2, device="cpu").shards == 2
    with pytest.raises(ValueError, match="positive"):
        taf.FastAssociationEngine(ts, shards=0, device="cpu")
    with pytest.raises(RuntimeError, match="prior run"):
        eng.rerun_incremental(ts, None)
    with pytest.raises(ValueError):
        taf.FastAssociationEngine(ts, compact="flat", device="cpu")
    with pytest.raises(ValueError):
        taf.FastAssociationEngine(ts, permission="nash", device="cpu")
    with pytest.raises(ValueError):
        taf.FastAssociationEngine(ts, kind="nash", device="cpu")
    assert taf.DEFAULT_EXCHANGE_SAMPLES == 64
    assert eng.run("nearest").n_adjustments >= 0


EXCHANGE_FIXTURES = FIXTURES + [(14, 4, 1)]


@pytest.mark.parametrize("fix", EXCHANGE_FIXTURES,
                         ids=lambda f: "n%d_k%d_s%d" % f)
def test_exchanges_land_on_jax_stable_point(fix):
    """The default run (64 sampled exchanges, random start) against JAX's:
    the same stable point and move count, costs at rtol 2e-4. On each of
    these fixtures JAX applies at least one exchange: its run ends below
    its transfer-only run from the same start, with more moves."""
    n, k, seed = fix
    js = jsc.make_scenario(n, k, seed=seed)
    want = jaf.FastAssociationEngine(js, seed=seed, compact=False).run(
        "random")
    transfers_only = jaf.FastAssociationEngine(js, seed=seed,
                                               compact=False).run(
        "random", exchange_samples=0)
    assert want.n_adjustments > transfers_only.n_adjustments
    assert want.total_cost < transfers_only.total_cost
    eng = taf.FastAssociationEngine(port_scenario(js), seed=seed,
                                    device="cpu")
    got = eng.run("random")
    assert np.array_equal(want.assignment, got.assignment)
    assert want.n_adjustments == got.n_adjustments
    counts = eng.last_counts
    assert counts["exchanges"] >= 1
    assert counts["exchanges"] + counts["transfers"] == got.n_adjustments
    assert counts["exchange_rounds"] == counts["exchanges"] + 1
    assert got.total_cost == pytest.approx(want.total_cost, rel=2e-4)
    assert got.true_cost == pytest.approx(want.true_cost, rel=2e-4)
    np.testing.assert_allclose(got.cost_trace, want.cost_trace, rtol=2e-4)
    assert np.all(np.diff(got.cost_trace) <= 0)


def test_exchanges_from_a_transfer_only_stable_point():
    """Exchanges escape the stable point of a transfer-only descent: from
    that assignment both engines apply the same exchanges, and a pareto
    run matches too."""
    js = jsc.make_scenario(20, 5, seed=0)
    ts = port_scenario(js)
    stuck = jaf.FastAssociationEngine(js, compact=False).run(
        "nearest", exchange_samples=0).assignment
    for perm in ("utilitarian", "pareto"):
        want = jaf.FastAssociationEngine(js, compact=False, seed=3,
                                         permission=perm).run(
            assignment=stuck)
        got = taf.FastAssociationEngine(ts, seed=3, permission=perm,
                                        device="cpu").run(assignment=stuck)
        assert np.array_equal(want.assignment, got.assignment), perm
        assert want.n_adjustments == got.n_adjustments, perm
        assert got.total_cost == pytest.approx(want.total_cost, rel=2e-4)


@pytest.mark.parametrize("plan", ["two_tier", "three_tier"])
def test_run_tiered_matches(plan):
    """``run_tiered``: each tier keyed by ``fold_in(PRNGKey(seed), i)``,
    the same assignment and moves per tier as JAX."""
    js = jsc.make_scenario(20, 5, seed=1)
    jeng = jaf.FastAssociationEngine(js, seed=1, compact=False)
    want = jeng.run_tiered("random", tiers=plan)
    eng = taf.FastAssociationEngine(port_scenario(js), seed=1, device="cpu")
    got = eng.run_tiered("random", tiers=plan)
    assert np.array_equal(want.assignment, got.assignment)
    assert eng.last_tier_moves == jeng.last_tier_moves
    assert want.n_adjustments == got.n_adjustments == sum(eng.last_tier_moves)
    assert got.total_cost == pytest.approx(want.total_cost, rel=2e-4)
    with pytest.raises(ValueError):
        eng.run_tiered(tiers=plan, tier_rel_tols=(1e-5,))


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    ts = port_scenario(jsc.make_scenario(8, 2, seed=0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        taf.FastAssociationEngine(ts)
    with pytest.raises(RuntimeError):
        tea.GroupSolver(ts)
    from repro_torch.core import scenario as tsc
    with pytest.raises(RuntimeError):
        tsc.make_scenario(8, 2)


def test_pareto_permission_matches():
    js = jsc.make_scenario(14, 3, seed=0)
    want = jaf.FastAssociationEngine(js, permission="pareto",
                                     compact=False).run(
        "nearest", exchange_samples=0)
    got = taf.FastAssociationEngine(port_scenario(js), permission="pareto",
                                    device="cpu").run(
        "nearest", exchange_samples=0)
    assert np.array_equal(want.assignment, got.assignment)
    assert want.n_adjustments == got.n_adjustments


def test_binding_caps_match():
    js = jsc.make_scenario(20, 5, seed=0, cap_slack=1.0)
    want = jaf.FastAssociationEngine(js, compact=False).run(
        "nearest", exchange_samples=0)
    got = taf.FastAssociationEngine(port_scenario(js), device="cpu").run(
        "nearest", exchange_samples=0)
    assert np.array_equal(want.assignment, got.assignment)
    assert want.n_adjustments == got.n_adjustments
    assert (np.bincount(got.assignment, minlength=5) <= js.capacity).all()
