"""Port parity: the §V.A scheme kinds, the host ``AssociationEngine`` and
``evaluate_scheme``.

The port's scenario is built from the JAX scenario's fields; both packages
then run the same call. Group solves of every scheme kind agree at cost
rtol 2e-4 (``paper`` at the bound of ``test_torch_ra_solvers.py``, set from
the JAX solver's own spread); the fixed draws of the degenerate schemes are
bit-identical; the host engine and every scheme land on JAX's assignment
with the same adjustment count and costs at 2e-4. The port runs on the CPU
(the golden-section kernel's plain version); ``chip_smoke.py`` repeats the
scheme comparison with the kernel on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import edge_association as jea
from repro.core import scenario as jsc
from repro_torch.core import edge_association as tea
from test_torch_assoc_fast import port_scenario
from test_torch_ra_solvers import PAPER_RTOL

torch.set_num_threads(2)

RTOL = 2e-4
SCHEMES = ("hfel", "random", "greedy", "comp_opt", "comm_opt", "uniform",
           "proportional")


def _masks(n, k, seed):
    """Groups with no member, one, some and all, on rotating servers."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((4, n), bool)
    masks[1, 5] = True
    masks[2] = rng.uniform(size=n) < 0.4
    masks[3] = True
    return np.arange(4) % k, masks


@pytest.mark.parametrize("kind", tea.SCHEME_KINDS)
def test_scheme_kind_group_solves_match(kind):
    js = jsc.make_scenario(14, 3, seed=2)
    servers, masks = _masks(14, 3, 2)
    want = jea.GroupSolver(js, kind, seed=4).solve_batch(servers, masks)
    got = tea.GroupSolver(port_scenario(js), kind, seed=4,
                          device="cpu").solve_batch(servers, masks)
    rtol = PAPER_RTOL if kind == "paper" else RTOL
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               rtol=rtol)
    assert got.cost[0] == 0.0
    if kind in ("uniform", "proportional"):
        # no optimization: the fixed point itself, elementwise
        np.testing.assert_allclose(got.beta.numpy(), np.asarray(want.beta),
                                   rtol=1e-6)
        np.testing.assert_allclose(got.f.numpy(), np.asarray(want.f),
                                   rtol=1e-6)
    # the single-group dispatch is the batch at G = 1
    solver = tea.GroupSolver(port_scenario(js), kind, seed=4, device="cpu")
    one = tea.solve_group(kind, solver.consts.rows(2),
                          torch.as_tensor(masks[2]),
                          random_f=solver.random_f,
                          inv_dist_row=solver.inv_dist[2])
    np.testing.assert_allclose(float(one.cost), float(want.cost[2]),
                               rtol=rtol)


@pytest.mark.parametrize("seed", [0, 3])
def test_fixed_draws_are_bit_identical(seed):
    js = jsc.make_scenario(25, 4, seed=1)
    want = jea.GroupSolver(js, "uniform", seed=seed)
    got = tea.GroupSolver(port_scenario(js), "uniform", seed=seed,
                          device="cpu")
    assert got.random_f.dtype == torch.float32
    assert np.array_equal(got.random_f.numpy(), np.asarray(want.random_f))
    assert np.array_equal(got.inv_dist.numpy(), np.asarray(want.inv_dist))
    assert got.with_profile("coarse").random_f is got.random_f


ENGINE_FIXTURES = [(18, 4, 0), (14, 4, 1)]


@pytest.mark.parametrize("method", ["run", "run_batched"])
@pytest.mark.parametrize("fix", ENGINE_FIXTURES, ids=lambda f: "n%d_k%d_s%d" % f)
def test_host_engine_matches(fix, method):
    """Algorithm 3 as written (``run``: one exchange attempt a round) and
    its batched variant (64 sampled exchanges when stuck) from a random
    start: the same draws, assignment and adjustment count."""
    n, k, seed = fix
    js = jsc.make_scenario(n, k, seed=seed)
    want = getattr(jea.AssociationEngine(js, kind="fast", seed=seed),
                   method)("random")
    got = getattr(tea.AssociationEngine(port_scenario(js), kind="fast",
                                        seed=seed, device="cpu"),
                  method)("random")
    assert np.array_equal(want.assignment, got.assignment)
    assert want.n_adjustments == got.n_adjustments > 0
    assert want.n_rounds == got.n_rounds
    assert got.total_cost == pytest.approx(want.total_cost, rel=RTOL)
    assert got.true_cost == pytest.approx(want.true_cost, rel=RTOL)
    np.testing.assert_allclose(got.cost_trace, want.cost_trace, rtol=RTOL)
    np.testing.assert_allclose(got.server_cost, want.server_cost, rtol=RTOL)
    trace = np.asarray(got.cost_trace)
    assert np.all(np.diff(trace) <= 1e-6 * trace[:-1])


def test_host_engine_stable_point_and_permissions():
    """Re-running from the stable point applies nothing; the strict pareto
    reading permits at most as many adjustments (JAX's own counts)."""
    js = jsc.make_scenario(16, 4, seed=3)
    ts = port_scenario(js)
    results = {}
    for perm in ("utilitarian", "pareto"):
        want = jea.AssociationEngine(js, kind="fast", permission=perm,
                                     seed=0).run_batched("random")
        got = tea.AssociationEngine(ts, kind="fast", permission=perm,
                                    seed=0, device="cpu").run_batched(
            "random")
        assert np.array_equal(want.assignment, got.assignment)
        assert want.n_adjustments == got.n_adjustments
        results[perm] = got
    assert (results["pareto"].n_adjustments
            <= results["utilitarian"].n_adjustments)
    again = tea.AssociationEngine(ts, kind="fast", seed=0,
                                  device="cpu").run_batched(
        assignment=results["utilitarian"].assignment, exchange_samples=0)
    assert again.n_adjustments == 0


def test_host_engine_respects_availability():
    js = jsc.make_scenario(16, 4, seed=2, reach_m=250.0)
    assert not js.avail.all()
    want = jea.AssociationEngine(js, kind="fast", seed=0).run_batched(
        "nearest")
    got = tea.AssociationEngine(port_scenario(js), kind="fast", seed=0,
                                device="cpu").run_batched("nearest")
    assert np.array_equal(want.assignment, got.assignment)
    for dev, srv in enumerate(got.assignment):
        assert js.avail[srv, dev]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_evaluate_scheme_matches(scheme):
    """Each §V.A scheme on (12, 3, 5) through the default fast engine
    (64 exchanges, random start): JAX's assignment, adjustment count and
    costs."""
    js = jsc.make_scenario(12, 3, seed=5)
    want = jea.evaluate_scheme(js, scheme, seed=0)
    got = tea.evaluate_scheme(port_scenario(js), scheme, seed=0,
                              device="cpu")
    assert np.array_equal(want.assignment, got.assignment)
    assert want.n_adjustments == got.n_adjustments
    assert got.total_cost == pytest.approx(want.total_cost, rel=RTOL)
    assert got.true_cost == pytest.approx(want.true_cost, rel=RTOL)
    assert np.isfinite(got.f).all() and np.isfinite(got.beta).all()


def test_evaluate_scheme_engines_and_tiers():
    """``engine="batched"``, ``"loop"`` (and ``batched=False``) and
    ``tiers`` land where JAX's do."""
    js = jsc.make_scenario(12, 3, seed=5)
    ts = port_scenario(js)
    for opts in ({"engine": "batched"}, {"batched": False},
                 {"tiers": "two_tier"}):
        want = jea.evaluate_scheme(js, "hfel", seed=1, **opts)
        got = tea.evaluate_scheme(ts, "hfel", seed=1, device="cpu", **opts)
        assert np.array_equal(want.assignment, got.assignment), opts
        assert want.n_adjustments == got.n_adjustments, opts
        assert got.total_cost == pytest.approx(want.total_cost, rel=RTOL)
    with pytest.raises(ValueError):
        tea.evaluate_scheme(ts, "hfel", engine="loop", tiers="two_tier",
                            device="cpu")


@pytest.mark.parametrize("compact", [True, "bucketed", "auto"])
def test_evaluate_scheme_in_compact_spaces(compact):
    """The fast engine of ``evaluate_scheme("hfel")`` (random start, 64
    exchanges) in the flat and bucketed spaces, and under ``"auto"`` on a
    sparse-reach scenario, lands where JAX's does."""
    js = jsc.make_scenario(16, 4, seed=2, reach_m=250.0)
    want = jea.evaluate_scheme(js, "hfel", seed=1, profile="coarse",
                               compact=compact)
    got = tea.evaluate_scheme(port_scenario(js), "hfel", seed=1,
                              profile="coarse", compact=compact,
                              device="cpu")
    assert np.array_equal(want.assignment, got.assignment)
    assert want.n_adjustments == got.n_adjustments
    assert got.total_cost == pytest.approx(want.total_cost, rel=RTOL)


def test_hfel_beats_nonassociated_schemes():
    """The paper's claim on (20, 5, 4), at the JAX test's 1.001 bound."""
    ts = port_scenario(jsc.make_scenario(20, 5, seed=4))
    hfel = tea.evaluate_scheme(ts, "hfel", seed=0, device="cpu")
    for other in ("random", "uniform"):
        res = tea.evaluate_scheme(ts, other, seed=0, device="cpu")
        assert hfel.total_cost <= res.total_cost * 1.001, other


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    ts = port_scenario(jsc.make_scenario(8, 2, seed=0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tea.AssociationEngine(ts)
    with pytest.raises(RuntimeError):
        tea.evaluate_scheme(ts, "greedy")
    assert jnp.asarray(0).dtype == jnp.int32     # x64 stays off
