"""Port parity: ``rerun_incremental``. Inside the port, the warm start
(patched reach maps, repaired assignment, only the stale cache rows
re-solved) lands on the cold rebuild's stable point bit for bit
(``verify=True`` raises otherwise) in the dense, flat and bucketed spaces,
chained across deltas with arrivals, after ``run_tiered``, with and
without sampled exchanges and under capacities; and its stable point is
the one JAX's ``rerun_incremental`` reaches on the same delta."""

import dataclasses

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

from repro.core import assoc_fast as jaf
from repro.core import scenario as jsc
from repro_torch.core import assoc_fast as taf
from repro_torch.core import scenario as tsc

from test_torch_assoc_fast import port_scenario

torch.set_num_threads(2)

RTOL = 2e-4
CHURN = dict(drift_m=80.0, move_frac=0.2, flip_frac=0.1, depart_frac=0.15)


def engines(js, **opts):
    opts.setdefault("profile", "coarse")
    return (jaf.FastAssociationEngine(js, **opts),
            taf.FastAssociationEngine(port_scenario(js), device="cpu", **opts))


def assert_same(want, got):
    assert np.array_equal(want.assignment, got.assignment)
    assert got.total_cost == pytest.approx(want.total_cost, rel=RTOL)
    assert got.true_cost == pytest.approx(want.true_cost, rel=RTOL)


@pytest.mark.parametrize("compact", [False, True, "bucketed"])
def test_warm_equals_cold_and_matches_jax(compact):
    """One churn tick after a transfer-only descent: the port's warm
    rerun passes its own cold-rebuild gate and lands where JAX's rerun
    does (same moves too); the warm stable point is stable."""
    js = jsc.make_scenario(18, 4, seed=0, reach_m=300.0)
    jeng, teng = engines(js, compact=compact)
    jeng.run("nearest", exchange_samples=0)
    teng.run("nearest", exchange_samples=0)
    js2, jd = jsc.perturb_scenario(js, seed=5, **CHURN)
    ts2, td = tsc.perturb_scenario(teng.sc, seed=5, **CHURN)
    want = jeng.rerun_incremental(js2, jd, exchange_samples=0)
    got = teng.rerun_incremental(ts2, td, exchange_samples=0, verify=True)
    assert_same(want, got)
    assert jeng.last_moves == teng.last_moves
    assert np.array_equal(jeng.last_repaired_assignment,
                          teng.last_repaired_assignment)
    # only stale rows were re-solved, and the result is a stable point
    assert teng.last_counts["init_rows"] <= ts2.n_servers
    again = taf.FastAssociationEngine(ts2, compact=compact, device="cpu",
                                      profile="coarse").run(
        assignment=got.assignment, exchange_samples=0)
    assert again.n_adjustments == 0
    eff = ts2.eff_avail
    assert all(eff[got.assignment[d], d]
               for d in np.flatnonzero(ts2.active_mask))


def test_chained_deltas_with_arrivals_match_jax():
    js = jsc.make_scenario(18, 4, seed=1, reach_m=300.0)
    jeng, teng = engines(js, compact=True)
    jeng.run("nearest", exchange_samples=0)
    teng.run("nearest", exchange_samples=0)
    js1, jd1 = jsc.perturb_scenario(js, seed=2, drift_m=80.0, move_frac=0.2,
                                    depart_frac=0.3)
    assert jd1.departed.sum() > 0
    ts1 = port_scenario(js1)
    r1 = teng.rerun_incremental(ts1, tsc.diff_scenarios(teng.sc, ts1),
                                exchange_samples=0, verify=True)
    assert_same(jeng.rerun_incremental(js1, jd1, exchange_samples=0), r1)
    inact = np.flatnonzero(~ts1.active_mask)
    assert inact.size and (r1.f[inact] == 0).all()
    assert (r1.beta[inact] == 0).all()
    js2, jd2 = jsc.perturb_scenario(js1, seed=3, drift_m=80.0, move_frac=0.2,
                                    arrive_frac=1.0)
    assert jd2.arrived.sum() > 0
    ts2 = port_scenario(js2)
    r2 = teng.rerun_incremental(ts2, tsc.diff_scenarios(ts1, ts2),
                                exchange_samples=0, verify=True)
    assert_same(jeng.rerun_incremental(js2, jd2, exchange_samples=0), r2)
    assert ts2.active_mask.all() and (r2.f > 0).all()


def test_rerun_after_run_tiered_matches_jax():
    """The warm rerun runs at the last tier's profile."""
    js = jsc.make_scenario(16, 4, seed=2, reach_m=300.0)
    jeng, teng = engines(js, compact=True)
    jeng.run_tiered("nearest", exchange_samples=0)
    teng.run_tiered("nearest", exchange_samples=0)
    js2, jd = jsc.perturb_scenario(js, seed=4, **CHURN)
    got = teng.rerun_incremental(port_scenario(js2),
                                 tsc.diff_scenarios(teng.sc,
                                                    port_scenario(js2)),
                                 exchange_samples=0, verify=True)
    assert_same(jeng.rerun_incremental(js2, jd, exchange_samples=0), got)


@pytest.mark.parametrize("samples", [0, 64])
def test_bucketed_with_exchanges_and_caps(samples):
    """The JAX churn test's capacitated bucketed case: descents with 64
    exchanges, then a warm rerun with and without exchanges, verify on;
    inactive devices never move and loads stay within the caps; JAX's
    stable point."""
    js = jsc.make_scenario(16, 4, seed=1, reach_m=300.0, cap_slack=1.2)
    js1, _ = jsc.perturb_scenario(js, seed=2, move_frac=0.0, depart_frac=0.25)
    js2, jd2 = jsc.perturb_scenario(js1, seed=3, drift_m=60.0, move_frac=0.2,
                                    flip_frac=0.1, depart_frac=0.15,
                                    arrive_frac=0.3)
    jeng, teng = engines(js1, compact="bucketed")
    jeng.run("nearest", exchange_samples=64)
    teng.run("nearest", exchange_samples=64)
    ts2 = port_scenario(js2)
    got = teng.rerun_incremental(ts2, tsc.diff_scenarios(teng.sc, ts2),
                                 exchange_samples=samples, verify=True)
    want = jeng.rerun_incremental(js2, jd2, exchange_samples=samples)
    assert_same(want, got)
    load = np.bincount(got.assignment[ts2.active_mask],
                       minlength=ts2.n_servers)
    assert (load <= ts2.capacity).all()


def test_warm_equals_cold_under_caps_over_three_ticks():
    js = jsc.make_large_scenario(24, 4, seed=0, cap_slack=1.3)
    ts = port_scenario(js)
    eng = taf.FastAssociationEngine(ts, device="cpu", profile="coarse")
    eng.run("nearest", exchange_samples=0)
    cur = ts
    churn = dict(drift_m=60.0, move_frac=0.2, flip_frac=0.1,
                 depart_frac=0.15, arrive_frac=0.5)
    for step in range(3):
        nxt, delta = tsc.perturb_scenario(cur, seed=10 + step, **churn)
        a = eng.rerun_incremental(nxt, delta, verify=True, finalize=False)
        load = np.bincount(a[nxt.active_mask], minlength=nxt.n_servers)
        assert (load <= nxt.capacity).all()
        assert np.array_equal(eng.stable_assignment, a)
        cur = nxt


def test_rerun_requires_a_prior_run_and_fixed_caps():
    ts = port_scenario(jsc.make_scenario(10, 3, seed=0, reach_m=300.0))
    eng = taf.FastAssociationEngine(ts, device="cpu")
    assert eng.stable_assignment is None
    ts2, delta = tsc.perturb_scenario(ts, seed=1, move_frac=0.2)
    with pytest.raises(RuntimeError, match="prior run"):
        eng.rerun_incremental(ts2, delta)
    eng.run("nearest", exchange_samples=0, max_moves=2)
    capped = dataclasses.replace(ts2, max_devices=np.full(3, 10, np.int64))
    with pytest.raises(ValueError, match="max_devices"):
        eng.rerun_incremental(capped, delta)
    bigger = port_scenario(jsc.make_scenario(11, 3, seed=0, reach_m=300.0))
    with pytest.raises(ValueError, match="fixed"):
        eng.rerun_incremental(bigger, delta)
