"""Port parity: scenario generation and the feasibility helpers of
``repro_torch`` are bit-identical to the JAX package's (numpy draws from the
same ``default_rng`` streams)."""

import dataclasses

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

from repro.core import edge_association as jea
from repro.core import scenario as jsc
from repro_torch.core import edge_association as tea
from repro_torch.core import scenario as tsc

torch.set_num_threads(2)


def _params(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def assert_same_scenario(js, ts):
    for name, value in _params(js.dev).items():
        assert np.array_equal(value, getattr(ts.dev, name).cpu().numpy()), name
    for name, value in _params(js.srv).items():
        assert np.array_equal(value, getattr(ts.srv, name).cpu().numpy()), name
    for name in ("avail", "dist", "dev_xy", "srv_xy", "active",
                 "max_devices"):
        a, b = getattr(js, name), getattr(ts, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert js.reach_m == ts.reach_m
    assert dataclasses.asdict(js.lp) == dataclasses.asdict(ts.lp)
    assert ts.dev.f_min.dtype == torch.float32


@pytest.mark.parametrize("cap_slack", [None, 1.1])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_scenario_bit_identical(seed, cap_slack):
    js = jsc.make_scenario(30, 4, seed=seed, cap_slack=cap_slack)
    ts = tsc.make_scenario(30, 4, seed=seed, cap_slack=cap_slack,
                           device="cpu")
    assert_same_scenario(js, ts)
    assert np.array_equal(js.eff_avail, ts.eff_avail)
    assert np.array_equal(js.active_mask, ts.active_mask)
    assert (js.capacity is None and ts.capacity is None) or np.array_equal(
        js.capacity, ts.capacity)


@pytest.mark.parametrize("cap_slack", [None, 1.1])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_large_scenario_bit_identical(seed, cap_slack):
    js = jsc.make_large_scenario(200, 10, seed=seed, cap_slack=cap_slack)
    ts = tsc.make_large_scenario(200, 10, seed=seed, cap_slack=cap_slack,
                                 device="cpu")
    assert_same_scenario(js, ts)
    # the restricted reach radius really is sparse here
    assert not ts.avail.all()


def test_geometry_helpers_bit_identical():
    rng = np.random.default_rng(5)
    srv, dev = rng.uniform(0, 900, (7, 2)), rng.uniform(0, 900, (50, 2))
    assert np.array_equal(jsc.pairwise_dist(srv, dev, chunk=16),
                          tsc.pairwise_dist(srv, dev, chunk=16))
    dist = tsc.pairwise_dist(srv, dev)
    assert np.array_equal(jsc.channel_gain_from_distance(dist),
                          tsc.channel_gain_from_distance(dist))
    assert np.array_equal(jsc._capacities(dist, 0.8),
                          tsc._capacities(dist, 0.8))


@pytest.mark.parametrize("cap_slack", [None, 1.1])
@pytest.mark.parametrize("init", ["nearest", "random"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_initial_assignment_bit_identical(seed, init, cap_slack):
    js = jsc.make_large_scenario(120, 8, seed=seed, cap_slack=cap_slack)
    ts = tsc.make_large_scenario(120, 8, seed=seed, cap_slack=cap_slack,
                                 device="cpu")

    def run(pkg, sc):
        # a random draw can strand a device when caps bind: both packages
        # must then raise for the same devices
        try:
            return pkg.initial_assignment(sc, sc.eff_avail,
                                          np.random.default_rng(seed), init)
        except pkg.NoFeasibleServerError as err:
            return ("raised", err.devices.tolist())

    a, b = run(jea, js), run(tea, ts)
    if isinstance(a, tuple):
        assert a == b
    else:
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_initial_assignment_with_inactive_devices():
    """Parked slots for inactive devices take the reference's rule."""
    js = jsc.make_large_scenario(80, 6, seed=3)
    ts = tsc.make_large_scenario(80, 6, seed=3, device="cpu")
    active = np.random.default_rng(9).uniform(size=80) < 0.7
    js = dataclasses.replace(js, active=active)
    ts = dataclasses.replace(ts, active=active.copy())
    for init in ("nearest", "random"):
        a = jea.initial_assignment(js, js.eff_avail,
                                   np.random.default_rng(1), init)
        b = tea.initial_assignment(ts, ts.eff_avail,
                                   np.random.default_rng(1), init)
        assert np.array_equal(a, b)
    assert np.array_equal(jea.parked_slots(js), tea.parked_slots(ts))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_feasibility_helpers_bit_identical(seed):
    rng = np.random.default_rng(seed)
    dist = rng.uniform(1, 500, (6, 40))
    feasible = rng.uniform(size=(6, 40)) < 0.4
    feasible[0, :] = True
    assert np.array_equal(jea.nearest_feasible(dist, feasible),
                          tea.nearest_feasible(dist, feasible))
    cap = rng.integers(3, 9, 6)
    devices = rng.permutation(40)
    load_j, load_t = np.zeros(6, np.int64), np.zeros(6, np.int64)
    out_j = jea.greedy_admission(dist, feasible, load_j, cap, devices)
    out_t = tea.greedy_admission(dist, feasible, load_t, cap, devices)
    assert np.array_equal(out_j, out_t) and np.array_equal(load_j, load_t)
    assert (out_t < 0).any()      # caps bind: some devices are not placed
    # a needed device with no feasible server raises in both packages
    feasible[:, 7] = False
    with pytest.raises(jea.NoFeasibleServerError) as ej:
        jea.nearest_feasible(dist, feasible)
    with pytest.raises(tea.NoFeasibleServerError) as et:
        tea.nearest_feasible(dist, feasible)
    assert np.array_equal(ej.value.devices, et.value.devices)
