"""Port parity: churn is the JAX package's, bit for bit. ``perturb_scenario``
(positions, ``dist``, ``avail``, ``active`` and the delta, caps carried),
``diff_scenarios`` over one tick and two composed ticks, the device-client
bridge, and ``repair_assignment`` with and without capacities, each on the
same inputs in both packages (numpy code, line for line)."""

import dataclasses

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

from repro.core import assoc_fast as jaf
from repro.core import edge_association as jea
from repro.core import scenario as jsc
from repro_torch.core import assoc_fast as taf
from repro_torch.core import edge_association as tea
from repro_torch.core import scenario as tsc
from repro_torch.core.cost_model import LearningParams

from test_torch_assoc_fast import port_scenario
from test_torch_scenario import assert_same_scenario

torch.set_num_threads(2)

CHURN = dict(drift_m=60.0, move_frac=0.2, flip_frac=0.1, depart_frac=0.15,
             arrive_frac=0.5)
DELTA_FIELDS = ("moved", "arrived", "departed", "avail_flips", "eff_flips",
                "stale_servers")


def assert_same_delta(a, b):
    assert a.seed == b.seed
    for name in DELTA_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert np.array_equal(a.touched_devices, b.touched_devices)


# (JAX scenario, churn): uniform reach, clustered, and clustered with caps
CASES = {
    "uniform_20_4": (lambda: jsc.make_scenario(20, 4, seed=1, reach_m=300.0),
                     dict(drift_m=80.0, move_frac=0.2, flip_frac=0.1,
                          depart_frac=0.15)),
    "large_16_3": (lambda: jsc.make_large_scenario(16, 3, seed=0), CHURN),
    "large_24_4_caps": (lambda: jsc.make_large_scenario(24, 4, seed=0,
                                                        cap_slack=1.3),
                        CHURN),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def trajectory(request):
    """Three chained ticks in each package from the same scenario."""
    make, churn = CASES[request.param]
    js = make()
    ts = port_scenario(js)
    steps = []
    for step in range(3):
        js2, jd = jsc.perturb_scenario(js, seed=7 + step, **churn)
        ts2, td = tsc.perturb_scenario(ts, seed=7 + step, **churn)
        steps.append((js, ts, js2, ts2, jd, td))
        js, ts = js2, ts2
    return steps


def test_perturb_scenario_bit_identical(trajectory):
    for _, ts, js2, ts2, jd, td in trajectory:
        assert_same_scenario(js2, ts2)
        assert_same_delta(jd, td)
        # physical parameters stay the same objects, on the same device
        assert ts2.dev is ts.dev and ts2.srv is ts.srv
        assert ts2.device == ts.device
        assert np.array_equal(ts2.eff_avail, js2.eff_avail)
        if js2.max_devices is not None:
            assert np.array_equal(ts2.capacity, js2.capacity)


def test_perturb_leaves_the_input_untouched(trajectory):
    _, ts, _, _, _, _ = trajectory[0]
    before = (ts.avail.copy(), ts.dist.copy(), ts.active_mask.copy())
    tsc.perturb_scenario(ts, seed=99, **CHURN)
    assert np.array_equal(ts.avail, before[0])
    assert np.array_equal(ts.dist, before[1])
    assert np.array_equal(ts.active_mask, before[2])


def test_diff_scenarios_one_tick_and_composed(trajectory):
    """One tick: the diff is that tick's delta (seed -1); two and three
    ticks composed: the same combined delta as JAX's."""
    start_j, start_t = trajectory[0][0], trajectory[0][1]
    for i, (js, ts, js2, ts2, _, _) in enumerate(trajectory):
        assert_same_delta(jsc.diff_scenarios(js, js2),
                          tsc.diff_scenarios(ts, ts2))
        if i:
            assert_same_delta(jsc.diff_scenarios(start_j, js2),
                              tsc.diff_scenarios(start_t, ts2))


def test_diff_scenarios_rejects_unrelated_scenarios():
    ts = port_scenario(jsc.make_large_scenario(16, 3, seed=0))
    ts2, _ = tsc.perturb_scenario(ts, seed=1, **CHURN)
    with pytest.raises(ValueError):
        tsc.diff_scenarios(ts, port_scenario(
            jsc.make_large_scenario(17, 3, seed=0)))
    with pytest.raises(ValueError, match="churn-invariant"):
        tsc.diff_scenarios(ts, port_scenario(
            jsc.make_large_scenario(16, 3, seed=99)))
    with pytest.raises(ValueError, match="churn-invariant"):
        tsc.diff_scenarios(ts, dataclasses.replace(
            ts2, lp=LearningParams(theta=0.25)))
    capped = dataclasses.replace(
        ts2, max_devices=np.full(3, 16, np.int64))
    with pytest.raises(ValueError, match="capacities"):
        tsc.diff_scenarios(ts, capped)
    # equal tensors in other objects are the same parameters
    same = dataclasses.replace(ts2, dev=dataclasses.replace(
        ts2.dev, f_min=ts2.dev.f_min.clone()))
    assert_same_delta(tsc.diff_scenarios(ts, same),
                      tsc.diff_scenarios(ts, ts2))


def test_device_client_bridge_bit_identical():
    js = jsc.make_large_scenario(16, 3, seed=0)
    ts = port_scenario(js)
    for n_clients, device_of in ((10, None), (16, None),
                                 (4, np.array([5, 0, 12, 3]))):
        want = jsc.device_client_bridge(js, n_clients, device_of)
        got = tsc.device_client_bridge(ts, n_clients, device_of)
        for name in ("device_of", "client_of"):
            x, y = getattr(want, name), getattr(got, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        assert (got.n_clients, got.n_devices) == (n_clients, 16)
        active = np.arange(16) % 3 == 0
        assign = np.arange(16) % 3
        assert np.array_equal(want.client_mask(active),
                              got.client_mask(active))
        assert np.array_equal(want.client_assignment(assign),
                              got.client_assignment(assign))
    for bad in ((17, None), (3, np.array([0, 0, 1])), (2, np.array([0, 16])),
                (2, np.array([0, 1, 2]))):
        with pytest.raises(ValueError):
            tsc.device_client_bridge(ts, *bad)


def test_repair_assignment_bit_identical(trajectory):
    """Each tick's repair of the previous stable point (the nearest start
    stands in for it), with the JAX and port helpers: the same assignment
    and masks, under caps too."""
    for js, ts, js2, ts2, _, _ in trajectory:
        prev = jea.initial_assignment(js, js.eff_avail,
                                      np.random.default_rng(0))
        try:
            want = jaf.repair_assignment(js2, prev, js.active_mask)
        except jea.NoFeasibleServerError as exc:
            with pytest.raises(tea.NoFeasibleServerError) as got_exc:
                taf.repair_assignment(ts2, prev, ts.active_mask)
            assert np.array_equal(exc.devices, got_exc.value.devices)
            continue
        got = taf.repair_assignment(ts2, prev, ts.active_mask)
        for x, y in zip(want, got):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        cap = ts2.capacity
        if cap is not None:
            load = np.bincount(got[0][ts2.active_mask],
                               minlength=ts2.n_servers)
            assert (load <= cap).all()


def test_repair_under_binding_caps_raises_like_jax():
    """Caps of one device each leave arrivals without an admitting
    server: both packages raise for the same devices."""
    js = jsc.make_large_scenario(12, 3, seed=2)
    off = np.zeros(12, bool)
    off[[1, 5, 9]] = True
    js_old = dataclasses.replace(js, active=~off)
    js_new = dataclasses.replace(js, max_devices=np.full(3, 3, np.int64))
    ts_new = port_scenario(js_new)
    prev = np.argmin(np.where(js.avail, js.dist, np.inf), axis=0)
    with pytest.raises(jea.NoFeasibleServerError) as want:
        jaf.repair_assignment(js_new, prev, js_old.active_mask)
    with pytest.raises(tea.NoFeasibleServerError) as got:
        taf.repair_assignment(ts_new, prev, js_old.active_mask)
    assert np.array_equal(want.value.devices, got.value.devices)
