"""Port parity: the reach maps of the compacted sweep spaces and their
incremental updates are the JAX package's, bit for bit (numpy code, line
for line): ``reach_index_map`` flat, bucketed and active-masked, and
``update_reach_index`` / ``update_reach_buckets`` (the ``carry`` list
included, since the warm start keys its cache reuse on it) across chained
churn and across the patch, overflow and sentinel-growth cases of the JAX
churn tests."""

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

from repro.core import scenario as jsc
from repro_torch.core import scenario as tsc

torch.set_num_threads(2)

CHURN = dict(drift_m=120.0, move_frac=0.3, flip_frac=0.2, depart_frac=0.15,
             arrive_frac=0.3)


def assert_same_flat(a, b):
    for name in ("idx", "valid", "slot"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert a.r_max == b.r_max
    assert a.density == b.density
    assert a.padded_fraction == b.padded_fraction


def assert_same_buckets(a, b):
    assert len(a.buckets) == len(b.buckets)
    for x, y in zip(a.buckets, b.buckets):
        for name in ("servers", "idx", "valid"):
            u, v = getattr(x, name), getattr(y, name)
            assert u.dtype == v.dtype and np.array_equal(u, v), name
        assert (x.width, x.key) == (y.width, y.key)
    for name in ("bucket_of", "row_of", "slot"):
        u, v = getattr(a, name), getattr(b, name)
        assert u.dtype == v.dtype and np.array_equal(u, v), name
    assert a.r_max == b.r_max
    assert a.padded_fraction == b.padded_fraction


# mirrors tests/test_scenario_large.py's and test_assoc_compact.py's maps
SCENARIOS = {
    "uniform_40_4_reach300": lambda: jsc.make_scenario(40, 4, seed=1,
                                                       reach_m=300.0),
    "large_250_10": lambda: jsc.make_large_scenario(250, 10, seed=1),
    "large_120_8_skewed": lambda: jsc.make_large_scenario(120, 8, seed=0),
}


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def scenario(request):
    return SCENARIOS[request.param]()


@pytest.mark.parametrize("bucketed", [False, True])
def test_reach_index_map_bit_identical(scenario, bucketed):
    want = jsc.reach_index_map(scenario.avail, bucketed=bucketed)
    got = tsc.reach_index_map(scenario.avail, bucketed=bucketed)
    (assert_same_buckets if bucketed else assert_same_flat)(want, got)


@pytest.mark.parametrize("bucketed", [False, True])
def test_reach_index_map_active_mask_bit_identical(scenario, bucketed):
    rng = np.random.default_rng(4)
    active = rng.uniform(size=scenario.n_devices) < 0.7
    # inactive devices occupy no slot and need not reach anyone
    avail = scenario.avail.copy()
    avail[:, np.flatnonzero(~active)[:2]] = False
    want = jsc.reach_index_map(avail, bucketed=bucketed, active=active)
    got = tsc.reach_index_map(avail, bucketed=bucketed, active=active)
    (assert_same_buckets if bucketed else assert_same_flat)(want, got)


def test_reach_index_map_rejects_zero_reach_device():
    avail = np.ones((3, 5), dtype=bool)
    avail[:, 2] = False
    for pkg in (jsc, tsc):
        with pytest.raises(ValueError, match="reach"):
            pkg.reach_index_map(avail)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_incremental_maps_bit_identical_under_chained_churn(seed):
    """Three chained JAX churn ticks; after each, both packages update the
    same previous maps with the same delta: identical maps, ``rebuilt``
    flags and ``carry`` lists, and ``changed_servers=None`` (the maps'
    own change detector) gives the same maps as the delta's."""
    sc = jsc.make_scenario(24, 5, seed=seed, reach_m=250.0)
    ri = jsc.reach_index_map(sc.avail)
    rbk = jsc.reach_index_map(sc.avail, bucketed=True)
    for step in range(3):
        sc, delta = jsc.perturb_scenario(sc, seed=10 * seed + step, **CHURN)
        act = sc.active_mask
        for changed in (delta.stale_servers, None):
            want_ri = jsc.update_reach_index(ri, sc.avail, active=act,
                                             changed_servers=changed)
            got_ri = tsc.update_reach_index(ri, sc.avail, active=act,
                                            changed_servers=changed)
            assert want_ri[1] == got_ri[1]
            assert_same_flat(want_ri[0], got_ri[0])
            want_b = jsc.update_reach_buckets(rbk, sc.avail, active=act,
                                              changed_servers=changed)
            got_b = tsc.update_reach_buckets(rbk, sc.avail, active=act,
                                             changed_servers=changed)
            assert want_b[1] == got_b[1]
            assert_same_buckets(want_b[0], got_b[0])
        ri, rbk = want_ri[0], want_b[0]


def _synthetic():
    """Reach counts 4 / 8 / 16: binary keys 2 / 3 / 4."""
    avail = np.zeros((3, 16), dtype=bool)
    avail[0, :4] = True
    avail[1, :8] = True
    avail[2, :] = True
    return avail


def _patch(avail):
    avail[1, 7] = False          # 8 -> 7: inside key 3 and width 8


def _overflow(avail):
    avail[0, 4:6] = True         # 4 -> 6: key 2 -> 3


def _grow_flat(avail):
    avail[0, :] = True           # server 0 reaches everyone


@pytest.mark.parametrize("edit", [_patch, _overflow, _grow_flat],
                         ids=lambda f: f.__name__.strip("_"))
def test_bucket_patch_overflow_and_growth_bit_identical(edit):
    avail = _synthetic()
    ri = jsc.reach_index_map(avail)
    rbk = jsc.reach_index_map(avail, bucketed=True)
    avail2 = avail.copy()
    edit(avail2)
    want_b, carry = jsc.update_reach_buckets(rbk, avail2)
    got_b, got_carry = tsc.update_reach_buckets(rbk, avail2)
    assert carry == got_carry
    assert_same_buckets(want_b, got_b)
    want_ri, rebuilt = jsc.update_reach_index(ri, avail2)
    got_ri, got_rebuilt = tsc.update_reach_index(ri, avail2)
    assert rebuilt == got_rebuilt
    assert_same_flat(want_ri, got_ri)


def test_bucket_sentinel_growth_bit_identical():
    """The widest bucket overflows: the shared sentinel grows and stale
    sentinel entries are remapped, in both packages alike."""
    avail = np.zeros((3, 16), dtype=bool)
    avail[0, :4] = True
    avail[1, :8] = True
    avail[1, 12:] = True
    avail[2, :12] = True
    rbk = jsc.reach_index_map(avail, bucketed=True)
    avail2 = avail.copy()
    avail2[2, :] = True
    want, carry = jsc.update_reach_buckets(rbk, avail2)
    got, got_carry = tsc.update_reach_buckets(rbk, avail2)
    assert want.r_max == got.r_max == 16 > rbk.r_max
    assert carry == got_carry
    assert_same_buckets(want, got)


def test_changed_rows_bit_identical(scenario):
    rng = np.random.default_rng(1)
    eff = scenario.avail & (rng.uniform(size=scenario.avail.shape) < 0.9)
    sets = [np.flatnonzero(row) for row in scenario.avail]
    assert np.array_equal(jsc._changed_rows(eff, sets),
                          tsc._changed_rows(eff, sets))
