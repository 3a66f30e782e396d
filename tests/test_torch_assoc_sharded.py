"""Port parity: the sharded association sweep (``shards=p``).

One process drives ``p`` shards; on the CPU every shard lives on the CPU
(the counterpart of JAX's forced host devices), and each shard's solves
run the golden-section kernel's plain version. The contract is the
reference's: at every ``p`` (1-4, more shards than a bucket has rows
included) the moves, the per-move cost trace, the stable point and the
dumped caches are those of ``shards=None``, bit for bit, in the dense,
flat and bucketed spaces, with and without sampled exchanges, cold and
warm, and in the live loop; and the sharded port lands on JAX's
``shards=None`` stable point. Engine-internal fixtures run at the coarse
profile to keep the plain solves short; the JAX comparison runs at the
default one, as ``tests/test_assoc_sharded.py`` does."""

import functools

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

from repro.core import assoc_fast as jaf
from repro.core import scenario as jsc
from repro_torch.core import assoc_fast as taf
from repro_torch.core import prng
from repro_torch.core import resource_allocation as ra
from repro_torch.core import scenario as tsc
from repro_torch.core.edge_association import solve_groups
from repro_torch.data import make_mnist_like
from repro_torch.fl import live as tlive

from test_torch_assoc_fast import port_scenario

torch.set_num_threads(2)

SPACES = {"dense": False, "flat": True, "bucketed": "bucketed"}
PARITY_CASES = [(14, 3, 0), (18, 4, 1)]
CACHE_KEYS = ("toggle_cost", "toggle_cost_compact", "toggle_cost_buckets")


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def engine(sc, compact, shards=None, **opts):
    opts.setdefault("profile", "coarse")
    return taf.FastAssociationEngine(sc, seed=0, compact=compact,
                                     shards=shards, device="cpu", **opts)


def assert_same_caches(want: dict, got: dict):
    """``last_state`` of two engines: membership and every cache, bitwise."""
    assert np.array_equal(want["member"], got["member"])
    assert np.array_equal(bits(want["cur_cost"]), bits(got["cur_cost"]))
    for key in CACHE_KEYS:
        assert (key in want) == (key in got), key
        if key not in want:
            continue
        w, g = want[key], got[key]
        w, g = (w, g) if isinstance(w, list) else ([w], [g])
        assert len(w) == len(g)
        for a, b in zip(w, g):
            assert a.shape == b.shape and np.array_equal(bits(a), bits(b))


def assert_same_run(want, got):
    assert np.array_equal(want.assignment, got.assignment)
    assert want.n_adjustments == got.n_adjustments
    assert want.cost_trace == got.cost_trace          # per move, bitwise
    assert want.total_cost == got.total_cost


@functools.lru_cache(maxsize=None)
def unsharded(space: str, n: int, k: int, seed: int, samples: int):
    """``shards=None`` on ``make_scenario(n, k, seed, reach_m=300)``:
    (scenario, result, last_state, last_counts)."""
    sc = tsc.make_scenario(n, k, seed=seed, reach_m=300.0, device="cpu")
    eng = engine(sc, SPACES[space])
    res = eng.run("nearest", exchange_samples=samples)
    return sc, res, eng.last_state, eng.last_counts


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
@pytest.mark.parametrize("space", list(SPACES))
def test_sharded_transfers_identical_to_unsharded(space, shards):
    """Transfers only on (14, 3, 0): every p matches ``shards=None`` in
    assignment, moves, trace and caches; the shards partition every
    bucket's rows (p = 4 exceeds K = 3, so some shards hold nothing)."""
    sc, want, state, _ = unsharded(space, 14, 3, 0, 0)
    eng = engine(sc, SPACES[space], shards)
    got = eng.run("nearest", exchange_samples=0)
    assert_same_run(want, got)
    assert_same_caches(state, eng.last_state)
    assert eng.shards == shards and len(eng._shards) == shards
    for b, bd in enumerate(eng._buckets):
        spans = [sh.spans[b] for sh in eng._shards]
        assert spans[0][0] == 0 and spans[-1][1] == bd.servers.shape[0]
        assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))
        per = -(-bd.servers.shape[0] // shards)
        assert all(hi - lo <= per for lo, hi in spans)
    assert sorted(np.bincount(eng._owner, minlength=shards)) == sorted(
        sum(sh.spans[b][1] - sh.spans[b][0] for b in range(len(eng._buckets)))
        for sh in eng._shards)
    if shards > sc.n_servers:
        assert any(sh.size == 0 for sh in eng._shards)


@pytest.mark.parametrize("n,k,seed", PARITY_CASES)
def test_sharded_lands_on_jax_stable_point(n, k, seed):
    """The bucketed sweep at p = 3 against JAX's ``shards=None``, default
    profile: the same assignment and moves, costs at rtol 2e-4."""
    js = jsc.make_scenario(n, k, seed=seed, reach_m=300.0)
    want = jaf.FastAssociationEngine(js, kind="fast", seed=0,
                                     compact="bucketed").run(
        "nearest", exchange_samples=0)
    got = taf.FastAssociationEngine(port_scenario(js), seed=0,
                                    compact="bucketed", shards=3,
                                    device="cpu").run(
        "nearest", exchange_samples=0)
    assert np.array_equal(want.assignment, got.assignment)
    assert want.n_adjustments == got.n_adjustments
    assert got.total_cost == pytest.approx(want.total_cost, rel=2e-4)


EXCHANGE_MATRIX = [(space, p, s) for space in SPACES for p in (1, 3, 4)
                   for s in (8, 64)]


@pytest.mark.parametrize("space,shards,samples", EXCHANGE_MATRIX,
                         ids=[f"{c}-p{p}-ex{s}" for c, p, s in
                              EXCHANGE_MATRIX])
def test_sharded_exchange_matrix(space, shards, samples):
    """Sampled exchanges on (16, 4, 1), where transfers alone stall: the
    chunked pricing and the (delta, sample index) fold reproduce the
    unsharded exchange sequence: moves, transfers, exchanges, exchange
    rounds and the trace."""
    sc, want, state, counts = unsharded(space, 16, 4, 1, samples)
    assert counts["exchange_rounds"] >= 1
    eng = engine(sc, SPACES[space], shards)
    got = eng.run("nearest", exchange_samples=samples)
    assert_same_run(want, got)
    assert eng.last_counts == counts
    assert_same_caches(state, eng.last_state)


def test_exchanges_fire_in_the_matrix():
    """The matrix's geometry applies exchanges: with 64 samples the
    descent moves past the transfer-only stable point."""
    for space in SPACES:
        _, with_ex, _, counts = unsharded(space, 16, 4, 1, 64)
        _, without, _, _ = unsharded(space, 16, 4, 1, 0)
        assert counts["exchanges"] >= 1
        assert with_ex.total_cost < without.total_cost


WARM_SC = dict(n_devices=120, n_servers=6, seed=5)


@functools.lru_cache(maxsize=None)
def cold_engine(samples: int, shards):
    """The bucketed engine at ``shards`` on ``make_large_scenario(120, 6,
    seed=5)`` after its cold run, and the run's result."""
    sc = tsc.make_large_scenario(**WARM_SC, device="cpu")
    eng = engine(sc, "bucketed", shards)
    return eng, eng.run("nearest", exchange_samples=samples)


@pytest.mark.parametrize("samples", [0, 64])
def test_unsharded_cold_before_churn(samples):
    _, res = cold_engine(samples, None)
    assert np.all(np.diff(res.cost_trace) <= 0) and res.n_adjustments > 0


@pytest.mark.parametrize("samples", [0, 64])
def test_sharded_cold_before_churn(samples):
    assert_same_run(cold_engine(samples, None)[1],
                    cold_engine(samples, 3)[1])


@pytest.mark.parametrize("samples", [0, 64])
def test_sharded_warm_rerun_parity(samples):
    """``rerun_incremental`` at p = 3 after a churn tick: the unsharded
    warm rerun's moves, trace, stable point and caches, and its own
    cold-rebuild gate (``verify=True``) passes."""
    classic, sharded = cold_engine(samples, None)[0], cold_engine(samples, 3)[0]
    sc = classic.sc
    sc2, delta = tsc.perturb_scenario(sc, seed=6, drift_m=60.0,
                                      move_frac=0.05, flip_frac=0.02,
                                      depart_frac=0.02)
    want = classic.rerun_incremental(sc2, delta, exchange_samples=samples)
    got = sharded.rerun_incremental(sc2, delta, exchange_samples=samples,
                                    verify=True)
    assert_same_run(want, got)
    assert classic.last_counts == sharded.last_counts
    assert sharded.last_counts["init_rows"] > 0
    assert_same_caches(classic.last_state, sharded.last_state)
    for a, b in zip(classic._warm_cache["toggles"],
                    sharded._warm_cache["toggles"]):
        assert np.array_equal(bits(a), bits(b))


def test_sharded_run_tiered_identical():
    sc, _, _, _ = unsharded("bucketed", 16, 4, 1, 0)
    want = engine(sc, "bucketed").run_tiered(exchange_samples=8)
    eng = engine(sc, "bucketed", 2)
    got = eng.run_tiered(exchange_samples=8)
    assert_same_run(want, got)
    assert eng.last_tier_moves is not None


def test_sharded_constructor_validation(monkeypatch):
    sc = tsc.make_scenario(8, 2, seed=0, device="cpu")
    for bad in (0, -1, 2.5, True):
        with pytest.raises(ValueError):
            engine(sc, False, bad)
    with pytest.raises(ValueError, match="shard_devices"):
        taf.FastAssociationEngine(sc, shards=3, shard_devices=["cpu"] * 2,
                                  device="cpu")
    eng = taf.FastAssociationEngine(sc, shard_devices=["cpu"] * 2,
                                    device="cpu")
    assert eng.shards == 2 and len(eng._shards) == 2
    # more CPU shards than servers build (some hold nothing)
    assert len(engine(sc, False, 5)._shards) == 5
    assert taf.FastAssociationEngine(sc, device="cpu").shards is None
    # on the card, p takes the first p cards and refuses more than exist
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = torch.device("cuda")
    assert taf._shard_devices(2, None, cuda) == (
        2, (torch.device("cuda", 0), torch.device("cuda", 1)))
    with pytest.raises(ValueError, match="only 2 CUDA"):
        taf._shard_devices(3, None, cuda)
    assert taf._shard_devices(None, None, cuda) == (None, (cuda,))


@pytest.mark.parametrize("shards", [2, 3, 4])
@pytest.mark.parametrize("profile", ["coarse", "default"])
def test_golden_section_group_bits_independent_of_batch(profile, shards):
    """A group's plain golden-section cost has the same bits in the whole
    2S exchange batch and in the 2S/p chunk a shard prices (its ``si`` and
    ``sj`` halves together), which the exchange fold relies on."""
    sc, res, _, _ = unsharded("flat", 16, 4, 1, 0)
    eng = engine(sc, True)
    assign = np.asarray(res.assignment)
    member = torch.as_tensor(eng._member_of(assign))
    s = 64
    _, sub = prng.split(prng.PRNGKey(0))
    pairs = prng.randint(sub, (s, 2), 0, sc.n_devices)
    rows, masks, _ = eng._exchange_groups(member, torch.as_tensor(assign),
                                          pairs)
    ex = eng._ex_bucket

    def costs(sel):
        return solve_groups("fast", ex.consts.rows(rows[sel]), masks[sel],
                            profile=profile).cost

    whole = costs(torch.arange(2 * s))
    chunk = -(-s // shards)
    for lo in range(0, s, chunk):
        hi = min(lo + chunk, s)
        sel = torch.cat([torch.arange(lo, hi), torch.arange(s + lo, s + hi)])
        assert np.array_equal(bits(costs(sel)), bits(whole[sel]))
    assert ra.SCREEN_PROFILES[profile]


LIVE_N, LIVE_K = 16, 3
LIVE_CHURN = dict(drift_m=60.0, move_frac=0.2, flip_frac=0.1,
                  depart_frac=0.15, arrive_frac=0.5)
LIVE = dict(rounds=3, resolve_every=1, churn=LIVE_CHURN, seed=0,
            local_iters=1, edge_iters=1)


@functools.lru_cache(maxsize=None)
def live_inputs():
    return (tsc.make_large_scenario(LIVE_N, LIVE_K, seed=0, device="cpu"),
            make_mnist_like(LIVE_N, samples_total=400, seed=0))


@functools.lru_cache(maxsize=None)
def live_unsharded():
    sc, ds = live_inputs()
    return tlive.run_live(sc, ds, policy="incremental-warm", device="cpu",
                          **LIVE)


@pytest.mark.parametrize("shards", [1, 3])
def test_live_sharded_swaps_like_unsharded(shards):
    """``shards`` reaches every engine the live policies build, and a
    sharded live run (64 exchanges, the default; verify on at p = 3)
    swaps to the unsharded run's assignments every round."""
    sc, ds = live_inputs()
    runner = tlive.LiveHFELRunner(sc, LIVE_N, shards=shards, device="cpu")
    eng = runner._new_engine(sc)
    assert eng.shards == shards and len(eng._shards) == shards
    want = live_unsharded()
    got = tlive.run_live(sc, ds, policy="incremental-warm", device="cpu",
                         shards=shards, verify=shards > 1, **LIVE)
    assert got.swap_rounds == want.swap_rounds
    assert len(got.swap_rounds) == LIVE["rounds"]
    for r, a, b in zip(want.swap_rounds, want.swap_assignments,
                       got.swap_assignments):
        assert np.array_equal(a, b), f"sharded swap diverged at round {r}"
    assert got.moves == want.moves
    assert got.system_cost == want.system_cost
