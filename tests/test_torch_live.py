"""Port parity: the live HFEL co-simulation (``repro_torch.fl.live``).

``run_live`` at N = 40 / K = 4, 2 rounds, ``verify=True`` (the JAX live
benchmark's quick smoke) swaps at the rounds JAX swaps at, to JAX's
assignments, with per-round eq.-(17) costs at rtol 2e-4, and inside the
port the warm and cold policies swap identically. The streaming-admission
cases of ``tests/test_live_hfel.py`` (queue fills and drains, the overflow
bound) give JAX's per-round admission counts and swaps, and the history's
round-indexed lists keep their length across ``eval_every``."""

import dataclasses

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

from repro.core import scenario as jsc
from repro.data import make_mnist_like as jax_mnist
from repro.fl import live as jlive
from repro_torch.core import assoc_fast as taf
from repro_torch.data import make_mnist_like
from repro_torch.fl import live as tlive

from test_torch_assoc_fast import port_scenario

torch.set_num_threads(2)

RTOL = 2e-4
N, K = 16, 3
CHURN = dict(drift_m=60.0, move_frac=0.2, flip_frac=0.1, depart_frac=0.15,
             arrive_frac=0.5)
ADMIT_CHURN = dict(drift_m=60.0, move_frac=0.2, flip_frac=0.1,
                   depart_frac=0.25, arrive_frac=0.5)
QUICK = dict(rounds=2, resolve_every=1, churn=tlive.DEFAULT_CHURN, seed=0,
             local_iters=1, edge_iters=1, profile="coarse", rel_tol=1e-3,
             verify=True)


@pytest.fixture(scope="module")
def quick():
    """The JAX quick smoke in both packages, and the port's cold policy."""
    js = jsc.make_large_scenario(40, 4, seed=0)
    ts = port_scenario(js)
    want = jlive.run_live(js, jax_mnist(40, samples_total=800, seed=0),
                          policy="incremental-warm", **QUICK)
    ds = make_mnist_like(40, samples_total=800, seed=0)
    got = tlive.run_live(ts, ds, policy="incremental-warm", device="cpu",
                         **QUICK)
    cold = tlive.run_live(ts, ds, policy="periodic-cold", device="cpu",
                          **{**QUICK, "verify": False})
    return js, ts, want, got, cold


def test_quick_smoke_swaps_like_jax(quick):
    _, _, want, got, _ = quick
    assert got.swap_rounds == want.swap_rounds == [0, 1]
    assert sum(got.swapped) == 2 and got.rounds == 2
    for a, b in zip(want.swap_assignments, got.swap_assignments):
        assert np.array_equal(a, b)
    assert got.moves == want.moves
    np.testing.assert_allclose(got.system_cost, want.system_cost, rtol=RTOL)
    np.testing.assert_allclose(got.system_energy, want.system_energy,
                               rtol=RTOL)
    np.testing.assert_allclose(got.system_delay, want.system_delay,
                               rtol=RTOL)
    for name in ("n_active", "n_arrived", "n_departed", "n_queued",
                 "n_admitted", "n_rejected"):
        assert getattr(got, name) == getattr(want, name), name


def test_warm_and_cold_swap_identically_in_the_port(quick):
    _, _, _, warm, cold = quick
    assert warm.swap_rounds == cold.swap_rounds
    for a, b in zip(warm.swap_assignments, cold.swap_assignments):
        assert np.array_equal(a, b)
    np.testing.assert_allclose(warm.system_cost, cold.system_cost,
                               rtol=1e-6)


def test_per_round_cost_is_the_standalone_evaluator(quick):
    _, ts, _, got, _ = quick
    e, t, c = taf.assignment_true_cost(ts, got.swap_assignments[0],
                                       device="cpu")
    assert got.system_cost[0] == pytest.approx(c, rel=1e-6)
    assert got.system_energy[0] == pytest.approx(e, rel=1e-6)
    assert got.system_delay[0] == pytest.approx(t, rel=1e-6)
    d = got.as_dict()
    assert d["cumulative_cost"] == pytest.approx(sum(d["system_cost"]))
    assert d["n_queued"] == [0, 0] and d["n_rejected"] == [0, 0]


class _FakeTrainer:
    """The trainer surface ``begin_round`` touches: the mask attribute and
    the arrival re-admission hook."""
    client_mask = None

    def __init__(self):
        self.readmits = []

    def readmit_clients(self, mask, assign, k):
        self.readmits.append(np.asarray(mask).copy())


def _admission_runs(caps, policy, rounds, **kw):
    js = dataclasses.replace(jsc.make_large_scenario(N, K, seed=0),
                             max_devices=np.asarray(caps, np.int64))
    out = []
    for pkg, sc, opts in ((jlive, js, {}),
                          (tlive, port_scenario(js), {"device": "cpu"})):
        runner = pkg.LiveHFELRunner(sc, N, policy=policy, churn=ADMIT_CHURN,
                                    seed=0, **kw, **opts)
        tr = _FakeTrainer()
        loads = []
        for rd in range(rounds):
            runner.begin_round(tr, rd)
            loads.append(np.bincount(
                runner.assignment[runner.sc.active_mask], minlength=K))
            assert not runner.sc.active_mask[runner._queue].any()
        out.append((runner, tr, loads))
    return out


def test_admission_queue_fills_and_drains_like_jax():
    caps = np.array([4, 4, 4])
    (jr, jtr, _), (tr_, ttr, loads) = _admission_runs(
        caps, "incremental-warm", 8, resolve_every=2, exchange_samples=0)
    for rd, load in enumerate(loads):
        assert (load <= caps).all(), f"cap exceeded at round {rd}: {load}"
    h, want = tr_.history, jr.history
    assert h.n_queued[0] > 0
    assert h.n_active[0] == N - h.n_queued[0]
    assert sum(h.n_admitted) > 0
    assert len(ttr.readmits) == sum(1 for a in h.n_admitted if a > 0)
    assert sum(h.n_rejected) == 0
    for name in ("n_queued", "n_admitted", "n_rejected", "n_active",
                 "swap_rounds", "moves"):
        assert getattr(h, name) == getattr(want, name), name
    for a, b in zip(want.swap_assignments, h.swap_assignments):
        assert np.array_equal(a, b)
    for a, b in zip(jtr.readmits, ttr.readmits):
        assert np.array_equal(a, b)
    np.testing.assert_allclose(h.system_cost, want.system_cost, rtol=RTOL)


def test_admission_overflow_bound_rejects_oldest():
    (jr, _, _), (tr_, _, _) = _admission_runs([4, 4, 4], "static", 2,
                                              overflow_max=0)
    h = tr_.history
    assert h.n_queued == [0, 0]
    assert h.n_rejected[0] > 0
    assert h.n_rejected == jr.history.n_rejected
    sc = port_scenario(jsc.make_large_scenario(N, K, seed=0))
    with pytest.raises(ValueError, match="overflow_max"):
        tlive.LiveHFELRunner(sc, N, overflow_max=-1, device="cpu")


@pytest.mark.parametrize("eval_every", [1, 2, 3])
def test_history_lengths_stable_across_eval_every(eval_every):
    sc = port_scenario(jsc.make_large_scenario(N, K, seed=0))
    ds = make_mnist_like(N, samples_total=400, seed=0)
    h = tlive.run_live(sc, ds, policy="incremental-warm", rounds=5,
                       resolve_every=2, churn=CHURN, seed=0, local_iters=1,
                       edge_iters=1, eval_every=eval_every,
                       exchange_samples=0, device="cpu")
    for name in ("system_cost", "system_energy", "system_delay",
                 "assoc_seconds", "swapped", "moves", "n_active",
                 "n_arrived", "n_departed", "n_queued", "n_admitted",
                 "n_rejected"):
        assert len(getattr(h, name)) == 5, name
    expect = sorted(set(range(0, 5, eval_every)) | {4})
    assert h.train.eval_rounds == expect
    for name in ("test_acc", "train_acc", "train_loss"):
        assert len(getattr(h.train, name)) == len(expect), name
    assert len(h.swap_rounds) == len(h.swap_assignments) == sum(h.swapped)
    assert h.swap_rounds == [0, 2, 4]
    assert set(h.as_dict()["train"]) == {"test_acc", "train_acc",
                                         "train_loss", "eval_rounds"}
    assert h.assoc_seconds_total == pytest.approx(sum(h.assoc_seconds))


def test_runner_rejects_bad_config_and_releases_the_engine():
    sc = port_scenario(jsc.make_large_scenario(N, K, seed=0))
    with pytest.raises(ValueError):
        tlive.LiveHFELRunner(sc, N, policy="nope", device="cpu")
    with pytest.raises(ValueError):
        tlive.LiveHFELRunner(sc, N, resolve_every=0, device="cpu")
    with pytest.raises(ValueError, match="maps 5 clients"):
        tlive.LiveHFELRunner(sc, 10, device="cpu",
                             bridge=tlive.device_client_bridge(sc, 5))
    with pytest.raises(ValueError, match="shards"):
        tlive.LiveHFELRunner(sc, N, shards=0, device="cpu")
    runner = tlive.LiveHFELRunner(sc, N, policy="static", churn=CHURN,
                                  seed=0, device="cpu")
    runner.begin_round(_FakeTrainer(), 0)
    assert runner.engine is None
    assert tlive.POLICIES == jlive.POLICIES
    assert tlive.DEFAULT_CHURN == jlive.DEFAULT_CHURN


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    sc = port_scenario(jsc.make_large_scenario(N, K, seed=0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlive.LiveHFELRunner(sc, N)
