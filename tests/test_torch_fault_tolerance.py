"""Port parity: ``examples/elastic_failover.py``'s flow through
``repro_torch.runtime`` against the JAX package.

The example trains HFEL for 15 rounds while a ``FailureInjector`` kills and
revives devices, and on every round with a dead device its hook
re-associates the live ones (``ElasticReassociator.on_membership_change``:
a warm ``AssociationEngine.run_batched`` on an availability matrix that pins
each dead device to its nearest server).

- The re-association events of those 15 rounds (round, live count,
  adjustments), each event's assignment, and its cost at rtol 2e-4 (the
  association tests' pin), without training.
- ``train_federated`` fed the same membership sequence through a hook,
  from JAX's omega^0 (the port draws its own): the train loss at rtol
  1e-4, accuracies to one sample, the final global params at rtol 1e-5 /
  atol 1e-6, as ``test_torch_fl.py`` holds a round.
- The entry point's device rule: ``device=None`` means CUDA and raises
  without a card.
- A warm ``run_batched`` from a given assignment on an availability
  matrix with pinned dead devices, on a second scenario seed.

The example keeps training on its initial assignment (its hook writes the
re-association into a box that nothing reads), so the trainer here does
too. ``chip_smoke.py`` phase 33 runs the same flow on the card.
"""

import functools

import numpy as np
import pytest
import torch

import repro_torch.data as tdata
import repro_torch.fl as tfl
from repro_torch import convert
from repro_torch.core import edge_association as tea
from repro_torch.runtime import ElasticReassociator, FailureInjector

try:                     # the oracle; absent on a machine with only torch
    import jax.numpy as jnp

    import repro.data as jdata
    import repro.fl as jfl
    from repro import runtime as jrt
    from repro.core import edge_association as jea
    from repro.core import scenario as jsc
except ImportError:
    jnp = None

torch.set_num_threads(2)

RTOL = 2e-4              # cost pin of the association tests
N, K, ROUNDS = 20, 4, 15             # examples/elastic_failover.py
INJECTOR = dict(p_fail=0.08, p_recover=0.4, seed=3)
TRAIN = dict(method="hfel", n_servers=K, rounds=ROUNDS, local_iters=10,
             edge_iters=5, lr=0.05, eval_every=3)


def need_jax():
    if jnp is None:
        pytest.skip("the JAX package is the oracle here")


def port_scenario(js):
    from test_torch_assoc_fast import port_scenario as convert_scenario
    return convert_scenario(js)


def alive_sequence() -> list:
    """The example's membership a round (numpy: the same in both
    packages)."""
    fi = FailureInjector(N, **INJECTOR)
    return [fi.step() for _ in range(ROUNDS)]


def events(er, alive_seq, rounds=range(ROUNDS)) -> list:
    """The example's hook without the trainer over ``rounds``: (round,
    live count, result) for every round with a dead device."""
    return [(r, int(alive_seq[r].sum()),
             er.on_membership_change(alive_seq[r]))
            for r in rounds if alive_seq[r].sum() < N]


@functools.lru_cache(maxsize=None)
def jax_events() -> tuple:
    """JAX's initial association and its events over the 15 rounds."""
    need_jax()
    er = jrt.ElasticReassociator(jsc.make_scenario(N, K, seed=0), seed=0)
    initial = er.initial()
    return initial, events(er, alive_sequence())


# the 15 rounds in four parts, each its own test (the port's plain
# golden-section solves take ~1-3 s an event on the CPU, its initial
# association ~3.5 s, JAX's 15 rounds ~7 s)
PARTS = ((0, 3), (3, 8), (8, 12), (12, ROUNDS))


@pytest.mark.parametrize("part", PARTS, ids=lambda p: "rounds%d_%d" % p)
def test_failure_events_match_jax(part):
    """The example's failures over rounds ``part``: the port's
    re-associations give JAX's events, assignments and costs. A later part
    warm-starts from JAX's last event before it (where the previous part
    holds the port equal to JAX); the first from the port's own initial
    association, held to JAX's."""
    want_init, want_all = jax_events()
    js = jsc.make_scenario(N, K, seed=0)
    alive_seq = alive_sequence()
    er = ElasticReassociator(port_scenario(js), seed=0, device="cpu")
    if part[0] == 0:
        got_init = er.initial()
        assert np.array_equal(got_init.assignment, want_init.assignment)
        assert got_init.total_cost == pytest.approx(want_init.total_cost,
                                                    rel=RTOL)
    else:
        er.current = [e for e in want_all if e[0] < part[0]][-1][2]
    got = events(er, alive_seq, range(*part))
    want = [e for e in want_all if part[0] <= e[0] < part[1]]
    assert [e[:2] + (e[2].n_adjustments,) for e in got] == [
        e[:2] + (e[2].n_adjustments,) for e in want]
    assert want and len(want_all) >= 10   # an eventful run
    nearest = np.argmin(js.dist, axis=0)
    for (r, _, g), (_, _, w) in zip(got, want):
        alive = alive_seq[r]
        assert np.array_equal(g.assignment, w.assignment), r
        assert g.total_cost == pytest.approx(w.total_cost, rel=RTOL)
        assert g.true_cost == pytest.approx(w.true_cost, rel=RTOL)
        # the dead sit on their nearest server, the live where they reach
        assert np.array_equal(g.assignment[~alive], nearest[~alive])
        assert js.avail[g.assignment[alive], np.flatnonzero(alive)].all()


class _Membership:
    """Round policy: JAX's omega^0 before round 0, then each round's
    membership as the trainer's client mask; the assignment is kept."""

    def __init__(self, omega0, alive_seq):
        self.omega0, self.alive_seq, self.trainer = omega0, alive_seq, None

    def begin_round(self, trainer, r):
        if r == 0:
            trainer.client_params = convert.fl_params_from_numpy(
                self.omega0, trainer.ds.n_clients, device="cpu")
        trainer.client_mask = self.alive_seq[r]
        self.trainer = trainer
        return None


def test_training_under_failures_matches_jax():
    """The example's 15 HFEL rounds under its failure sequence, from
    JAX's omega^0, on the example's initial association."""
    want_init, _ = jax_events()
    alive_seq = alive_sequence()
    jds = jdata.make_mnist_like(N, seed=0)
    kept = {}

    def hook(trainer, r):
        trainer.client_mask = jnp.asarray(alive_seq[r])
        kept["trainer"] = trainer

    want = jfl.train_federated(jds, assignment=want_init.assignment,
                               round_hook=hook, **TRAIN)
    omega0 = {k: np.asarray(v) for k, v in jfl.FederatedTrainer(
        jds, lr=0.05).global_params().items()}
    policy = _Membership(omega0, alive_seq)
    got = tfl.train_federated(tdata.make_mnist_like(N, seed=0),
                              assignment=want_init.assignment,
                              round_hook=policy, device="cpu", **TRAIN)
    assert got.eval_rounds == want.eval_rounds == [0, 3, 6, 9, 12, 14]
    np.testing.assert_allclose(got.train_loss, want.train_loss, rtol=1e-4)
    one = 1.0 / len(jds.test_y) + 1e-6
    assert np.abs(np.subtract(got.test_acc, want.test_acc)).max() <= one
    assert np.abs(np.subtract(got.train_acc, want.train_acc)).max() <= (
        1.0 / jds.client_sizes.sum() + 1e-6)
    want_p = kept["trainer"].global_params()
    for key, value in policy.trainer.global_params().items():
        np.testing.assert_allclose(value.numpy(), np.asarray(want_p[key]),
                                   rtol=1e-5, atol=1e-6)
    # the dead clients of the last round were masked, not dropped
    assert not policy.trainer.client_mask.numpy().all()


def test_reassociator_needs_a_card_by_default(monkeypatch):
    """``device=None`` means CUDA: without a card the first association
    raises, as every entry point of the port does."""
    from repro_torch.core.scenario import make_scenario
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    er = ElasticReassociator(make_scenario(6, 2, seed=0, device="cpu"))
    assert er.device is None
    with pytest.raises(RuntimeError, match="CUDA"):
        er.initial()
    with pytest.raises(RuntimeError, match="CUDA"):
        er.on_membership_change(np.ones(6, bool))


def test_warm_run_batched_with_pinned_dead_devices_matches_jax():
    """``run_batched(assignment=warm)`` on a second seed's scenario with
    three devices dead: only their nearest server is available to them and
    they start there, the live ones from JAX's stable point. The same
    moves, assignment and costs."""
    need_jax()
    js = jsc.make_scenario(16, 4, seed=5)
    stable = jea.AssociationEngine(js, kind="fast", seed=5).run_batched(
        "random")
    dead = np.zeros(16, bool)
    dead[[1, 7, 12]] = True
    nearest = np.argmin(js.dist, axis=0)
    avail = js.avail.copy()
    avail[:, dead] = False
    avail[nearest[dead], dead] = True
    warm = stable.assignment.copy()
    warm[dead] = nearest[dead]
    pinned = jsc.make_scenario(16, 4, seed=5)
    pinned.avail = avail
    want = jea.AssociationEngine(pinned, kind="fast", seed=5).run_batched(
        assignment=warm)
    got = tea.AssociationEngine(port_scenario(pinned), kind="fast", seed=5,
                                device="cpu").run_batched(assignment=warm)
    assert np.array_equal(got.assignment, want.assignment)
    assert got.n_adjustments == want.n_adjustments > 0
    assert got.total_cost == pytest.approx(want.total_cost, rel=RTOL)
    assert got.true_cost == pytest.approx(want.true_cost, rel=RTOL)
    np.testing.assert_allclose(got.cost_trace, want.cost_trace, rtol=RTOL)
    assert np.array_equal(got.assignment[dead], nearest[dead])
    assert got.total_cost <= got.cost_trace[0]
