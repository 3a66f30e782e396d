"""Port parity: the cost model of ``repro_torch`` (eqs. (3)-(17), the
Section-III constants and the problem-(18) objective) matches the JAX
package's to rtol 1e-6 (elementwise float32 arithmetic in the same order;
the masked sums may add in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.core import scenario as jsc
from repro_torch import convert
from repro_torch.core import cost_model as tcm

torch.set_num_threads(2)
RTOL = 1e-6


def _fields(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _pair(n=24, k=4, seed=0):
    js = jsc.make_scenario(n, k, seed=seed)
    ts = convert.scenario_from_numpy(
        {"dev": _fields(js.dev), "srv": _fields(js.srv), "avail": js.avail,
         "dist": js.dist, "lp": dataclasses.asdict(js.lp)}, device="cpu")
    return js, ts


def _close(t, j):
    np.testing.assert_allclose(t.cpu().numpy(), np.asarray(j), rtol=RTOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ra_constants_match(seed):
    js, ts = _pair(seed=seed)
    batched = tcm.ra_constants(ts.dev, ts.srv.bandwidth[:, None],
                               ts.srv.noise[:, None], ts.lp)
    for i in range(js.n_servers):
        cj = jcm.ra_constants(js.dev, js.srv.bandwidth[i], js.srv.noise[i],
                              js.lp)
        ct = tcm.ra_constants(ts.dev, ts.srv.bandwidth[i], ts.srv.noise[i],
                              ts.lp)
        for name in ("a", "b", "d", "e", "w", "f_min", "f_max"):
            _close(getattr(ct, name), getattr(cj, name))
            _close(getattr(batched, name)[i], getattr(cj, name))
        assert ct.w.shape == () and batched.w.shape == (js.n_servers,)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ra_objective_matches(seed):
    js, ts = _pair(seed=seed)
    cj = jcm.ra_constants(js.dev, js.srv.bandwidth[0], js.srv.noise[0], js.lp)
    rng = np.random.default_rng(seed)
    f = rng.uniform(1e9, 1e10, 24).astype(np.float32)
    beta = rng.uniform(0.01, 0.2, 24).astype(np.float32)
    mask = rng.uniform(size=24) < 0.6
    ct = convert.ra_constants_from_numpy(_fields(cj), device="cpu")
    got = tcm.ra_objective(ct, torch.as_tensor(mask), torch.as_tensor(f),
                           torch.as_tensor(beta))
    want = jcm.ra_objective(cj, jnp.asarray(mask), jnp.asarray(f),
                            jnp.asarray(beta))
    _close(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_global_cost_matches(seed):
    js, ts = _pair(seed=seed)
    rng = np.random.default_rng(seed + 10)
    assignment = rng.integers(0, js.n_servers, 24)
    f = rng.uniform(1e9, 1e10, 24).astype(np.float32)
    beta = rng.uniform(0.01, 0.3, 24).astype(np.float32)
    want = jcm.global_cost(js.dev, js.srv, jnp.asarray(assignment),
                           jnp.asarray(f), jnp.asarray(beta), js.lp)
    got = tcm.global_cost(ts.dev, ts.srv, torch.as_tensor(assignment),
                          torch.as_tensor(f), torch.as_tensor(beta), ts.lp)
    for g, w in zip(got, want):
        _close(g, w)
    _close(tcm.cloud_delay(ts.srv), jcm.cloud_delay(js.srv))
    _close(tcm.cloud_energy(ts.srv), jcm.cloud_energy(js.srv))


def test_learning_params_match():
    for kw in ({}, {"theta": 0.3, "epsilon": 0.05}):
        assert tcm.LearningParams(**kw).local_iters == \
            jcm.LearningParams(**kw).local_iters
        assert tcm.LearningParams(**kw).edge_iters == \
            jcm.LearningParams(**kw).edge_iters
    assert jax.config.jax_enable_x64 is False


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edge_energy_delay_cost_match(seed):
    """Eqs. (10)-(11) and C_i: one server's group, one masked sum or max
    each, at rtol 1e-6; a batch of every server's group at once too."""
    js, ts = _pair(seed=seed)
    rng = np.random.default_rng(seed + 20)
    f = rng.uniform(1e9, 1e10, 24).astype(np.float32)
    beta = rng.uniform(0.01, 0.3, 24).astype(np.float32)
    assignment = rng.integers(0, js.n_servers, 24)
    names = ("edge_energy", "edge_delay", "edge_cost")
    for i in range(js.n_servers):
        mask = assignment == i
        args = (jnp.asarray(mask), jnp.asarray(f), jnp.asarray(beta),
                js.srv.bandwidth[i], js.srv.noise[i], js.lp)
        targs = (torch.as_tensor(mask), torch.as_tensor(f),
                 torch.as_tensor(beta), ts.srv.bandwidth[i],
                 ts.srv.noise[i], ts.lp)
        for name in names:
            _close(getattr(tcm, name)(ts.dev, *targs),
                   getattr(jcm, name)(js.dev, *args))
    masks = torch.as_tensor(assignment[None, :] == np.arange(4)[:, None])
    for name in names:
        batch = getattr(tcm, name)(ts.dev, masks, torch.as_tensor(f),
                                   torch.as_tensor(beta),
                                   ts.srv.bandwidth[:, None],
                                   ts.srv.noise[:, None], ts.lp)
        want = [getattr(jcm, name)(js.dev, jnp.asarray(assignment == i),
                                   jnp.asarray(f), jnp.asarray(beta),
                                   js.srv.bandwidth[i], js.srv.noise[i],
                                   js.lp) for i in range(4)]
        _close(batch, np.asarray(want))
