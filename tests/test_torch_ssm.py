"""Port parity: the Mamba2 SSD block (``repro_torch.models.ssm``) against
the JAX package's ``repro.models.ssm``.

Inputs come from numpy seeds (params from the JAX package's ``ssm_init``,
carried across leaf for leaf, with their scalars perturbed so that every
one of them matters). Both sides run on the CPU in float32, where the
port's ``ssd_state_scan`` and ``rmsnorm`` take their plain versions.
Tolerances: atol/rtol 1e-5 (chunked products and sums over up to 96
positions in another order); 1e-6 for the element-wise pieces. The chunked
scan is checked across chunk boundaries (NC = 3), with an initial state,
and with two B/C groups, where head h must read group h // (H // G).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.kernels import ssd_scan as tscan
from repro_torch.models import ssm as tssm

try:                     # the oracle; absent on a machine with only torch
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import ssm as jssm
except ImportError:
    jax = None

torch.set_num_threads(2)

TOL = 1e-5


def need_jax():
    if jax is None:
        pytest.skip("needs JAX, the oracle")


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def with_groups(cfg, groups):
    return dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, n_groups=groups))


def configs(arch="mamba2-1.3b", groups=1):
    """(JAX config, port config) of the reduced ``arch`` with ``groups``
    B/C groups."""
    return (with_groups(jget(arch).reduced(), groups),
            with_groups(tget(arch).reduced(), groups))


def ssd_inputs(b, s, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.3, (b, s, h)).astype(np.float32),
            -np.linspace(0.5, 4.0, h).astype(np.float32),
            rng.normal(size=(b, s, g, n)).astype(np.float32),
            rng.normal(size=(b, s, g, n)).astype(np.float32),
            rng.normal(size=(b, h, n, p)).astype(np.float32))


def ssm_params(jcfg, seed):
    """The JAX ``ssm_init`` params as numpy, their vectors perturbed."""
    params = jax.tree.map(np.asarray, jssm.ssm_init(jax.random.key(seed),
                                                    jcfg))
    rng = np.random.default_rng(seed)
    for name in ("conv_b", "a_log", "d_skip", "dt_bias", "norm_scale"):
        params[name] = (params[name] + 0.2 * rng.normal(
            size=params[name].shape)).astype(np.float32)
    return params


@pytest.mark.parametrize("nc,chunk,groups,with_init", [
    (1, 16, 1, False), (3, 32, 1, False), (3, 32, 1, True),
    (3, 16, 2, True), (1, 32, 2, False)])
def test_ssd_chunked_matches_jax(nc, chunk, groups, with_init):
    need_jax()
    b, h, p, n = 2, 4, 8, 6
    x, dt, a, bm, cm, init = ssd_inputs(b, nc * chunk, h, p, groups, n,
                                        nc + groups)
    init = init if with_init else None
    y, final = tssm.ssd_chunked(
        *(torch.tensor(v) for v in (x, dt, a, bm, cm)), chunk=chunk,
        initial_state=None if init is None else torch.tensor(init))
    jy, jfinal = jssm.ssd_chunked(
        *(jnp.asarray(v) for v in (x, dt, a, bm, cm)), chunk=chunk,
        initial_state=None if init is None else jnp.asarray(init))
    assert y.dtype == final.dtype == torch.float32
    assert y.shape == x.shape and final.shape == (b, h, n, p)
    close(y, jy)
    close(final, jfinal)


def test_ssd_chunked_groups_map_heads_in_blocks():
    """With G = 2 and H = 4, heads 0 and 1 read group 0 and heads 2 and 3
    group 1 (``jnp.repeat``), not h % G: swapping the groups' B and C
    swaps the two halves of the heads."""
    x, dt, a, bm, cm, _ = (torch.tensor(v) for v in ssd_inputs(
        1, 16, 4, 8, 2, 6, 11))
    a = torch.full_like(a, -1.0)
    y, _ = tssm.ssd_chunked(x, dt, a, bm, cm, chunk=16)
    half = [2, 3, 0, 1]
    y_sw, _ = tssm.ssd_chunked(x[:, :, half], dt[:, :, half], a,
                               bm.flip(2), cm.flip(2), chunk=16)
    torch.testing.assert_close(y_sw, y[:, :, half], atol=1e-6, rtol=1e-6)


def test_ssd_chunked_raises_where_jax_asserts():
    x, dt, a, bm, cm, _ = (torch.tensor(v) for v in ssd_inputs(
        1, 40, 2, 4, 1, 3, 0))
    with pytest.raises(ValueError, match="multiple"):
        tssm.ssd_chunked(x, dt, a, bm, cm, chunk=32)


def test_ssd_chunked_sends_the_recurrence_to_the_scan(monkeypatch):
    """Every ssd_chunked call runs ``ops.ssd_state_scan`` once, on the
    (NC, B, H, N, P) chunk states and (NC, B, H) decays."""
    calls = []
    real = tssm.ops.ssd_state_scan

    def spy(states, decay, initial_state=None):
        calls.append((tuple(states.shape), tuple(decay.shape),
                      initial_state is not None))
        return real(states, decay, initial_state)

    monkeypatch.setattr(tssm.ops, "ssd_state_scan", spy)
    x, dt, a, bm, cm, init = (torch.tensor(v) for v in ssd_inputs(
        2, 48, 4, 8, 2, 6, 1))
    tssm.ssd_chunked(x, dt, a, bm, cm, chunk=16, initial_state=init)
    tssm.ssd_chunked(x, dt, a, bm, cm, chunk=48)
    assert calls == [((3, 2, 4, 6, 8), (3, 2, 4), True),
                     ((1, 2, 4, 6, 8), (1, 2, 4), False)]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 1e-2)])
def test_causal_conv_matches_jax(dtype, tol):
    need_jax()
    rng = np.random.default_rng(3)
    xbc = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=12).astype(np.float32)
    got = tssm._causal_conv(*(torch.tensor(v).to(getattr(torch, dtype))
                              for v in (xbc, w, b)))
    want = jssm._causal_conv(*(jnp.asarray(v).astype(getattr(jnp, dtype))
                               for v in (xbc, w, b)))
    assert got.dtype == getattr(torch, dtype)
    close(got.float(), np.asarray(want, np.float32), tol)


def test_softplus_is_jax_softplus():
    need_jax()
    x = np.concatenate([np.linspace(-40, 40, 801),
                        [-1e4, 1e4, 0.0]]).astype(np.float32)
    close(tssm.softplus(torch.tensor(x)), jax.nn.softplus(jnp.asarray(x)),
          1e-6)


@pytest.mark.parametrize("seq,groups,with_init", [
    (32, 1, False), (96, 1, True), (96, 2, False), (13, 1, False)])
def test_ssm_apply_matches_jax(seq, groups, with_init):
    """The whole block (projections, conv, chunked scan over up to three
    chunks of 32, skip, gated norm) and its final state."""
    need_jax()
    jcfg, tcfg = configs(groups=groups)
    params = ssm_params(jcfg, seq)
    x = np.random.default_rng(seq).normal(
        size=(2, seq, jcfg.d_model)).astype(np.float32)
    s = jcfg.ssm
    h = s.expand * jcfg.d_model // s.head_dim
    init = (np.random.default_rng(1).normal(
        size=(2, h, s.state_size, s.head_dim)).astype(np.float32)
        if with_init else None)
    out, state = tssm.ssm_apply(
        convert.lm_params_from_numpy(params, "cpu"), tcfg, torch.tensor(x),
        initial_state=None if init is None else torch.tensor(init),
        return_state=True)
    jout, jstate = jssm.ssm_apply(
        params, jcfg, jnp.asarray(x),
        initial_state=None if init is None else jnp.asarray(init),
        return_state=True)
    close(out, jout)
    close(state, jstate)


def test_gated_norm_goes_through_the_rmsnorm_kernel(monkeypatch):
    """The gated RMSNorm of ssm_apply and ssm_decode is ``ops.rmsnorm`` on
    ``y * silu(z)`` of width d_inner, with the block's ``norm_scale``."""
    calls = []
    real = tssm.ops.rmsnorm

    def spy(x, scale, **kw):
        calls.append((tuple(x.shape), kw.get("eps")))
        return real(x, scale, **kw)

    monkeypatch.setattr(tssm.ops, "rmsnorm", spy)
    cfg = tget("mamba2-1.3b").reduced()
    params = tssm.ssm_init(torch.Generator().manual_seed(0), cfg)
    d_inner = cfg.ssm.expand * cfg.d_model
    tssm.ssm_apply(params, cfg, torch.randn(2, 8, cfg.d_model))
    tssm.ssm_decode(params, cfg, torch.randn(2, 1, cfg.d_model),
                    tssm.init_ssm_cache(cfg, 2))
    assert calls == [((2, 8, d_inner), 1e-6), ((2, 1, d_inner), 1e-6)]


@pytest.mark.parametrize("arch,groups", [("mamba2-1.3b", 1),
                                         ("zamba2-2.7b", 1),
                                         ("mamba2-1.3b", 2)])
def test_ssm_decode_matches_jax(arch, groups):
    """Three decode steps from a random cache: outputs and the new state
    and conv buffer (the port updates them in place)."""
    need_jax()
    jcfg, tcfg = configs(arch, groups)
    params = ssm_params(jcfg, 5)
    tparams = convert.lm_params_from_numpy(params, "cpu")
    rng = np.random.default_rng(6)
    jcache = jax.tree.map(
        lambda c: jnp.asarray(rng.normal(size=c.shape).astype(np.float32)),
        jssm.init_ssm_cache(jcfg, 2))
    tcache = {k: torch.tensor(np.asarray(v)) for k, v in jcache.items()}
    for t in range(3):
        x = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        jout, jcache = jssm.ssm_decode(params, jcfg, jnp.asarray(x), jcache)
        tout, tnew = tssm.ssm_decode(tparams, tcfg, torch.tensor(x), tcache)
        assert tnew is tcache
        close(tout, jout)
        for key in ("state", "conv"):
            close(tcache[key], jcache[key])


def test_ssm_decode_continues_ssm_apply():
    """Inside the port: the state ssm_apply returns after 32 positions,
    carried by ssm_decode over 32 more, gives ssm_apply's outputs of the
    last 32 positions of the 64 (2e-3, tests/test_models.py's bound)."""
    cfg = tget("mamba2-1.3b").reduced()
    params = tssm.ssm_init(torch.Generator().manual_seed(2), cfg)
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    full = tssm.ssm_apply(params, cfg, x)
    cache = tssm.init_ssm_cache(cfg, 2)
    steps = [tssm.ssm_decode(params, cfg, x[:, t:t + 1], cache)[0]
             for t in range(64)]
    torch.testing.assert_close(torch.cat(steps, 1), full, atol=2e-3,
                               rtol=2e-3)
    before = tscan.LAUNCHES
    _, state = tssm.ssm_apply(params, cfg, x, return_state=True)
    assert tscan.LAUNCHES == before                  # CPU: plain version
    torch.testing.assert_close(state, cache["state"], atol=2e-3, rtol=2e-3)
