"""Port parity: the MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``.

Inputs come from numpy seeds; the JAX package's ``moe_init`` params are
carried across leaf for leaf. Both sides run on the CPU in float32.
Tolerance 1e-5 for the output and the aux loss (the same products in
another summation order). The routing is held exactly: the top-k ids
and their order against ``lax.top_k``, and the (token, expert) pairs
kept and dropped against the JAX function's own sort-based slots, at the
reduced config's capacity factor of 1.25 and at 0.5, where pairs
certainly drop.

The card's test (``gpu``, skipped here) runs ``moe_apply`` at the full
deepseek-v2-lite width under ``torch.cuda.set_sync_debug_mode("error")``:
no step of it may synchronise with the host. A machine with a card may
have no JAX: there the oracle tests skip, e.g. ``PYTHONPATH=src python
-m pytest --noconftest -m gpu tests/test_torch_moe.py``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.models import moe as tmoe
from repro_torch.utils import tree_map

try:                     # the oracle; absent on a machine with only torch
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import moe as jmoe
except ImportError:
    jax = None

torch.set_num_threads(2)

ARCHS = ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"]
TOL = 1e-5


def need_jax():
    if jax is None:
        pytest.skip("needs JAX, the oracle")


def with_cf(cfg, cf):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def jax_kept(ids, cap):
    """The pairs the JAX package keeps: its slots (``repro/models/moe.py``'s
    stable argsort and ``searchsorted(side="left")``) under ``cap``."""
    flat = jnp.asarray(ids).reshape(-1)
    tk = flat.shape[0]
    order = jnp.argsort(flat, stable=True)
    sorted_ids = flat[order]
    pos = jnp.arange(tk) - jnp.searchsorted(sorted_ids, sorted_ids,
                                            side="left")
    slot = jnp.zeros(tk, jnp.int32).at[order].set(pos.astype(jnp.int32))
    return np.asarray(slot), np.asarray(slot < cap)


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, cf):
    """``moe_apply``'s output and aux loss at 1e-5, with the same pairs
    kept and dropped (some drop at 0.5, asserted)."""
    need_jax()
    jcfg = with_cf(jget(arch).reduced(), cf)
    tcfg = with_cf(tget(arch).reduced(), cf)
    params = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.key(3), jcfg))
    x = np.random.default_rng(11).normal(size=(2, 16, jcfg.d_model)).astype(
        np.float32)
    want, want_aux = jmoe.moe_apply(params, jcfg, jnp.asarray(x))
    tparams = convert.lm_params_from_numpy(params, "cpu")
    got, got_aux = tmoe.moe_apply(tparams, tcfg, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), atol=TOL,
                               rtol=TOL)

    # the routing: top-k ids, the capacity and the kept pairs
    probs = jax.nn.softmax(jnp.asarray(x).reshape(32, -1)
                           @ jnp.asarray(params["router"]["w"]), axis=-1)
    _, jids = jax.lax.top_k(probs, jcfg.moe.top_k)
    tprobs = torch.softmax(torch.tensor(x).reshape(32, -1)
                           @ tparams["router"]["w"], dim=-1)
    _, tids = torch.topk(tprobs, tcfg.moe.top_k, dim=-1)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    cap = tmoe.capacity(tcfg, 32)
    assert cap == max(int(math.ceil(32 * jcfg.moe.top_k * cf
                                    / jcfg.moe.n_experts)), 4)
    slot, kept = tmoe.dispatch(tids, cap)
    jslot, jkept = jax_kept(jids, cap)
    np.testing.assert_array_equal(slot.numpy(), jslot)
    np.testing.assert_array_equal(kept.numpy(), jkept)
    if cf < 1:
        assert (~kept).sum() > 0


def test_topk_order_matches_lax():
    """``torch.topk`` and ``lax.top_k`` give the same values and ids in the
    same (descending) order, on softmax probabilities of the routers'
    width."""
    need_jax()
    logits = np.random.default_rng(12).normal(size=(500, 64)).astype(
        np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 6)
    tv, ti = torch.topk(torch.tensor(probs), 6, dim=-1)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_has_jax_structure(arch):
    """``moe_init``'s tree and shapes equal the JAX package's: the router,
    the (E, in, out) expert stacks and the shared expert of width
    ``d_expert * n_shared``."""
    need_jax()
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    want = jax.tree.map(lambda a: tuple(a.shape),
                        jmoe.moe_init(jax.random.key(0), jcfg))
    got = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg)
    shapes = {k: {kk: {"w": tuple(vv["w"].shape)} for kk, vv in v.items()}
              if k != "router" else {"w": tuple(v["w"].shape)}
              for k, v in got.items()}
    assert shapes == want
    m = tcfg.moe
    assert got["shared"]["wi"]["w"].shape == (tcfg.d_model,
                                              m.d_expert * m.n_shared)


def test_dispatch_ranks_pairs_in_token_order():
    """A pair's slot is its rank among its expert's pairs in token order;
    pairs past the capacity are not kept."""
    ids = torch.tensor([[0, 1], [1, 0], [0, 2], [0, 1]])
    slot, kept = tmoe.dispatch(ids, 3)
    assert slot.tolist() == [0, 0, 1, 1, 2, 0, 3, 2]
    assert kept.tolist() == [True] * 6 + [False, True]


def test_moe_apply_drops_to_zero_contribution():
    """With every pair over capacity but the minimum of 4 slots, the
    routed part of a dropped token is zero: a layer with one expert,
    top-1 and no shared expert returns zeros for tokens 5 and on."""
    cfg = tget("kimi-k2-1t-a32b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=1, top_k=1, n_shared=0, capacity_factor=0.01))
    params = tmoe.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(1, 9, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    y, aux = tmoe.moe_apply(params, cfg, x)
    assert tmoe.capacity(cfg, 9) == 4
    assert bool((y[0, :4].abs().sum(-1) > 0).all())
    assert bool((y[0, 4:] == 0).all())
    assert float(aux) == pytest.approx(1.0)


@pytest.mark.gpu
def test_moe_apply_on_card_syncs_nothing_and_matches_cpu():
    """deepseek-v2-lite's MoE layer at its full width (64 experts, top-6,
    2 shared) on 2 x 256 tokens in float32: no host synchronisation
    (``set_sync_debug_mode("error")`` raises on one) and the CPU's output
    and aux at 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = dataclasses.replace(tget("deepseek-v2-lite-16b"), dtype="float32")
    params = tmoe.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(2, 256, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    want, want_aux = tmoe.moe_apply(params, cfg, x)
    on_card = tree_map(lambda t: t.cuda(), params)
    xc = x.cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, got_aux = tmoe.moe_apply(on_card, cfg, xc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    assert abs(float(got_aux) - float(want_aux)) <= 1e-4
