"""Port parity: ``repro_torch.optim`` (SGD with momentum and Nesterov,
AdamW with weight decay, the global-norm clip, ``apply_updates`` and the
schedules) against ``repro.optim``.

Both sides start from the same numpy tree and take the same gradients
over several steps, the step index an int32 scalar as the train step
carries it. Tolerance rtol 1e-6 (atol 1e-6 x the leaf's largest value):
the same float32 element-wise arithmetic, where only the global norm's
sums run in another order.
"""

import numpy as np
import pytest
import torch

from repro_torch import optim as topt
from repro_torch.utils import tree_leaves, tree_map

try:                     # the oracle; absent on a machine with only torch
    import jax
    import jax.numpy as jnp

    from repro import optim as jopt
except ImportError:
    jax = None

torch.set_num_threads(2)

RTOL = 1e-6
STEPS = 5


def need_jax():
    if jax is None:
        pytest.skip("needs JAX, the oracle")


def close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max() + 1e-30))


def tree(seed, scale=1.0):
    r = np.random.default_rng(seed)
    return {"a": {"w": (scale * r.normal(size=(7, 5))).astype(np.float32)},
            "b": (scale * r.normal(size=(11,))).astype(np.float32),
            "c": {"scale": (scale * r.normal(size=(3, 4, 2)))
                  .astype(np.float32)}}


def run_both(make, grad_scale=1.0):
    """``STEPS`` updates from the same params and gradients on both sides;
    returns the params and states after each step."""
    jo, to = make(jopt), make(topt)
    p0 = tree(0)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = tree_map(torch.tensor, p0)
    js, ts = jo.init(jp), to.init(tp)
    out = []
    for t in range(STEPS):
        g = tree(10 + t, grad_scale)
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp,
                           jnp.asarray(t, jnp.int32))
        tu, ts = to.update(tree_map(torch.tensor, g), ts, tp,
                           torch.tensor(t, dtype=torch.int32))
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        out.append((jp, tp, js, ts))
    return out


def check(out):
    for jp, tp, js, ts in out:
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            close(a, b)
        for a, b in zip(tree_leaves(ts), jax.tree.leaves(js)):
            close(a, b)


@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False),
                                               (0.9, True)])
def test_sgd_matches_jax(momentum, nesterov):
    need_jax()
    check(run_both(lambda m: m.sgd(0.05, momentum=momentum,
                                   nesterov=nesterov)))


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_jax(weight_decay):
    need_jax()
    out = run_both(lambda m: m.adamw(3e-3, weight_decay=weight_decay))
    check(out)
    assert set(out[-1][3]) == {"m", "v"}


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
def test_clipped_adamw_matches_jax(grad_scale):
    """Below the clip (no scaling) and far above it (every step scaled)."""
    need_jax()
    check(run_both(lambda m: m.clip_by_global_norm(m.adamw(1e-2), 1.0),
                   grad_scale))


def test_adamw_under_a_schedule_matches_jax():
    need_jax()
    check(run_both(lambda m: m.adamw(m.linear_warmup_cosine(1e-2, 2, 5))))


def test_bias_correction_in_float32():
    """``1 - b ** t`` computed in float32 from the int32 step, as JAX's
    weakly typed power gives it, over a long run of steps."""
    need_jax()
    t = np.arange(1, 3000, dtype=np.int32)
    for b in (0.9, 0.95, 0.999):
        got = 1 - topt.optimizers._pow(b, torch.tensor(t))
        want = 1 - b ** jnp.asarray(t)
        assert got.dtype == torch.float32
        close(got, want)


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)), ("cosine_decay", (1e-3, 100)),
    ("cosine_decay", (1e-3, 100, 1e-5)),
    ("linear_warmup_cosine", (1e-3, 10, 100)),
    ("linear_warmup_cosine", (1e-3, 10, 100, 1e-4))])
def test_schedules_match_jax(name, args):
    need_jax()
    tfn, jfn = getattr(topt, name)(*args), getattr(jopt, name)(*args)
    for step in range(0, 130, 3):
        got = tfn(torch.tensor(step, dtype=torch.int32))
        want = jfn(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        close(got, want)


def test_update_leaves_its_inputs_alone():
    """``update`` returns new trees (the train step writes them back)."""
    opt = topt.clip_by_global_norm(topt.adamw(1e-2), 1.0)
    p = tree_map(torch.tensor, tree(0))
    s = opt.init(p)
    g = tree_map(torch.tensor, tree(1))
    before = [x.clone() for x in tree_leaves((p, s, g))]
    opt.update(g, s, p, torch.tensor(0, dtype=torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 tree_leaves((p, s, g))))


IN_PLACE = {"adamw": lambda: topt.adamw(1e-2),
            "adamw_wd": lambda: topt.adamw(1e-2, weight_decay=0.1),
            "sgd": lambda: topt.sgd(1e-2),
            "sgd_momentum": lambda: topt.sgd(1e-2, momentum=0.9),
            "sgd_nesterov": lambda: topt.sgd(1e-2, momentum=0.9,
                                             nesterov=True)}


@pytest.mark.parametrize("name", list(IN_PLACE))
@pytest.mark.parametrize("grad_scale", [1.0, 100.0])
def test_apply_in_place_equals_update_then_apply_updates(name, grad_scale):
    """``apply_`` (the train step's leaf-by-leaf update, in place) gives
    ``update`` then ``apply_updates`` bit for bit over several steps,
    under the clip and past it (grad_scale 100), and releases each
    gradient from its list."""
    opt = topt.clip_by_global_norm(IN_PLACE[name](), 1.0)
    p = tree_map(torch.tensor, tree(0))
    s = opt.init(p)
    p_in, s_in = tree_map(torch.clone, p), opt.init(p)
    for t in range(STEPS):
        g = tree_map(torch.tensor, tree(10 + t, grad_scale))
        step = torch.tensor(t, dtype=torch.int32)
        u, s = opt.update(g, s, p, step)
        p = topt.apply_updates(p, u)
        grads = tree_leaves(g)
        opt.apply_(grads, s_in, p_in, step)
        assert grads == [None] * len(grads)
        for a, b in zip(tree_leaves((p_in, s_in)), tree_leaves((p, s))):
            assert torch.equal(a, b)
