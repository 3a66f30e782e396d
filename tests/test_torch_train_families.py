"""Port parity: training the MoE, encoder-decoder and VLM families beyond
the shared cases of ``test_torch_train_step.py``, against ``jax.grad`` of
the JAX package on the CPU in float32.

- The MoE layer's gradient where pairs drop (capacity factor 0.5): the
  port drops the same (token, expert) pairs as JAX's sort-based slots
  (asserted present), a dropped pair's token copy gets exactly zero
  gradient (its ``index_copy_`` row is the spare row that is sliced off,
  as JAX's ``.at[].set(mode="drop")`` discards it), and the gradients of
  ``moe_apply``'s output and of the whole reduced model's loss match
  JAX's.
- The load-balancing aux term's gradient alone: it reaches the router
  and the tokens through the softmax probabilities only (the first
  choices' count has none), and no expert.
- The hierarchical step's pod split carries frames and prefix with their
  tokens.
- The gradient with respect to a VLM's ``prefix_embeds`` and an
  encoder-decoder's ``frames``, with and without a ``loss_mask``.
- A bf16 batch (the card's) trains: activations in bf16, float32 params.

Tolerances: losses at rtol 1e-5, gradients at rtol 1e-4 with atol 1e-4 x
the leaf's largest value (the same float32 arithmetic in another order),
as in ``test_torch_train_step.py``. A machine with a card may have no
JAX: there the oracle tests skip.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.launch import steps as tsteps
from repro_torch.models import ShapeSpec
from repro_torch.models import build_model as tbuild
from repro_torch.models import moe as tmoe
from repro_torch.utils import tree_leaves

try:                     # the oracle; absent on a machine with only torch
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    from repro.models import moe as jmoe
except ImportError:
    jax = None

torch.set_num_threads(2)

MOE_ARCHS = ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"]
DROP_CF = 0.5
LOSS_RTOL, RTOL = 1e-5, 1e-4
SEQ = 32
SHAPE = ShapeSpec("train_test", SEQ, 4, "train")


def need_jax():
    if jax is None:
        pytest.skip("needs JAX, the oracle")


def close(got, want, rtol=RTOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max() + 1e-30))


def with_cf(cfg, cf):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def jax_kept(ids, cap):
    """The pairs JAX keeps: ``repro/models/moe.py``'s stable argsort and
    ``searchsorted(side="left")`` slots under ``cap``."""
    flat = jnp.asarray(ids).reshape(-1)
    order = jnp.argsort(flat, stable=True)
    sorted_ids = flat[order]
    pos = jnp.arange(flat.shape[0]) - jnp.searchsorted(
        sorted_ids, sorted_ids, side="left")
    slot = jnp.zeros_like(flat).at[order].set(pos.astype(flat.dtype))
    return np.asarray(slot < cap)


class CopyGrads:
    """Wraps ``Tensor.index_copy_`` to keep the gradient that reaches the
    source of each call (``moe_apply`` copies the tokens once per choice:
    the row of token t in call j is pair (t, j)'s copy). ``pairs()``: those
    gradients in pair order, (T * k, d)."""

    def __init__(self, monkeypatch):
        self.grads = {}
        original = torch.Tensor.index_copy_

        def index_copy_(buf, dim, index, source):
            if source.requires_grad:
                source = source.view_as(source)     # this call's own node
                j = len(self.grads)
                self.grads[j] = None
                source.register_hook(
                    lambda g, j=j: self.grads.__setitem__(j, g))
            return original(buf, dim, index, source)

        monkeypatch.setattr(torch.Tensor, "index_copy_", index_copy_)

    def pairs(self):
        grads = [self.grads[j] for j in range(len(self.grads))]
        return torch.stack(grads, 1).reshape(-1, grads[0].shape[-1])


class Dispatches:
    """Wraps ``moe.dispatch`` to keep each call's ``kept`` pairs."""

    def __init__(self, monkeypatch):
        self.kept = []
        original = tmoe.dispatch

        def dispatch(ids, cap):
            slot, kept = original(ids, cap)
            self.kept.append(kept.clone())
            return slot, kept

        monkeypatch.setattr(tmoe, "dispatch", dispatch)


def moe_case(arch, seed=3):
    jcfg = with_cf(jget(arch).reduced(), DROP_CF)
    tcfg = with_cf(tget(arch).reduced(), DROP_CF)
    params = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.key(seed),
                                                    jcfg))
    r = np.random.default_rng(seed)
    x = r.normal(size=(2, 16, jcfg.d_model)).astype(np.float32)
    ct = r.normal(size=x.shape).astype(np.float32)
    return jcfg, tcfg, params, x, ct


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_gradient_with_dropped_pairs_matches_jax(arch, monkeypatch):
    """``moe_apply`` at capacity factor 0.5: the gradients of
    sum(y * ct) + aux with respect to the tokens and every parameter at
    1e-4 against ``jax.vjp``; the kept pairs equal JAX's, some pairs drop,
    and the dropped pairs' token copies get exactly zero gradient while
    the kept ones get some."""
    need_jax()
    jcfg, tcfg, params, x, ct = moe_case(arch)

    def jfn(p, xx):
        y, aux = jmoe.moe_apply(p, jcfg, xx)
        return jnp.sum(y * ct) + aux

    want_px, want_x = jax.grad(jfn, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))

    copies, dispatches = CopyGrads(monkeypatch), Dispatches(monkeypatch)
    tparams = convert.lm_params_from_numpy(params, "cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(tparams)]
    tx = torch.tensor(x, requires_grad=True)
    y, aux = tmoe.moe_apply(tparams, tcfg, tx)
    grads = torch.autograd.grad((y * torch.tensor(ct)).sum() + aux,
                                leaves + [tx])
    close(grads[-1], want_x)
    for got, want in zip(grads[:-1], jax.tree.leaves(want_px)):
        close(got, want)

    (kept,) = dispatches.kept
    t = x.shape[0] * x.shape[1]
    probs = jax.nn.softmax(jnp.asarray(x).reshape(t, -1)
                           @ jnp.asarray(params["router"]["w"]), axis=-1)
    _, jids = jax.lax.top_k(probs, jcfg.moe.top_k)
    np.testing.assert_array_equal(
        kept.numpy(), jax_kept(jids, tmoe.capacity(tcfg, t)))
    assert (~kept).sum() > 0 and kept.sum() > 0
    assert len(copies.grads) == tcfg.moe.top_k    # a call per choice
    copy_grad = copies.pairs()            # (T * k, d), pair order
    assert bool((copy_grad[~kept] == 0).all())
    assert bool((copy_grad[kept].abs().sum(-1) > 0).all())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_aux_gradient_alone_matches_jax(arch):
    """The gradient of the aux loss alone: through the router's
    probabilities to the router and the tokens at 1e-4 against JAX's,
    none to the experts (the first choices' count carries none)."""
    need_jax()
    jcfg, tcfg, params, x, _ = moe_case(arch, seed=4)
    want_p, want_x = jax.grad(
        lambda p, xx: jmoe.moe_apply(p, jcfg, xx)[1], argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tparams = convert.lm_params_from_numpy(params, "cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(tparams)]
    tx = torch.tensor(x, requires_grad=True)
    _, aux = tmoe.moe_apply(tparams, tcfg, tx)
    grads = torch.autograd.grad(aux, leaves + [tx], allow_unused=True)
    close(grads[-1], want_x)
    router = tparams["router"]["w"]
    for leaf, got, want in zip(leaves, grads[:-1],
                               jax.tree.leaves(want_p)):
        if leaf is router:
            assert float(np.abs(np.asarray(want)).max()) > 0
            close(got, want)
        else:                      # experts and shared: no path at all
            assert got is None
            assert not np.asarray(want).any()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_loss_and_gradients_with_drops_match_jax(arch,
                                                           monkeypatch):
    """The reduced model at capacity factor 0.5, where every MoE layer
    drops pairs (asserted): ``Model.loss`` at 1e-5 and every gradient leaf
    at 1e-4 against ``jax.grad`` of JAX's ``Model.loss``."""
    need_jax()
    jcfg = with_cf(jget(arch).reduced(dtype="float32"), DROP_CF)
    tcfg = with_cf(tget(arch).reduced(dtype="float32"), DROP_CF)
    jmodel = jbuild(jcfg)
    params = jmodel.init(jax.random.key(1))
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (4, SEQ + 1)).astype(np.int32)
    want_loss, want = jax.jit(jax.value_and_grad(jmodel.loss))(
        params, {"tokens": jnp.asarray(toks)})
    dispatches = Dispatches(monkeypatch)
    loss, grads = tsteps._loss_and_grads(
        tbuild(tcfg), convert.lm_params_from_numpy(
            jax.tree.map(np.asarray, params), "cpu"),
        {"tokens": torch.tensor(toks)}, 1.0, lambda _: None)
    assert loss.item() == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    n_moe = tcfg.n_layers - tcfg.moe.n_dense_layers
    # remat="block" (both packages' default) dispatches each MoE layer
    # twice: in the forward and in the backward's recomputation, alike
    assert tcfg.remat == "block"
    assert len(dispatches.kept) == 2 * n_moe
    for fwd, again in zip(dispatches.kept[:n_moe], dispatches.kept[n_moe:]):
        assert torch.equal(fwd, again)
    assert all((~k).sum() > 0 for k in dispatches.kept)
    got = tree_leaves(grads)
    assert len(got) == len(jax.tree.leaves(want))
    for a, w in zip(got, jax.tree.leaves(want)):
        close(a, w)


def family_batch(arch, seed=0, b=4):
    """``batch_specs``' keys and shapes for the reduced ``arch``: tokens
    below the vocab, frames and prefix as float32 normals."""
    model = tbuild(tget(arch).reduced(dtype="float32"))
    r = np.random.default_rng(seed)
    return {key: (r.integers(0, model.cfg.vocab_size, shape).astype(np.int32)
                  if key == "tokens"
                  else r.normal(size=shape).astype(np.float32))
            for key, (shape, _) in model.batch_specs(
                SHAPE, batch_override=b).items()}


@pytest.mark.parametrize("arch,key", [("whisper-large-v3", "frames"),
                                      ("internvl2-1b", "prefix_embeds")])
def test_pod_split_carries_frames_and_prefix(arch, key, monkeypatch):
    """The hierarchical step gives pod p rows [p * B/2, (p + 1) * B/2) of
    every key of the batch: the frames or prefix with their tokens, as
    JAX's step reshapes every leaf of the batch to (pods, B/pods, ...)."""
    model = tbuild(tget(arch).reduced(dtype="float32"))
    batch = family_batch(arch)
    assert set(batch) == {"tokens", key}
    seen = []
    loss = model.loss
    monkeypatch.setattr(model, "loss", lambda p, b: (seen.append(b),
                                                     loss(p, b))[1])
    bundle = tsteps.make_train_step(model, SHAPE, mode="hierarchical",
                                    n_pods=2, device="cpu")
    params, state, step = bundle.init_state(
        model.init(torch.Generator().manual_seed(0)))
    bundle.step_fn(params, state, step,
                   {k: torch.tensor(v) for k, v in batch.items()})
    assert len(seen) == 2
    for p, pod in enumerate(seen):
        assert set(pod) == {"tokens", key}
        for k, v in batch.items():
            want = v.reshape(2, v.shape[0] // 2, *v.shape[1:])[p]
            np.testing.assert_array_equal(pod[k].numpy(), want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch,key", [("internvl2-1b", "prefix_embeds"),
                                      ("whisper-large-v3", "frames")])
def test_input_embedding_gradient_matches_jax(arch, key, masked):
    """The gradient of ``Model.loss`` with respect to a VLM's
    ``prefix_embeds`` (its logits are sliced off, so the gradient flows
    through attention alone) and an encoder-decoder's ``frames``, at 1e-4
    against ``jax.grad`` with respect to the same batch entry; ``masked``:
    with a ``loss_mask`` over the token positions in the batch."""
    need_jax()
    jmodel = jbuild(jget(arch).reduced(dtype="float32"))
    params = jmodel.init(jax.random.key(2))
    batch = family_batch(arch, seed=6)
    if masked:
        batch["loss_mask"] = (np.random.default_rng(7).uniform(
            size=(4, SEQ)) < 0.5).astype(np.float32)

    def jloss(emb):
        return jmodel.loss(params, {**{k: jnp.asarray(v)
                                       for k, v in batch.items()},
                                    key: emb})

    want_loss, want = jax.value_and_grad(jloss)(jnp.asarray(batch[key]))
    model = tbuild(tget(arch).reduced(dtype="float32"))
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                           "cpu")
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    tbatch[key].requires_grad_()
    loss = model.loss(tparams, tbatch)
    (got,) = torch.autograd.grad(loss, tbatch[key])
    assert loss.item() == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    assert float(np.abs(np.asarray(want)).max()) > 0
    close(got, want)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-1b",
                                  "deepseek-v2-lite-16b"])
def test_bf16_batch_trains_with_float32_params(arch):
    """The card's batch: a bf16 config's ``batch_specs`` give bf16 frames
    and prefix; one ``sync`` step on them runs the activations in bf16
    (the loss's logits), keeps every param and moment float32 and finite,
    and moves the params."""
    cfg = tget(arch).reduced(dtype="bfloat16")
    model = tbuild(cfg)
    specs = model.batch_specs(SHAPE, batch_override=2)
    for key in set(specs) - {"tokens"}:
        assert specs[key][1] == torch.bfloat16
    gen = torch.Generator().manual_seed(7)
    batch = {k: (torch.randint(0, cfg.vocab_size, shape, generator=gen,
                               dtype=dtype) if k == "tokens"
                 else torch.randn(shape, generator=gen).to(dtype))
             for k, (shape, dtype) in specs.items()}
    with torch.no_grad():
        assert model.logits(model.init(gen), batch).dtype == torch.bfloat16
    bundle = tsteps.make_train_step(model, SHAPE, mode="sync",
                                    batch_override=2, device="cpu")
    params, state, step = bundle.init_state(model.init(gen))
    before = [p.clone() for p in tree_leaves(params)]
    params, state, step, loss = bundle.step_fn(params, state, step, batch)
    assert np.isfinite(loss.item())
    for leaf in tree_leaves((params, state)):
        assert leaf.dtype == torch.float32 and bool(torch.isfinite(leaf)
                                                    .all())
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                     before))
