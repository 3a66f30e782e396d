"""Port parity: LM training (``Model.loss``, its gradients, the ``sync``
and ``hierarchical`` train steps with the cloud sync and its compressors,
and the train CLI) on reduced qwen3-0.6b, olmo-1b, mamba2-1.3b,
zamba2-2.7b, deepseek-v2-lite-16b and kimi-k2-1t-a32b (MoE; MLA in
deepseek), whisper-large-v3 (encoder-decoder) and internvl2-1b (VLM) in
float32 against the JAX package. The batch has ``Model.batch_specs``'
keys and shapes, made with numpy from a seed: tokens, and an
encoder-decoder's frames and a VLM's prefix as float32 normals.

The JAX train CLI fails on this tree (ROADMAP queue 3), so the oracle is
composed here from model-level JAX functions, as its ``make_train_step``
composes them: ``model.loss``, ``jax.value_and_grad``,
``repro.launch.steps.make_optimizer`` (AdamW under a global-norm clip of
1.0), ``repro.optim.apply_updates``; for ``hierarchical`` the batch split
into pods, ``vmap`` of the loss over pods and their mean, ``vmap`` of the
optimizer over pods, and the cloud sync of ``steps.py:134-147`` (mean of
parameters and moments over pods, the pod residual through the
compressor). Parameters come from JAX's ``model.init`` (pods from two
keys) and carry across with ``convert``.

Tolerances: the loss at rtol 1e-5; gradients and the state after a step
at rtol 1e-4, atol 1e-4 x the leaf's largest value (the same float32
arithmetic in another order over a few layers), except the parameter
entries whose gradient is within that tolerance of zero: AdamW's first
step moves them by lr * g / (|g| + 1e-8), of either sign, so they are held
to lr (``close_step``). The compressors are
discontinuous (top-k membership, int8 rounding): an ulp of difference in
a step's output can move an entry across a threshold. So the cloud sync
is held on identical inputs (the port's state after the step, carried to
JAX): TopK's and Int8's results at rtol 1e-6 with the same kept entries,
and the whole step-then-sync without a compressor at 1e-4.

One leaf's exact gradient is zero: a key bias in a model without rope
(whisper's, in its encoder, decoder and cross attention) adds q.b to
every score of a query's row, which the softmax ignores. Both sides then
give rounding noise (~1e-10 against gradients of ~1e-3), so such a leaf
(and its moments) is held to atol rtol x the largest value of the same
projection's weight leaf (``wk.w``), the scale of the terms that cancel,
and JAX's value must itself lie within that bound; after a step its
entries are held to lr, as every entry whose gradient is within the
tolerance of zero.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.core import Int8Compressor, TopKCompressor
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import ShapeSpec
from repro_torch.models import build_model as tbuild
from repro_torch.utils import tree_leaves, tree_map

try:                     # the oracle; absent on a machine with only torch
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.core import compression as jc
    from repro.launch.steps import make_optimizer as j_make_optimizer
    from repro.models import build_model as jbuild
    from repro.optim import apply_updates as j_apply_updates
except ImportError:
    jax = None

torch.set_num_threads(2)

ARCHS = ["qwen3-0.6b", "olmo-1b", "mamba2-1.3b", "zamba2-2.7b",
         "deepseek-v2-lite-16b", "kimi-k2-1t-a32b", "whisper-large-v3",
         "internvl2-1b"]
LOSS_RTOL = 1e-5
RTOL = 1e-4
LR = 1e-2
SEQ = 64           # two chunks of the reduced SSM's 32
SHAPE = ShapeSpec("train_test", SEQ, 4, "train")


def need_jax():
    if jax is None:
        pytest.skip("needs JAX, the oracle")


def close(got, want, rtol=RTOL, scale=None):
    """Elementwise at ``rtol`` with atol rtol x ``scale``, by default the
    largest |want|; with a ``scale`` given, want must lie within atol of
    zero too (a leaf whose exact value is zero)."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if scale is not None:
        np.testing.assert_array_less(np.abs(want), rtol * scale)
    else:
        scale = float(np.abs(want).max() + 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


KEY_BIAS = ("wk", "b")


def zero_scales(want):
    """Per leaf of ``want``: None, or, for a key bias of a model without
    rope (exact gradient zero, see the module's docstring), the largest
    |value| of the same projection's weight leaf in ``want``."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    keys = [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
            for path, _ in flat]
    leaf = dict(zip(keys, (x for _, x in flat)))
    return [float(np.abs(leaf[k[:-1] + ("w",)]).max())
            if k[-2:] == KEY_BIAS and k[:-1] + ("w",) in leaf else None
            for k in keys]


def close_trees(got, want, rtol=RTOL, zero=False):
    """Leaf for leaf; ``zero``: the model's key biases have an exact
    gradient of zero (``zero_grad_bias``), held by ``zero_scales``."""
    got, scales = tree_leaves(got), zero_scales(want) if zero else None
    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        close(a, b, rtol, None if scales is None else scales[i])


def zero_grad_bias(arch):
    """Whether ``arch``'s key biases have an exact gradient of zero: it
    has qkv biases and no rope."""
    cfg = tget(arch)
    return cfg.qkv_bias and not cfg.use_rope


def close_step(got, want, grads, lr=LR, pod_mean=False, zero=False):
    """Parameters after an AdamW step. Its first step moves each entry by
    lr * g / (|g| + 1e-8): where |g| lies within the gradients' tolerance
    of zero (below RTOL x the leaf's largest gradient) the sign of a
    step of at most lr is not determined by the gradients' agreement, so
    those entries are held to lr; the rest at RTOL. ``pod_mean``: the
    parameters were then averaged over the pod axis, so an entry is held
    to lr where any pod's gradient is that small. ``zero``: a key bias
    whose exact gradient is zero takes its weight's gradient as the scale
    (``zero_scales``), so all its entries are held to lr."""
    scales = zero_scales(grads) if zero else [None] * len(tree_leaves(got))
    got, want, grads = (tree_leaves(got), jax.tree.leaves(want),
                        jax.tree.leaves(grads))
    assert len(got) == len(want) == len(grads) == len(scales)
    for a, b, g, scale in zip(got, want, grads, scales):
        a = a.detach().numpy()
        b, g = np.asarray(b), np.abs(np.asarray(g))
        tiny = g <= RTOL * (g.max() if scale is None else scale)
        if pod_mean:
            tiny = np.broadcast_to(tiny.any(0), tiny.shape)
        np.testing.assert_array_less(np.abs(a - b)[tiny], lr * (1 + 1e-6))
        if not tiny.all():
            close(a[~tiny], b[~tiny])


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def batch_arrays(arch, b=SHAPE.global_batch, seed=0):
    """The training batch of ``batch_specs``' keys and shapes for the
    reduced ``arch``, from one numpy generator: tokens below the vocab;
    frames and prefix as float32 normals."""
    model = port_model(arch)
    r = np.random.default_rng(seed)
    out = {}
    for key, (shape, _) in model.batch_specs(SHAPE, batch_override=b).items():
        out[key] = (r.integers(0, model.cfg.vocab_size, shape).astype(np.int32)
                    if key == "tokens"
                    else r.normal(size=shape).astype(np.float32))
    return out


def torch_batch(batch):
    return {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}


_CACHE = {}


def jax_case(arch):
    """JAX model, params, batch, and its loss and grads (computed once)."""
    if arch not in _CACHE:
        cfg = jget(arch).reduced(dtype="float32")
        model = jbuild(cfg)
        params = model.init(jax.random.key(0))
        batch = {k: jnp.asarray(v) for k, v in batch_arrays(arch).items()}
        loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, batch)
        _CACHE[arch] = (model, params, batch, loss, grads)
    return _CACHE[arch]


def port_model(arch):
    return tbuild(tget(arch).reduced(dtype="float32"))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    need_jax()
    _, params, batch, want_loss, want_grads = jax_case(arch)
    model = port_model(arch)
    tparams = convert.lm_params_from_numpy(to_numpy(params), "cpu")
    tbatch = torch_batch(batch)
    assert model.loss(tparams, tbatch).item() == pytest.approx(
        float(want_loss), rel=LOSS_RTOL)
    loss, grads = tsteps._loss_and_grads(model, tparams, tbatch, 1.0,
                                         lambda _: None)
    assert loss.item() == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    close_trees(grads, want_grads, zero=zero_grad_bias(arch))


@pytest.mark.parametrize("chunk_bytes", [1 << 28, 4 * 33 * 3])
def test_cross_entropy_matches_jax(monkeypatch, chunk_bytes):
    """The loss and its gradient with and without a mask (and an all-zero
    mask), in one chunk of rows and in chunks of 3 rows."""
    need_jax()
    from repro.models import layers as jl

    from repro_torch.models import layers as tl
    monkeypatch.setattr(tl, "CE_CHUNK_BYTES", chunk_bytes)
    r = np.random.default_rng(1)
    logits = (3 * r.normal(size=(2, 7, 33))).astype(np.float32)
    labels = r.integers(0, 33, (2, 7)).astype(np.int32)
    mask = (r.uniform(size=(2, 7)) < 0.6).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        x = torch.tensor(logits, requires_grad=True)
        got = tl.cross_entropy(x, torch.tensor(labels),
                               None if m is None else torch.tensor(m))
        (grad,) = torch.autograd.grad(got, x)
        want, want_grad = jax.value_and_grad(
            lambda z: jl.cross_entropy(z, jnp.asarray(labels),
                                       None if m is None else jnp.asarray(m))
        )(jnp.asarray(logits))
        assert got.item() == pytest.approx(float(want), rel=LOSS_RTOL,
                                           abs=1e-7)
        close(grad, want_grad, 1e-6)
    x = torch.tensor(logits).bfloat16().requires_grad_()
    (grad,) = torch.autograd.grad(tl.cross_entropy(x, torch.tensor(labels)),
                                  x)
    assert grad.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_sync_step_matches_jax(arch):
    need_jax()
    _, params, batch, loss, grads = jax_case(arch)
    opt = j_make_optimizer(LR)
    state = opt.init(params)
    step = jnp.zeros((), jnp.int32)
    updates, want_state = opt.update(grads, state, params, step)
    want_params = j_apply_updates(params, updates)

    bundle = tsteps.make_train_step(port_model(arch), SHAPE, mode="sync",
                                    lr=LR, device="cpu")
    tparams, tstate, tstep = bundle.init_state(
        convert.lm_params_from_numpy(to_numpy(params), "cpu"))
    marks = []
    tparams, tstate, tstep, tloss = bundle.step_fn(
        tparams, tstate, tstep,
        torch_batch(batch),
        clock=marks.append)
    assert marks == ["forward", "backward", "optimizer", "end"]
    assert tstep.item() == 1 and tstep.dtype == torch.int32
    assert tloss.item() == pytest.approx(float(loss), rel=LOSS_RTOL)
    zero = zero_grad_bias(arch)
    close_step(tparams, want_params, grads, zero=zero)
    close_trees(tstate, want_state, zero=zero)


def jax_hier_step(model, params, state, batch, n_pods):
    """JAX's hierarchical train step, composed as ``make_train_step``."""
    opt = j_make_optimizer(LR)
    step = jnp.zeros((), jnp.int32)

    def loss_fn(p, b):
        pod = jax.tree.map(lambda x: x.reshape((n_pods, x.shape[0] // n_pods)
                                               + x.shape[1:]), b)
        return jnp.mean(jax.vmap(model.loss)(p, pod))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, batch)
    updates, state = jax.vmap(lambda g, s, p: opt.update(g, s, p, step))(
        grads, state, params)
    return loss, grads, j_apply_updates(params, updates), state


def jax_cloud_sync(params, state, compressor):
    """``steps.py:134-147``."""
    def avg(leaf):
        if compressor is not None:
            mean = jnp.mean(leaf, axis=0, keepdims=True)
            delta, _ = compressor.compress(leaf - mean,
                                           jnp.zeros_like(leaf))
            leaf = mean + delta
        m = jnp.mean(leaf, axis=0, keepdims=True)
        return jnp.broadcast_to(m, leaf.shape)

    return jax.tree.map(avg, params), jax.tree.map(avg, state)


def hier_start(arch, n_pods=2):
    """Pod-stacked JAX params, pod p from key p, and their AdamW state."""
    model, _, batch, _, _ = jax_case(arch)
    stacked = jax.tree.map(lambda *ls: jnp.stack(ls),
                           *[model.init(jax.random.key(p))
                             for p in range(n_pods)])
    return model, stacked, j_make_optimizer(LR).init(stacked), batch


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-1.3b",
                                  "deepseek-v2-lite-16b",
                                  "whisper-large-v3"])
def test_hierarchical_step_and_cloud_sync_match_jax(arch):
    """Two pods from different params: the step (per-pod clip, the mean
    loss; whisper's frames split into pods with their tokens) and then the
    uncompressed cloud sync."""
    need_jax()
    model, params, state, batch = hier_start(arch)
    loss, grads, want_p, want_s = jax_hier_step(model, params, state,
                                                batch, 2)

    bundle = tsteps.make_train_step(port_model(arch), SHAPE,
                                    mode="hierarchical", lr=LR, n_pods=2,
                                    device="cpu")
    tparams = convert.tree_from_numpy(to_numpy(params), "cpu")
    tstate = bundle.optimizer.init(tparams)
    marks = []
    tparams, tstate, tstep, tloss = bundle.step_fn(
        tparams, tstate, torch.zeros((), dtype=torch.int32),
        torch_batch(batch),
        clock=marks.append)
    assert marks == ["forward", "backward", "optimizer"] * 2 + ["end"]
    assert tloss.item() == pytest.approx(float(loss), rel=LOSS_RTOL)
    zero = zero_grad_bias(arch)
    close_step(tparams, want_p, grads, zero=zero)
    close_trees(tstate, want_s, zero=zero)
    want_p, want_s = jax_cloud_sync(want_p, want_s, None)
    tparams, tstate = bundle.cloud_sync_fn(tparams, tstate)
    close_step(tparams, want_p, grads, pod_mean=True, zero=zero)
    close_trees(tstate, want_s, zero=zero)
    for leaf in tree_leaves((tparams, tstate)):
        assert torch.equal(leaf[0], leaf[1])


@pytest.mark.parametrize("name", ["topk", "int8"])
def test_compressed_cloud_sync_matches_jax(name):
    """The cloud sync under each compressor on identical inputs: the
    port's pod-stacked state after a hierarchical step, carried to JAX.
    TopK runs over the whole stacked leaf, pod axis included."""
    need_jax()
    arch = "qwen3-0.6b"
    _, params, _, batch = hier_start(arch)
    comp = {"topk": (TopKCompressor(0.05), jc.TopKCompressor(0.05)),
            "int8": (Int8Compressor(), jc.Int8Compressor())}[name]
    bundle = tsteps.make_train_step(port_model(arch), SHAPE,
                                    mode="hierarchical", lr=LR, n_pods=2,
                                    compressor=comp[0], device="cpu")
    tparams = convert.tree_from_numpy(to_numpy(params), "cpu")
    tstate = bundle.optimizer.init(tparams)
    tparams, tstate, _, _ = bundle.step_fn(
        tparams, tstate, torch.zeros((), dtype=torch.int32),
        torch_batch(batch))
    jparams = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(),
                                                 tparams))
    jstate = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(),
                                                tstate))
    before = [leaf.clone() for leaf in tree_leaves(tparams)]
    want_p, want_s = jax_cloud_sync(jparams, jstate, comp[1])
    tparams, tstate = bundle.cloud_sync_fn(tparams, tstate)
    close_trees(tparams, want_p, 1e-6)
    close_trees(tstate, want_s, 1e-6)
    # the sync moved the pods together, and not to the plain mean
    plain = [leaf.mean(0) for leaf in before]
    assert any(not torch.allclose(leaf[0], m, rtol=0, atol=0)
               for leaf, m in zip(tree_leaves(tparams), plain))
    for leaf in tree_leaves((tparams, tstate)):
        assert torch.equal(leaf[0], leaf[1])


def test_hierarchical_init_state_stacks_pods():
    model = port_model("qwen3-0.6b")
    bundle = tsteps.make_train_step(model, SHAPE, mode="hierarchical",
                                    n_pods=2, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    stacked, state, step = bundle.init_state(params)
    for a, b in zip(tree_leaves(stacked), tree_leaves(params)):
        assert a.shape == (2, *b.shape)
        assert torch.equal(a[0], b) and torch.equal(a[1], b)
        assert a.data_ptr() != b.data_ptr()
    assert set(state) == {"m", "v"}
    assert step.item() == 0
    with pytest.raises(ValueError, match="pods"):
        tsteps.make_train_step(model, ShapeSpec("x", 8, 3, "train"),
                               mode="hierarchical", n_pods=2, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        tsteps.make_train_step(model, SHAPE, mode="fsdp", device="cpu")


def test_train_step_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsteps.make_train_step(port_model("qwen3-0.6b"), SHAPE)


def test_batch_specs():
    model = port_model("olmo-1b")
    assert model.batch_specs(SHAPE) == {"tokens": ((4, SEQ + 1),
                                                   torch.int32)}
    assert model.batch_specs(SHAPE, batch_override=2)["tokens"][0] == (
        2, SEQ + 1)


@pytest.mark.parametrize("mode,arch", [("sync", "qwen3-0.6b"),
                                       ("hierarchical", "zamba2-2.7b")])
def test_train_cli_runs_on_cpu_and_writes_a_checkpoint(tmp_path, capsys,
                                                       mode, arch):
    """``python -m repro_torch.launch.train --reduced --device cpu
    --steps 2``: two steps (a cloud sync after the second in hierarchical
    mode), finite losses, and a checkpoint of the params at step 2 that
    restores into the model's tree."""
    from repro_torch.checkpoint import load_checkpoint
    ckpt = tmp_path / "ckpt"
    ttrain.main(["--reduced", "--device", "cpu", "--steps", "2",
                 "--mode", mode, "--arch", arch, "--edge-period", "2",
                 "--ckpt-every", "2", "--ckpt-dir", str(ckpt)])
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    model = port_model(arch)
    params = model.init(torch.Generator().manual_seed(0))
    if mode == "hierarchical":
        params = tree_map(lambda p: p.expand(2, *p.shape), params)
    step, tree, _ = load_checkpoint(str(ckpt), template={"params": params})
    assert step == 2
    for a, b in zip(tree_leaves(tree["params"]), tree_leaves(params)):
        assert a.shape == b.shape and torch.isfinite(a).all()
    if mode == "hierarchical":     # synced after step 2
        assert all(torch.equal(a[0], a[1])
                   for a in tree_leaves(tree["params"]))


def test_reduced_config_field_is_float32():
    """The CLI's reduced config is float32, as JAX's ``--reduced``."""
    cfg = tget("qwen3-0.6b").reduced(dtype="float32")
    assert dataclasses.asdict(cfg)["dtype"] == "float32"
