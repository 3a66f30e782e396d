"""Port parity: the registry's configurations and shapes that the card
runs in ``chip_smoke.py`` phase 31, at CPU sizes, against the JAX package.

- qwen3-32b (64/8 heads, qk-norm, untied read-out), reduced in float32:
  logits at 1e-4, teacher-forced decode steps through the cache at 1e-4
  and greedy tokens identical.
- The GQA groups the full models run, 7 (qwen2-7b: 28/4 heads) and 8
  (qwen3-32b: 64/8), at the reduced width (n_heads = group, one kv head,
  head dim 16; the reduced configs' own group is 2): logits at 1e-4, the
  loss at 1e-5 and every gradient at 1e-4 against ``jax.value_and_grad``.
- The flash kernel's plain versions at those groups and head dim 128 with
  Sq == Skv (where the JAX reference's bottom-right causal mask equals the
  port's top-left one): the forward against ``repro.kernels.ref.
  flash_attention_ref`` at 1e-5, the backward (from the forward's o and
  logsumexp) against ``jax.vjp`` of it at 1e-4. The Pallas kernel itself
  does not run on this CPU (ROADMAP queue 3).
- zamba2 with its shared attention+MLP block applied twice (4 layers, a
  period of 2; the reduced config applies it once): the loss at 1e-5 and
  the gradients, the shared block's (a sum over both applications)
  among them, at 1e-4.
- mamba2 and zamba2 decode steps over a cache of 4096 positions of which
  3 are filled (``long_500k``'s semantics at a CPU size: a cache far
  longer than its valid prefix): logits at 1e-4, every cache leaf at 1e-5.
- ``cache_bytes`` of full-size mamba2 and zamba2 at ``long_500k`` against
  the bytes of ``Model.decode_init``'s tree built on fake tensors (no
  memory), and the sizes ``chip_smoke.py`` reports (0.1 and 48.4 GB).

Gradients and logits are compared elementwise with atol = rtol x the
reference's largest magnitude, as ``test_torch_train_step.py`` does.
"""

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import SHAPES as T_SHAPES
from repro_torch.models import build_model as tbuild
from repro_torch.utils import tree_leaves, tree_leaves_with_path

try:                     # the oracle; absent on a machine with only torch
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.kernels import ref as jref
    from repro.models import build_model as jbuild
except ImportError:
    jax = None

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
RTOL = 1e-4
CACHE_RTOL = 1e-5
FLASH_RTOL = 1e-5
# (arch, GQA group): qwen2-7b's 28/4 and qwen3-32b's 64/8
GROUPS = [("qwen2-7b", 7), ("qwen3-32b", 8)]
LONG_CACHE = 4096


def need_jax():
    if jax is None:
        pytest.skip("needs JAX, the oracle")


def close(got, want, rtol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max() + 1e-30))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def models(arch, **overrides):
    """The reduced float32 ``arch`` (with ``overrides``) on both sides:
    (JAX model, its params from key 0, the port's model, the same params
    carried across)."""
    jcfg = jget(arch).reduced(dtype="float32", **overrides)
    jmodel = jbuild(jcfg)
    params = jmodel.init(jax.random.key(0))
    tmodel = tbuild(tget(arch).reduced(dtype="float32", **overrides))
    return jmodel, params, tmodel, convert.lm_params_from_numpy(
        to_numpy(params), "cpu")


def group_overrides(group):
    return dict(n_heads=group, n_kv_heads=1, head_dim=16)


# ---------------------------------------------------------------------------
# qwen3-32b, reduced
# ---------------------------------------------------------------------------

def test_qwen3_32b_logits_and_greedy_decode_match_jax():
    """Reduced qwen3-32b: logits over 40 positions, 8 teacher-forced decode
    steps and 8 greedy tokens of the serve step against JAX's."""
    need_jax()
    jmodel, params, tmodel, tparams = models("qwen3-32b")
    cfg = tmodel.cfg
    assert cfg.qk_norm and not cfg.tie_embeddings
    toks = tokens(cfg.vocab_size, 2, 41, seed=11)
    close(tmodel.logits(tparams, {"tokens": torch.tensor(toks)}),
          jmodel.logits(params, {"tokens": jnp.asarray(toks)}), RTOL)
    prompt = toks[:, :8]
    jcache = jmodel.decode_init(params, {"tokens": jnp.asarray(prompt)}, 20,
                                dtype=jnp.float32)
    tcache = tmodel.decode_init(tparams, {"tokens": torch.tensor(prompt)},
                                20, dtype=torch.float32)
    for t in range(8):
        want, jcache = jmodel.decode_step(params, jcache,
                                          jnp.asarray(prompt[:, t]))
        got, tcache = tmodel.decode_step(tparams, tcache,
                                         torch.tensor(prompt[:, t]))
        close(got, want, RTOL)
    jtok = jnp.argmax(want, axis=-1).astype(jnp.int32)
    jout = [np.asarray(jtok)]
    for _ in range(7):
        logits, jcache = jmodel.decode_step(params, jcache, jtok)
        jtok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        jout.append(np.asarray(jtok))
    step = make_serve_step(tmodel).step_fn
    ttok = torch.argmax(got, dim=-1).to(torch.int32)
    tout = [ttok.numpy()]
    for _ in range(7):
        ttok, tcache = step(tparams, tcache, ttok)
        tout.append(ttok.numpy())
    np.testing.assert_array_equal(np.stack(tout, 1), np.stack(jout, 1))
    res = tserve.serve(tmodel, tparams, torch.tensor(prompt), 8, max_len=20)
    np.testing.assert_array_equal(res.tokens.numpy(), np.stack(jout, 1))


# ---------------------------------------------------------------------------
# the GQA groups of the full models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,group", GROUPS)
def test_gqa_group_logits_match_jax(arch, group):
    need_jax()
    jmodel, params, tmodel, tparams = models(arch, **group_overrides(group))
    assert tmodel.cfg.n_heads // tmodel.cfg.n_kv_heads == group
    toks = tokens(tmodel.cfg.vocab_size, 2, 41, seed=12)
    got = tmodel.logits(tparams, {"tokens": torch.tensor(toks)})
    assert got.shape == (2, 40, tmodel.cfg.vocab_size)
    close(got, jmodel.logits(params, {"tokens": jnp.asarray(toks)}), RTOL)


@pytest.mark.parametrize("arch,group", GROUPS)
def test_gqa_group_loss_and_gradients_match_jax(arch, group):
    """The loss and every gradient (qwen2's QKV biases among them, through
    the flash backward's plain version at the group) against
    ``jax.value_and_grad`` of the JAX model's loss."""
    need_jax()
    jmodel, params, tmodel, tparams = models(arch, **group_overrides(group))
    toks = tokens(tmodel.cfg.vocab_size, 4, 65, seed=13)
    want_loss, want = jax.jit(jax.value_and_grad(jmodel.loss))(
        params, {"tokens": jnp.asarray(toks)})
    loss, grads = tsteps._loss_and_grads(
        tmodel, tparams, {"tokens": torch.tensor(toks)}, 1.0, lambda _: None)
    assert loss.item() == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    want = jax.tree.leaves(want)
    assert len(grads) == len(want)
    for a, b in zip(grads, want):
        close(a, b, RTOL)
    if arch == "qwen2-7b":
        paths = [p for p, _ in tree_leaves_with_path(tparams)]
        assert ("blocks", "attn", "wq", "b") in paths


# ---------------------------------------------------------------------------
# the flash kernel's plain versions at groups 7 and 8, head dim 128
# ---------------------------------------------------------------------------

def flash_inputs(group, causal):
    """q (B, S, group x Hkv, 128), k and v (B, S, Hkv, 128), the output
    cotangent; Sq == Skv."""
    b, s, hkv = (1, 64, 1) if group == 7 else (2, 48, 2)
    r = np.random.default_rng(14 + group + 2 * causal)
    q, g = (r.normal(size=(b, s, group * hkv, 128)).astype(np.float32)
            for _ in range(2))
    k, v = (r.normal(size=(b, s, hkv, 128)).astype(np.float32)
            for _ in range(2))
    return q, k, v, g


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [7, 8])
def test_flash_plain_version_at_group_matches_jax(group, causal):
    need_jax()
    q, k, v, _ = flash_inputs(group, causal)
    got = tref.flash_attention_ref(*map(torch.tensor, (q, k, v)),
                                   causal=causal)
    want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                    causal=causal)
    close(got, want, FLASH_RTOL)
    # the wrapper takes the plain version on CPU tensors
    before = tfa.LAUNCHES
    same = tfa.flash_attention(*map(torch.tensor, (q, k, v)), causal=causal)
    assert torch.equal(same, got) and tfa.LAUNCHES == before


@pytest.mark.parametrize("group", [7, 8])
def test_flash_backward_plain_version_at_group_matches_jax(group):
    """The backward's plain version from the forward's o and logsumexp
    (the kernel's inputs) against ``jax.vjp`` of the JAX reference."""
    need_jax()
    q, k, v, g = flash_inputs(group, True)
    tq, tk, tv, tg = map(torch.tensor, (q, k, v, g))
    o, lse = tref.flash_attention_ref(tq, tk, tv, return_lse=True)
    got = tref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tg)
    _, vjp = jax.vjp(lambda *x: jref.flash_attention_ref(*x, causal=True),
                     *map(jnp.asarray, (q, k, v)))
    for a, b in zip(got, vjp(jnp.asarray(g))):
        close(a, b, RTOL)


# ---------------------------------------------------------------------------
# zamba2's shared block applied twice
# ---------------------------------------------------------------------------

def test_zamba2_two_applications_loss_and_shared_gradient_match_jax():
    """4 layers with the shared attention+MLP block after every 2: its
    weights take two applications' gradients, summed, as in
    ``jax.grad``."""
    need_jax()
    overrides = dict(n_layers=4, hybrid_attn_period=2)
    jmodel, params, tmodel, tparams = models("zamba2-2.7b", **overrides)
    assert tmodel.cfg.n_layers // tmodel.cfg.hybrid_attn_period == 2
    toks = tokens(tmodel.cfg.vocab_size, 2, 65, seed=15)
    want_loss, want = jax.jit(jax.value_and_grad(jmodel.loss))(
        params, {"tokens": jnp.asarray(toks)})
    loss, grads = tsteps._loss_and_grads(
        tmodel, tparams, {"tokens": torch.tensor(toks)}, 1.0, lambda _: None)
    assert loss.item() == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    paths = [p for p, _ in tree_leaves_with_path(tparams)]
    leaves = jax.tree.leaves(want)
    assert len(grads) == len(leaves) == len(paths)
    shared = 0
    for path, a, b in zip(paths, grads, leaves):
        close(a, b, RTOL)
        if path[0] == "shared_attn":
            shared += 1
            assert float(np.abs(np.asarray(b)).max()) > 0, path
    assert shared >= 8       # attention's four projections, the MLP's


# ---------------------------------------------------------------------------
# long_500k's semantics at a CPU size, and its cache bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_decode_over_a_long_cache_matches_jax(arch):
    """Three decode steps into a cache of 4096 positions (zamba2's shared
    k/v masked past the valid prefix) against JAX's: logits at 1e-4,
    every cache leaf at 1e-5."""
    need_jax()
    jmodel, params, tmodel, tparams = models(arch)
    toks = tokens(tmodel.cfg.vocab_size, 2, 3, seed=16)
    jcache = jmodel.decode_init(params, {"tokens": jnp.asarray(toks)},
                                LONG_CACHE, dtype=jnp.float32)
    tcache = tmodel.decode_init(tparams, {"tokens": torch.tensor(toks)},
                                LONG_CACHE, dtype=torch.float32)
    for t in range(3):
        want, jcache = jmodel.decode_step(params, jcache,
                                          jnp.asarray(toks[:, t]))
        got, tcache = tmodel.decode_step(tparams, tcache,
                                         torch.tensor(toks[:, t]))
        close(got, want, RTOL)
    flat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert len(flat) == len(tree_leaves(tcache))
    for path, leaf in flat:
        node = tcache
        for p in path:
            node = node[p.key]
        close(node, leaf, CACHE_RTOL)
    if arch == "zamba2-2.7b":
        assert tcache["shared"]["k"].shape[2] == LONG_CACHE
        assert tcache["shared"]["length"].tolist() == [[3, 3]]


@pytest.mark.parametrize("arch,gb", [("mamba2-1.3b", 0.1),
                                     ("zamba2-2.7b", 48.4)])
def test_cache_bytes_of_long_500k_equal_a_fake_cache(arch, gb):
    cfg = tget(arch)
    shape = T_SHAPES["long_500k"]
    specs, _ = tbuild(cfg).decode_specs(shape)
    built = sum(int(np.prod(s.shape)) * torch.empty((), dtype=s.dtype)
                .element_size() for s in tree_leaves(specs)
                if s.dtype.is_floating_point)
    want = tserve.cache_bytes(cfg, shape.global_batch, shape.seq_len,
                              torch.bfloat16)
    assert built == want
    assert round(want / 1e9, 1) == gb
