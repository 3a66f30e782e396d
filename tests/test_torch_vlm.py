"""Port parity: the VLM family (internvl2-1b's Qwen2 backbone with a stub
vision frontend) against the JAX package's ``lm_forward`` / ``lm_loss``
with ``prefix_embeds``.

The JAX package's ``Model.init`` params are carried across leaf for leaf;
prefix embeddings and tokens come from numpy seeds; both sides run the
reduced config on the CPU in float32 (the flash and rmsnorm wrappers take
their plain versions). Tolerances: forwards 1e-4 and the loss 1e-5, as
the dense family's in ``test_torch_models.py``; decode 1e-4 and greedy
tokens identical.

The JAX package's VLM decode takes no prefix (``lm_decode_init`` has no
``prefix_embeds``): its decode logits are those of a forward without the
prefix. The port keeps that behaviour, and a test holds it to it. A
machine with a card may have no JAX: there the oracle tests skip, e.g.
``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_vlm.py`` runs the ``gpu`` test alone.
"""

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rmsnorm as trms
from repro_torch.launch import serve as tserve
from repro_torch.models import SHAPES as T_SHAPES
from repro_torch.models import build_model as tbuild
from repro_torch.models import transformer as ttr
from repro_torch.utils import tree_leaves, tree_map

try:                     # the oracle; absent on a machine with only torch
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    from repro.models import transformer as jtr
except ImportError:
    jax = None

torch.set_num_threads(2)

ARCH = "internvl2-1b"


def need_jax():
    if jax is None:
        pytest.skip("needs JAX, the oracle")


def rng(seed):
    return np.random.default_rng(seed)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def jax_and_port():
    jcfg = jget(ARCH).reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = tget(ARCH).reduced()
    return (jcfg, jmodel, jparams, cfg, tbuild(cfg),
            convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         "cpu"))


def prefix(cfg, b, p, seed):
    return rng(seed).normal(size=(b, p, cfg.d_model)).astype(np.float32)


def tokens(cfg, b, s, seed):
    return rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("p,seq", [(8, 17), (5, 41)])
def test_vlm_forward_matches_jax(p, seq):
    """``lm_forward`` with a prefix and ``Model.logits``: (B, P + S, V),
    the prefix's positions first, against JAX's."""
    need_jax()
    jcfg, jmodel, jparams, cfg, model, params = jax_and_port()
    pre, toks = prefix(cfg, 2, p, 1), tokens(cfg, 2, seq, 2)
    want, want_aux = jtr.lm_forward(jparams, jcfg, jnp.asarray(toks),
                                    prefix_embeds=jnp.asarray(pre))
    got, aux = ttr.lm_forward(params, cfg, torch.tensor(toks),
                              prefix_embeds=torch.tensor(pre))
    assert got.shape == (2, p + seq, cfg.vocab_size) and float(aux) == 0.0
    close(got, want, 1e-4)
    logits = model.logits(params, {"tokens": torch.tensor(toks),
                                   "prefix_embeds": torch.tensor(pre)})
    assert logits.shape == (2, p + seq - 1, cfg.vocab_size)
    close(logits, jmodel.logits(jparams, {
        "tokens": jnp.asarray(toks), "prefix_embeds": jnp.asarray(pre)}),
        1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_vlm_loss_matches_jax(masked):
    """``lm_loss`` slices the prefix's logits off: the loss of the token
    positions, with and without a loss mask."""
    need_jax()
    jcfg, jmodel, jparams, cfg, model, params = jax_and_port()
    pre, toks = prefix(cfg, 2, 8, 3), tokens(cfg, 2, 13, 4)
    jb = {"tokens": jnp.asarray(toks), "prefix_embeds": jnp.asarray(pre)}
    tb = {"tokens": torch.tensor(toks), "prefix_embeds": torch.tensor(pre)}
    if masked:
        mask = (rng(5).uniform(size=(2, 12)) < 0.6).astype(np.float32)
        jb["loss_mask"], tb["loss_mask"] = jnp.asarray(mask), \
            torch.tensor(mask)
    got = model.loss(params, tb)
    assert got.shape == () and torch.isfinite(got)
    close(got, jmodel.loss(jparams, jb), 1e-5)


def test_prefix_takes_the_activation_dtype():
    """A float32 prefix of a bf16 model enters in bf16, as in JAX."""
    cfg = tget(ARCH).reduced(dtype="bfloat16")
    model = tbuild(cfg)
    params = model.init_serving(torch.Generator().manual_seed(6))
    logits, _ = ttr.lm_forward(params, cfg,
                               torch.tensor(tokens(cfg, 2, 5, 7)),
                               prefix_embeds=torch.tensor(prefix(cfg, 2, 8,
                                                                 8)))
    assert logits.dtype == torch.bfloat16 and logits.shape[1] == 13


def test_vlm_decode_drops_the_prefix_as_jax_does():
    """JAX's VLM decode takes no prefix: 8 teacher-forced decode steps
    match JAX's decode steps and the port's forward without the prefix,
    and differ from the forward with it."""
    need_jax()
    jcfg, jmodel, jparams, cfg, model, params = jax_and_port()
    pre, toks = prefix(cfg, 2, 8, 9), tokens(cfg, 2, 9, 10)
    res = tserve.serve(model, params, torch.tensor(toks[:, :8]), 1,
                       keep_prompt_logits=True)
    jcache = jmodel.decode_init(jparams, {"tokens": jnp.asarray(toks)}, 8,
                                dtype=jnp.float32)
    for t in range(8):
        want, jcache = jmodel.decode_step(jparams, jcache,
                                          jnp.asarray(toks[:, t]))
        close(res.prompt_logits[:, t], want, 1e-4)
    plain = model.logits(params, {"tokens": torch.tensor(toks)})
    torch.testing.assert_close(res.prompt_logits, plain, atol=2e-3,
                               rtol=2e-3)
    with_prefix = model.logits(params, {"tokens": torch.tensor(toks),
                                        "prefix_embeds": torch.tensor(pre)})
    assert float((with_prefix[:, 8:] - res.prompt_logits).abs().max()) > 0.1


def test_init_has_jax_structure_and_serving_copy_is_bitwise():
    need_jax()
    jcfg = jget(ARCH).reduced()
    jp = jbuild(jcfg).init(jax.random.key(0))
    cfg = tget(ARCH).reduced(dtype="bfloat16")
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(11))
    assert tree_map(lambda a: tuple(a.shape), params) == \
        jax.tree.map(lambda a: tuple(a.shape), jp)
    want = model.serving_params(params)
    got = model.init_serving(torch.Generator().manual_seed(11))
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_batch_specs_hold_the_prefix():
    """``batch_specs`` adds (B, n_vision_tokens = 256, d) bf16 for the VLM,
    (B, encoder_seq_len, d) bf16 frames for whisper, as JAX's do."""
    shape = T_SHAPES["train_4k"]
    specs = tbuild(tget(ARCH)).batch_specs(shape, batch_override=4)
    assert specs == {"tokens": ((4, 4097), torch.int32),
                     "prefix_embeds": ((4, 256, 896), torch.bfloat16)}
    specs = tbuild(tget("whisper-large-v3")).batch_specs(shape,
                                                         batch_override=2)
    assert specs == {"tokens": ((2, 4097), torch.int32),
                     "frames": ((2, 1500, 1280), torch.bfloat16)}
    assert tbuild(tget("qwen3-0.6b")).batch_specs(shape) == {
        "tokens": ((256, 4097), torch.int32)}


def test_internvl2_decode_32k_fits_one_card():
    """internvl2-1b at decode_32k: 24 x 2 x 128 x 32,768 x 2 x 64 x 2 B =
    51.5 GB of k/v in bf16, the zoo's first decode_32k cache under one
    card's 80 GB; the config is the published one (arXiv:2404.16821, the
    Qwen2-0.5B backbone: 24 layers, d 896, 14/2 heads of 64, QKV bias,
    vocab 151,655, 256 vision tokens)."""
    c = tget(ARCH)
    assert (c.family, c.n_layers, c.d_model, c.n_heads, c.n_kv_heads,
            c.resolved_head_dim, c.d_ff, c.vocab_size, c.n_vision_tokens,
            c.qkv_bias, c.tie_embeddings) == ("vlm", 24, 896, 14, 2, 64, 4864,
                                              151_655, 256, True, True)
    n = tserve.cache_bytes(c, 128, T_SHAPES["decode_32k"].seq_len,
                           torch.bfloat16)
    assert n == 24 * 2 * 128 * 32_768 * 2 * 64 * 2
    assert round(n / 1e9, 1) == 51.5


@pytest.mark.gpu
def test_reduced_model_on_card_matches_cpu():
    """Reduced internvl2 in float32 with the kernels on the card against
    the plain versions on the CPU: logits with the prefix at 1e-4, the
    launch counts of one forward, identical greedy tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = tget(ARCH).reduced()
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(12))
    on_card = tree_map(lambda p: p.cuda(), params)
    pre = torch.tensor(prefix(cfg, 2, cfg.n_vision_tokens, 13))
    toks = torch.tensor(tokens(cfg, 2, 33, 14))
    want = model.logits(params, {"tokens": toks, "prefix_embeds": pre})
    trms.LAUNCHES = tfa.LAUNCHES = 0
    got = model.logits(on_card, {"tokens": toks.cuda(),
                                 "prefix_embeds": pre.cuda()})
    assert (tfa.LAUNCHES, trms.LAUNCHES) == (cfg.n_layers,
                                             2 * cfg.n_layers + 1)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    a = tserve.serve(model, params, toks[:, :8], 8)
    b = tserve.serve(model, on_card, toks[:, :8].cuda(), 8)
    assert torch.equal(a.tokens, b.tokens.cpu())
