"""Port parity: the encoder-decoder family (whisper-large-v3,
``repro_torch.models.encdec``) against the JAX package's
``repro.models.encdec``.

The JAX package's ``Model.init`` params are carried across leaf for leaf
with ``convert.lm_params_from_numpy``; frames and tokens come from numpy
seeds; both sides run the reduced config on the CPU in float32, where the
port's flash wrapper takes its plain version (JAX's encoder-decoder calls
``blocked_attention``). Tolerances, stated per test:

- ``sinusoidal_positions`` and ``cross_kv``: 1e-6 (the same float32
  arithmetic; a sine's argument rounds alike at these lengths);
- ``encode`` and ``encdec_forward``: 1e-4 (many matrix products in another
  summation order), as the LM forwards of ``test_torch_models.py``;
- ``encdec_loss``: 1e-5 (a mean of float32 cross entropies);
- decode steps: 1e-4 against JAX's, the cache at 1e-5; against the port's
  own forward 2e-3, the bound of ``tests/test_models.py``;
- greedy tokens identical.

The encoder and decoder lengths are ragged against JAX's attention blocks
and differ from each other, so the cross attention runs non-causally at
Sq != Skv. A machine with a card may have no JAX: there the oracle tests
skip, e.g. ``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_encdec.py`` runs the ``gpu`` test alone.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rmsnorm as trms
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import SHAPES as T_SHAPES
from repro_torch.models import attention as tatt
from repro_torch.models import build_model as tbuild
from repro_torch.models import encdec as ted
from repro_torch.models import layers as tl
from repro_torch.utils import tree_leaves, tree_map

try:                     # the oracle; absent on a machine with only torch
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import attention as jatt
    from repro.models import build_model as jbuild
    from repro.models import encdec as jed
    from repro.models import layers as jl
except ImportError:
    jax = None

torch.set_num_threads(2)

ARCH = "whisper-large-v3"


def need_jax():
    if jax is None:
        pytest.skip("needs JAX, the oracle")


def rng(seed):
    return np.random.default_rng(seed)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def jax_model(**overrides):
    cfg = jget(ARCH).reduced(**overrides)
    model = jbuild(cfg)
    return cfg, model, model.init(jax.random.key(0))


def port(jparams, **overrides):
    """The port's model of the reduced config and the JAX params carried
    across."""
    cfg = tget(ARCH).reduced(**overrides)
    return cfg, tbuild(cfg), convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


def frames(cfg, b, s_enc, seed):
    return rng(seed).normal(size=(b, s_enc, cfg.d_model)).astype(np.float32)


def tokens(cfg, b, s, seed):
    return rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,d", [(16, 64), (23, 64), (256, 64), (40, 128)])
def test_sinusoidal_positions_match_jax(s, d):
    need_jax()
    got = tl.sinusoidal_positions(s, d)
    assert got.shape == (s, d) and got.dtype == torch.float32
    close(got, jl.sinusoidal_positions(s, d), 1e-6)


def test_cross_kv_matches_jax():
    need_jax()
    jcfg = jget(ARCH).reduced()
    params = jax.tree.map(np.asarray,
                          jatt.attention_init(jax.random.key(3), jcfg))
    enc = rng(4).normal(size=(2, 23, jcfg.d_model)).astype(np.float32)
    want = jatt.cross_kv(params, jcfg, jnp.asarray(enc))
    got = tatt.cross_kv(convert.lm_params_from_numpy(params, "cpu"),
                        tget(ARCH).reduced(), torch.tensor(enc))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 23, jcfg.n_kv_heads,
                                      jcfg.resolved_head_dim)
        close(g, w, 1e-6)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def test_encdec_params_carry_over_leaf_for_leaf():
    """JAX's encdec params (``enc_blocks`` and ``dec_blocks`` stacked over
    the layers, ``pos_embed``) reach the port leaf for leaf; the bf16
    serving copy keeps norms, biases and ``pos_embed`` float32."""
    need_jax()
    _, _, params = jax_model()
    tree = jax.tree.map(np.asarray, params)
    got = convert.lm_params_from_numpy(tree, "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat_j) == len(tree_leaves(got))
    for path, leaf in flat_j:
        node = got
        for p in path:
            node = node[p.key]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), leaf)
    serving = convert.lm_params_from_numpy(tree, "cpu", dtype=torch.bfloat16)
    assert serving["dec_blocks"]["cross_attn"]["wq"]["w"].dtype == \
        torch.bfloat16
    assert serving["dec_blocks"]["cross_attn"]["wq"]["b"].dtype == \
        torch.float32
    assert serving["enc_blocks"]["norm1"]["bias"].dtype == torch.float32
    assert serving["embed"]["table"].dtype == torch.bfloat16
    assert serving["pos_embed"].dtype == torch.float32


def test_encdec_init_has_jax_structure():
    need_jax()
    _, _, jp = jax_model()
    tp = tbuild(tget(ARCH).reduced()).init(torch.Generator().manual_seed(0))
    assert tree_map(lambda a: tuple(a.shape), tp) == \
        jax.tree.map(lambda a: tuple(a.shape), jp)
    assert 0.018 < float(tp["embed"]["table"].std()) < 0.022
    assert 0.009 < float(tp["pos_embed"].std()) < 0.011


def test_init_serving_equals_serving_params_bitwise():
    """whisper's serving copy built a layer at a time equals
    ``serving_params(init(gen))`` bit for bit, ``pos_embed`` float32 in
    both; and the bf16 forward gives the same logits from either."""
    cfg = tget(ARCH).reduced(dtype="bfloat16")
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(5))
    want = model.serving_params(params)
    got = model.init_serving(torch.Generator().manual_seed(5))
    assert tree_map(lambda a: (tuple(a.shape), a.dtype), got) == \
        tree_map(lambda a: (tuple(a.shape), a.dtype), want)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(g, w)
    assert got["pos_embed"].dtype == torch.float32
    batch = {"frames": torch.tensor(frames(cfg, 2, 16, 6)).bfloat16(),
             "tokens": torch.tensor(tokens(cfg, 2, 7, 7))}
    assert torch.equal(model.logits(params, batch), model.logits(got, batch))


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s_enc", [16, 23])
def test_encode_matches_jax(s_enc):
    need_jax()
    jcfg, _, jparams = jax_model()
    cfg, _, params = port(jparams)
    f = frames(cfg, 2, s_enc, 8)
    want = jed.encode(jparams, jcfg, jnp.asarray(f))
    before = tfa.LAUNCHES
    got = ted.encode(params, cfg, torch.tensor(f))
    assert tfa.LAUNCHES == before          # the plain version on the CPU
    assert got.shape == (2, s_enc, cfg.d_model)
    close(got, want, 1e-4)


@pytest.mark.parametrize("s_enc,s_dec", [(16, 9), (23, 41), (40, 17)])
def test_encdec_forward_matches_jax(s_enc, s_dec):
    """Teacher-forced logits through ``Model.logits``: the cross attention
    at Sq = s_dec - 1 against Skv = s_enc, both ragged."""
    need_jax()
    jcfg, jmodel, jparams = jax_model()
    cfg, model, params = port(jparams)
    f, toks = frames(cfg, 2, s_enc, 9), tokens(cfg, 2, s_dec, 10)
    want = jmodel.logits(jparams, {"frames": jnp.asarray(f),
                                   "tokens": jnp.asarray(toks)})
    got = model.logits(params, {"frames": torch.tensor(f),
                                "tokens": torch.tensor(toks)})
    assert got.shape == (2, s_dec - 1, cfg.vocab_size)
    close(got, want, 1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_encdec_loss_matches_jax(masked):
    need_jax()
    jcfg, jmodel, jparams = jax_model()
    cfg, model, params = port(jparams)
    f, toks = frames(cfg, 2, 16, 11), tokens(cfg, 2, 12, 12)
    jb = {"frames": jnp.asarray(f), "tokens": jnp.asarray(toks)}
    tb = {"frames": torch.tensor(f), "tokens": torch.tensor(toks)}
    if masked:
        mask = (rng(13).uniform(size=(2, 11)) < 0.6).astype(np.float32)
        jb["loss_mask"], tb["loss_mask"] = jnp.asarray(mask), \
            torch.tensor(mask)
    got = model.loss(params, tb)
    assert got.shape == () and torch.isfinite(got)
    close(got, jmodel.loss(jparams, jb), 1e-5)


def test_activation_dtype_follows_the_frames():
    """As in JAX: bf16 frames give a bf16 forward of a float32 config and
    float32 frames a float32 one; a decode step runs in the embedding
    table's dtype."""
    cfg = tget(ARCH).reduced()
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(14))
    f = torch.tensor(frames(cfg, 2, 16, 15))
    toks = torch.tensor(tokens(cfg, 2, 5, 16))
    assert model.logits(params, {"frames": f, "tokens": toks}).dtype == \
        torch.float32
    assert model.logits(params, {"frames": f.bfloat16(),
                                 "tokens": toks}).dtype == torch.bfloat16
    bf16 = tbuild(tget(ARCH).reduced(dtype="bfloat16"))
    serving = bf16.init_serving(torch.Generator().manual_seed(14))
    cache = bf16.decode_init(serving, {"tokens": toks, "frames": f}, 8)
    logits, _ = bf16.decode_step(serving, cache, toks[:, 0])
    assert logits.dtype == torch.bfloat16
    cache = model.decode_init(params, {"tokens": toks, "frames": f}, 8)
    logits, _ = model.decode_step(params, cache, toks[:, 0])
    assert logits.dtype == torch.float32


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def test_decode_steps_and_greedy_tokens_match_jax():
    """``decode_init`` (the encoder once, each layer's cross k/v) and 8
    teacher-forced decode steps against JAX's, the caches after them, then
    8 greedy tokens of the serve step against JAX's decode + argmax."""
    need_jax()
    jcfg, jmodel, jparams = jax_model()
    cfg, model, params = port(jparams)
    f, toks = frames(cfg, 2, 23, 17), tokens(cfg, 2, 8, 18)
    jcache = jmodel.decode_init(jparams, {"frames": jnp.asarray(f),
                                          "tokens": jnp.asarray(toks)}, 20,
                                dtype=jnp.float32)
    tcache = model.decode_init(params, {"frames": torch.tensor(f),
                                        "tokens": torch.tensor(toks)}, 20,
                               dtype=torch.float32)
    assert tree_map(lambda a: (tuple(a.shape), str(a.dtype)[6:]),
                    tcache) == jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), jcache)
    close(tcache["cross"]["k"], jcache["cross"]["k"], 1e-5)
    close(tcache["cross"]["v"], jcache["cross"]["v"], 1e-5)
    for t in range(8):
        want, jcache = jmodel.decode_step(jparams, jcache,
                                          jnp.asarray(toks[:, t]))
        got, tcache = model.decode_step(params, tcache,
                                        torch.tensor(toks[:, t]))
        close(got, want, 1e-4)
    assert tcache["self"]["length"].tolist() == [[8, 8]] * cfg.n_layers
    assert tcache["position"].tolist() == [8, 8]
    close(tcache["self"]["k"], jcache["self"]["k"], 1e-5)
    close(tcache["self"]["v"], jcache["self"]["v"], 1e-5)
    jtok = jnp.argmax(want, axis=-1).astype(jnp.int32)
    jout = [np.asarray(jtok)]
    for _ in range(7):
        logits, jcache = jmodel.decode_step(jparams, jcache, jtok)
        jtok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        jout.append(np.asarray(jtok))
    step = make_serve_step(model).step_fn
    ttok = torch.argmax(got, dim=-1).to(torch.int32)
    tout = [ttok.numpy()]
    for _ in range(7):
        ttok, tcache = step(params, tcache, ttok)
        tout.append(ttok.numpy())
    np.testing.assert_array_equal(np.stack(tout, 1), np.stack(jout, 1))
    res = tserve.serve(model, params, torch.tensor(toks), 8, max_len=20,
                       frames=torch.tensor(f))
    np.testing.assert_array_equal(res.tokens.numpy(), np.stack(jout, 1))


@pytest.mark.parametrize("prompt", [4, 13])
def test_decode_matches_forward_in_port(prompt):
    cfg = tget(ARCH).reduced()
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(19))
    f = torch.tensor(frames(cfg, 2, 16, 20))
    toks = torch.tensor(tokens(cfg, 2, prompt + 1, 21))
    full = model.logits(params, {"frames": f, "tokens": toks})
    res = tserve.serve(model, params, toks[:, :prompt], 4,
                       max_len=prompt + 4, frames=f, keep_prompt_logits=True)
    torch.testing.assert_close(res.prompt_logits, full, atol=2e-3,
                               rtol=2e-3)
    assert torch.equal(res.tokens[:, 0],
                       torch.argmax(full[:, -1], -1).to(torch.int32))


def test_decode_needs_frames():
    cfg = tget(ARCH).reduced()
    with pytest.raises(ValueError, match="frames"):
        tbuild(cfg).decode_init(None, {"tokens": torch.zeros(2, 1)}, 8)


# ---------------------------------------------------------------------------
# serving: cache bytes, the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cache_bytes_count_a_built_cache(dtype):
    """``cache_bytes`` equals the float bytes of a built whisper cache:
    every layer's self k/v of ``max_len`` positions and cross k/v of
    ``encoder_seq_len`` positions, in ``dtype``."""
    cfg = tget(ARCH).reduced()
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(22))
    cache = model.decode_init(
        params, {"tokens": torch.zeros(3, 1, dtype=torch.int32),
                 "frames": torch.zeros(3, cfg.encoder_seq_len,
                                       cfg.d_model)}, 24, dtype=dtype)
    built = sum(t.nbytes for t in tree_leaves(cache)
                if t.is_floating_point())
    assert tserve.cache_bytes(cfg, 3, 24, dtype) == built


def test_cache_bytes_of_decode_32k(monkeypatch):
    """whisper at decode_32k (128 requests) needs 687.2 GB of self cache
    and 31.5 GB of cross cache in bf16, so ``serve_shape`` refuses it on
    an 80 GB card before allocating anything."""
    cfg = tget(ARCH)
    shape = T_SHAPES["decode_32k"]
    n = tserve.cache_bytes(cfg, 128, shape.seq_len, torch.bfloat16)
    self_kv = 32 * 2 * 128 * 32_768 * 20 * 64 * 2
    cross = 32 * 2 * 128 * 1500 * 20 * 64 * 2
    assert n == self_kv + cross
    assert round(self_kv / 1e9, 1) == 687.2 and round(cross / 1e9, 1) == 31.5
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (80 * 10 ** 9, 80 * 10 ** 9))
    with pytest.raises(ValueError, match="whisper-large-v3 at decode_32k"):
        tserve.serve_shape(cfg, shape, 1)


def test_serve_shape_defaults_to_zero_frames():
    """``serve_shape`` decodes from frames of zeros in the activation dtype
    (float32 reduced), as the JAX launcher does: the same tokens as frames
    of zeros passed in."""
    cfg = tget(ARCH).reduced()
    shape = dataclasses.replace(T_SHAPES["decode_32k"], seq_len=16,
                                global_batch=2)
    a = tserve.serve_shape(cfg, shape, 3, device="cpu")
    b = tserve.serve_shape(cfg, shape, 3, device="cpu", frames=torch.zeros(
        2, cfg.encoder_seq_len, cfg.d_model))
    assert torch.equal(a.tokens, b.tokens) and a.tokens.shape == (2, 3)


def test_whisper_is_the_published_config():
    """whisper-large-v3 (arXiv:2212.04356): 32 + 32 layers, d_model 1280,
    20 heads of 64, d_ff 5120, vocab 51,866, 1500 encoder frames;
    LayerNorm, GELU, QKV bias, no rope. ``param_count``, the JAX
    package's approximate count, gives 1.43 G: it leaves out the cross
    attention's k and v, the biases and norms, and the (32,768, 1280)
    learned positions, with which the tree holds about 1.58 G."""
    c = tget(ARCH)
    assert (c.family, c.n_layers, c.n_encoder_layers, c.d_model, c.n_heads,
            c.n_kv_heads, c.resolved_head_dim, c.d_ff, c.vocab_size,
            c.encoder_seq_len) == ("encdec", 32, 32, 1280, 20, 20, 64, 5120,
                                   51_866, 1500)
    assert (c.norm_type, c.mlp_type, c.qkv_bias, c.use_rope,
            c.tie_embeddings) == ("layernorm", "gelu", True, False, True)
    params = tbuild(c.reduced()).init(torch.Generator().manual_seed(0))
    assert set(params) == {"enc_blocks", "enc_norm", "embed", "pos_embed",
                           "dec_blocks", "dec_norm"}
    assert tfa.HEAD_DIMS.count(c.resolved_head_dim) == 1
    assert round(c.param_count() / 1e9, 2) == 1.43


@pytest.mark.gpu
def test_reduced_model_on_card_matches_cpu():
    """Reduced whisper in float32 with the flash kernel on the card against
    the plain versions on the CPU: logits at 1e-4 (the encoder's 16 frames
    against 32 decoder positions: non-causal Sq != Skv), 3 n_layers flash
    launches a forward and none of rmsnorm, decode logits at 1e-4 and
    identical greedy tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = tget(ARCH).reduced()
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(23))
    on_card = tree_map(lambda p: p.cuda(), params)
    f = torch.tensor(frames(cfg, 2, cfg.encoder_seq_len, 24))
    toks = torch.tensor(tokens(cfg, 2, 33, 25))
    want = model.logits(params, {"frames": f, "tokens": toks})
    trms.LAUNCHES = tfa.LAUNCHES = 0
    got = model.logits(on_card, {"frames": f.cuda(), "tokens": toks.cuda()})
    assert (tfa.LAUNCHES, trms.LAUNCHES) == (
        cfg.n_encoder_layers + 2 * cfg.n_layers, 0)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    a = tserve.serve(model, params, toks[:, :8], 8, frames=f,
                     keep_prompt_logits=True)
    b = tserve.serve(model, on_card, toks[:, :8].cuda(), 8, frames=f.cuda(),
                     keep_prompt_logits=True)
    torch.testing.assert_close(b.prompt_logits.cpu(), a.prompt_logits,
                               atol=1e-4, rtol=1e-4)
    assert torch.equal(a.tokens, b.tokens.cpu())
