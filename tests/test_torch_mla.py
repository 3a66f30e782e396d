"""Port parity: DeepSeek's Multi-head Latent Attention
(``repro_torch.models.attention``'s ``mla_*``) against the JAX package's.

Inputs come from numpy seeds; the JAX package's ``mla_init`` params are
carried across leaf for leaf. Both sides run on the CPU in float32 at the
reduced deepseek-v2-lite config (kv_lora_rank 32, 16 + 8 query/key
columns, v of 16). Tolerance 1e-5: the prefill (q, k of 24 columns and v
of 16, all padded with zeros to the kernel's head dim 32, through
``ops.flash_attention``'s plain version on the CPU, against JAX's blocked
attention) and the absorbed decode (float32 einsums), its logits and its
(c_kv, k_rope) cache after every step.

The card's test (``gpu``, skipped here) runs the same ``mla_attention``
in float32 with the flash kernel against the CPU, and
the kernel at head dim 192 in bfloat16 against its plain version. A
machine with a card may have no JAX: there the oracle tests skip, e.g.
``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_mla.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tatt
from repro_torch.models.config import MLAConfig
from repro_torch.utils import tree_map

try:                     # the oracle; absent on a machine with only torch
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import attention as jatt
except ImportError:
    jax = None

torch.set_num_threads(2)

ARCH = "deepseek-v2-lite-16b"
TOL = 1e-5


def need_jax():
    if jax is None:
        pytest.skip("needs JAX, the oracle")


def params_pair(seed):
    jcfg = jget(ARCH).reduced()
    params = jax.tree.map(np.asarray, jatt.mla_init(jax.random.key(seed),
                                                    jcfg))
    return jcfg, params, convert.lm_params_from_numpy(params, "cpu")


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("seq", [32, 40])
def test_mla_attention_matches_jax(seq):
    """Prefill MLA against JAX's (blocks of 32 whole and ragged), through
    the flash wrapper's plain version: no kernel launch on the CPU."""
    need_jax()
    jcfg, params, tparams = params_pair(1)
    x = np.random.default_rng(2).normal(size=(2, seq, jcfg.d_model)).astype(
        np.float32)
    want = jatt.mla_attention(params, jcfg, jnp.asarray(x))
    before = tfa.LAUNCHES
    got = tatt.mla_attention(tparams, tget(ARCH).reduced(), torch.tensor(x))
    assert tfa.LAUNCHES == before
    assert got.shape == (2, seq, jcfg.d_model)
    close(got, want)


def test_mla_init_has_jax_structure():
    need_jax()
    jcfg = jget(ARCH).reduced()
    want = jax.tree.map(lambda a: tuple(a.shape),
                        jatt.mla_init(jax.random.key(0), jcfg))
    got = tree_map(lambda a: tuple(a.shape),
                   tatt.mla_init(torch.Generator().manual_seed(0),
                                 tget(ARCH).reduced()))
    assert got == want


def test_mla_decode_steps_and_cache_match_jax():
    """8 absorbed decode steps from an empty cache against JAX's: each
    step's output and, after every step, the (c_kv, k_rope) cache and its
    lengths, at 1e-5. Requests at different lengths come from one batch,
    as the server feeds them."""
    need_jax()
    jcfg, params, tparams = params_pair(3)
    tcfg = tget(ARCH).reduced()
    xs = np.random.default_rng(4).normal(size=(8, 3, 1, jcfg.d_model)).astype(
        np.float32)
    jcache = jatt.init_mla_cache(jcfg, 3, 12, jnp.float32)
    tcache = tatt.init_mla_cache(tcfg, 3, 12, torch.float32)
    for x in xs:
        want, jcache = jatt.mla_decode(params, jcfg, jnp.asarray(x), jcache)
        got, tcache = tatt.mla_decode(tparams, tcfg, torch.tensor(x), tcache)
        close(got, want)
        for name in ("c_kv", "k_rope"):
            close(tcache[name], jcache[name])
        np.testing.assert_array_equal(tcache["length"].numpy(),
                                      np.asarray(jcache["length"]))
    assert tcache["length"].tolist() == [8, 8, 8]


def test_mla_decode_matches_prefill_in_port():
    """The port's absorbed decode against its own prefill MLA over the same
    positions, at 1e-5 (two algebraically equal orders of the products)."""
    cfg = tget(ARCH).reduced()
    params = tatt.mla_init(torch.Generator().manual_seed(5), cfg)
    x = torch.randn(2, 9, cfg.d_model,
                    generator=torch.Generator().manual_seed(6))
    full = tatt.mla_attention(params, cfg, x)
    cache = tatt.init_mla_cache(cfg, 2, 9, torch.float32)
    steps = []
    for t in range(9):
        out, cache = tatt.mla_decode(params, cfg, x[:, t:t + 1], cache)
        steps.append(out)
    torch.testing.assert_close(torch.cat(steps, 1), full, atol=TOL,
                               rtol=TOL)


def test_mla_attention_calls_flash_at_qk_width():
    """The prefill's one flash call sees q, k and v zero-padded to the
    kernel's next head dim, causal, scaled by ``(nope + rope) ** -0.5``: 24
    columns padded to 32 for the reduced config; 192 for deepseek-v2-lite,
    an instantiation of the kernel, where only v is padded."""
    cfg = tget(ARCH).reduced()
    params = tatt.mla_init(torch.Generator().manual_seed(7), cfg)
    seen = []
    real = tatt.ops.flash_attention

    def spy(q, k, v, causal=True, **kw):
        seen.append((q.shape, k.shape, v.shape, causal, kw["scale"],
                     bool((q[..., 24:] == 0).all() and (k[..., 24:] == 0)
                          .all()),
                     bool((v[..., cfg.mla.v_head_dim:] == 0).all())))
        return real(q, k, v, causal=causal, **kw)

    tatt.ops.flash_attention = spy
    try:
        tatt.mla_attention(params, cfg, torch.randn(2, 5, cfg.d_model))
    finally:
        tatt.ops.flash_attention = real
    assert seen == [((2, 5, 4, 32), (2, 5, 4, 32), (2, 5, 4, 32), True,
                     24 ** -0.5, True, True)]
    full = tget(ARCH).mla
    assert full.qk_nope_head_dim + full.qk_rope_head_dim in tfa.HEAD_DIMS


@pytest.mark.gpu
def test_mla_on_card_matches_cpu():
    """Reduced MLA (16 + 8 columns padded to the kernel's 32) in float32:
    prefill through the flash kernel (one launch) and 4 decode
    steps on the card against the CPU at 1e-4; then the kernel at
    deepseek-v2-lite's head dim of 192 in bfloat16 against its plain
    version, at 2^-7 of |want| + P|V| elementwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = tget(ARCH).reduced()
    params = tatt.mla_init(torch.Generator().manual_seed(8), cfg)
    on_card = tree_map(lambda t: t.cuda(), params)
    x = torch.randn(2, 70, cfg.d_model,
                    generator=torch.Generator().manual_seed(9))
    before = tfa.LAUNCHES
    got = tatt.mla_attention(on_card, cfg, x.cuda())
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == before + 1
    torch.testing.assert_close(got.cpu(), tatt.mla_attention(params, cfg, x),
                               atol=1e-4, rtol=1e-4)
    c_cpu = tatt.init_mla_cache(cfg, 2, 4, torch.float32)
    c_card = tatt.init_mla_cache(cfg, 2, 4, torch.float32, device="cuda")
    for t in range(4):
        want, c_cpu = tatt.mla_decode(params, cfg, x[:, t:t + 1], c_cpu)
        got, c_card = tatt.mla_decode(on_card, cfg, x[:, t:t + 1].cuda(),
                                      c_card)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    g = torch.Generator(device="cuda").manual_seed(10)
    q, k, v = (torch.randn(1, 300, 4, 192, generator=g, device="cuda")
               .bfloat16() for _ in range(3))
    out = tfa.flash_attention(q, k, v)
    want = tref.flash_attention_ref(q.float(), k.float(), v.float())
    scale = want.abs() + tref.flash_attention_ref(q.float(), k.float(),
                                                  v.float().abs())
    assert bool(((out.float() - want).abs() <= 1e-5 + 2 ** -7 * scale).all())


def test_reduced_mla_head_dims(monkeypatch):
    """The reduced default attends at 16 + 8 = 24 columns, which the kernel
    is not instantiated at and the wrapper refuses on both devices; the
    zero padding to 32 leaves the prefill what attention at 24 columns
    (the plain version called directly) gives, and a config of 24 + 8 =
    32 columns is not padded."""
    cfg = tget(ARCH).reduced()
    m = cfg.mla
    assert m.qk_nope_head_dim + m.qk_rope_head_dim == 24
    assert 24 not in tfa.HEAD_DIMS and 32 in tfa.HEAD_DIMS
    params = tatt.mla_init(torch.Generator().manual_seed(11), cfg)
    x = torch.randn(2, 7, cfg.d_model,
                    generator=torch.Generator().manual_seed(12))
    b, s, h = 2, 7, cfg.n_heads
    q_nope, q_rope, c_kv, k_rope = tatt._mla_qkv(
        params, cfg, x, torch.arange(s)[None, :])
    k_nope, v = torch.split(
        tatt.dense(params["wkv_b"], c_kv).reshape(
            b, s, h, m.qk_nope_head_dim + m.v_head_dim),
        [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, m.qk_rope_head_dim)], -1)
    out = tref.flash_attention_ref(
        q, k, torch.nn.functional.pad(v, (0, 24 - m.v_head_dim)))
    want = tatt.dense(params["wo"], out[..., :m.v_head_dim].reshape(b, s, -1))
    torch.testing.assert_close(tatt.mla_attention(params, cfg, x), want,
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, k)
    wide = dataclasses.replace(cfg, mla=MLAConfig(
        kv_lora_rank=32, qk_nope_head_dim=24, qk_rope_head_dim=8,
        v_head_dim=16))
    params = tatt.mla_init(torch.Generator().manual_seed(11), wide)
    widths = []
    real = tatt.ops.flash_attention
    monkeypatch.setattr(tatt.ops, "flash_attention", lambda q, k, v, **kw: (
        widths.append((q.shape[-1], bool((q[..., 24:] != 0).any())))
        or real(q, k, v, **kw)))
    assert tatt.mla_attention(params, wide, torch.randn(1, 6, cfg.d_model)
                              ).shape == (1, 6, cfg.d_model)
    assert widths == [(32, True)]
