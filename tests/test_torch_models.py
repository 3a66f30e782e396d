"""Port parity: the LM serving path (``repro_torch.models``,
``repro_torch.launch``) of the dense, MoE (kimi-k2; deepseek-v2-lite with
MLA), SSM (mamba2) and hybrid (zamba2) families against the JAX package's
model zoo (the encoder-decoder and VLM families have their own files,
``test_torch_encdec.py`` and ``test_torch_vlm.py``).

Inputs come from numpy seeds and the JAX package's ``lm_init`` params,
carried across leaf for leaf with ``convert.lm_params_from_numpy``; both
sides run on the CPU in float32 (reduced configs), where the port's kernel
wrappers take their plain versions. Tolerances, stated per test:

- layers: 1e-5 in float32 (the same arithmetic in another op order);
  bfloat16 norms 2e-2 (the output's rounding);
- attention and full forwards: 1e-5 and 1e-4 (two and more matrix products
  in another summation order);
- decode against the port's own forward: atol/rtol 2e-3, the bound of
  ``tests/test_models.py``'s decode-vs-forward test;
- SSM and hybrid decode caches: 1e-5 (float32 state, a few products per
  step);
- MoE forwards, their aux loss and decode steps: 1e-4 (as the dense
  family's), the MoE decode against the port's forward with a capacity
  factor of 64, as ``tests/test_models.py`` sets it, so that no pair drops
  in either and the two route the same tokens to the same experts.

The SSM forwards run 96 positions, three chunks of the reduced config's
32, so the state carried across chunk boundaries is checked (the JAX
suite's own decode test stays inside one chunk).

Greedy tokens must be identical. A machine with a card may have no JAX:
there the oracle tests skip, e.g. ``PYTHONPATH=src python -m pytest
--noconftest -m gpu tests/test_torch_models.py`` runs the ``gpu`` test
alone.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import ARCH_IDS as T_ARCH_IDS
from repro_torch.configs import NOT_PORTED, all_configs
from repro_torch.configs import get_config as tget
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rmsnorm as trms
from repro_torch.kernels import ssd_scan as tscan
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import SHAPES as T_SHAPES
from repro_torch.models import attention as tatt
from repro_torch.models import build_model as tbuild
from repro_torch.models import layers as tl
from repro_torch.models import shape_applicable as t_applicable
from repro_torch.models import transformer as ttr
from repro_torch.utils import tree_leaves

try:                     # the oracle; absent on a machine with only torch
    import jax
    import jax.numpy as jnp

    from repro.configs import ARCH_IDS as J_ARCH_IDS
    from repro.configs import get_config as jget
    from repro.models import SHAPES as J_SHAPES
    from repro.models import attention as jatt
    from repro.models import build_model as jbuild
    from repro.models import layers as jl
    from repro.models import shape_applicable as j_applicable
    from repro.models import transformer as jtr
except ImportError:
    jax = None

torch.set_num_threads(2)

DENSE = ["qwen3-0.6b", "olmo-1b", "qwen2-7b"]
SSM = ["mamba2-1.3b", "zamba2-2.7b"]
MOE = ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"]


def need_jax():
    if jax is None:
        pytest.skip("needs JAX, the oracle")


def rng(seed):
    return np.random.default_rng(seed)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def jax_model(arch, **overrides):
    cfg = jget(arch).reduced(**overrides)
    model = jbuild(cfg)
    return cfg, model, model.init(jax.random.key(0))


def port_cfg(arch, **overrides):
    return tget(arch).reduced(**overrides)


def tokens(cfg, b, s, seed=0):
    return rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# configs and shapes
# ---------------------------------------------------------------------------

# the JAX config's fields that steer its training and kernels; the port
# reads none of them and has none of them
JAX_ONLY_FIELDS = {"scan_layers", "attn_vjp", "attn_block_q",
                   "attn_block_kv", "use_flash_kernel"}


def same_fields(cfg, want):
    """The port's config equals the JAX config on every field the port
    has, and lacks only :data:`JAX_ONLY_FIELDS`."""
    got = dataclasses.asdict(cfg)
    ref = dataclasses.asdict(want)
    assert set(ref) - set(got) == JAX_ONLY_FIELDS
    assert got == {k: v for k, v in ref.items() if k in got}


def test_configs_and_shapes_match_jax():
    need_jax()
    assert T_ARCH_IDS == J_ARCH_IDS
    for arch, cfg in all_configs().items():
        want = jget(arch)
        same_fields(cfg, want)
        same_fields(cfg.reduced(), want.reduced())
        assert cfg.param_count() == want.param_count()
    assert {k: dataclasses.asdict(v) for k, v in T_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    for name, shape in T_SHAPES.items():
        for arch in all_configs():
            assert t_applicable(tget(arch), shape) == j_applicable(
                jget(arch), J_SHAPES[name])


def test_dense_configs_are_ported_and_the_rest_raise():
    """Every configuration of the registry is ported (the name dates from
    when the encoder-decoder and VLM families raised): ``all_configs``
    holds all ten, ``NOT_PORTED`` is empty, and each reduced model's
    training loss is a finite scalar (whisper's from frames, internvl2's
    with a vision prefix)."""
    assert sorted(all_configs()) == sorted(T_ARCH_IDS)
    assert len(T_ARCH_IDS) == 10 and NOT_PORTED == {}
    assert tget("qwen3_0p6b") == tget("qwen3-0.6b")
    assert tget("mamba2_1p3b") == tget("mamba2-1.3b")
    assert tget("deepseek_v2_lite_16b") == tget("deepseek-v2-lite-16b")
    assert tget("whisper_large_v3") == tget("whisper-large-v3")
    assert tget("internvl2_1b") == tget("internvl2-1b")
    for arch, full in all_configs().items():
        cfg = full.reduced()
        model = tbuild(cfg)
        batch = {"tokens": torch.tensor(tokens(cfg, 2, 9))}
        if cfg.family == "encdec":
            batch["frames"] = torch.randn(2, cfg.encoder_seq_len,
                                          cfg.d_model)
        if cfg.family == "vlm":
            batch["prefix_embeds"] = torch.randn(2, cfg.n_vision_tokens,
                                                 cfg.d_model)
        loss = model.loss(model.init(torch.Generator().manual_seed(0)),
                          batch)
        assert loss.shape == () and torch.isfinite(loss), arch


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,parametric,dtype", [
    ("rmsnorm", True, "float32"), ("rmsnorm", True, "bfloat16"),
    ("rmsnorm", False, "float32"), ("layernorm", True, "float32"),
    ("layernorm", False, "float32")])
def test_apply_norm_matches_jax(kind, parametric, dtype):
    need_jax()
    r = rng(1)
    x = r.normal(size=(3, 5, 64)).astype(np.float32)
    params = {}
    if parametric:
        params["scale"] = (1 + 0.1 * r.normal(size=64)).astype(np.float32)
        if kind == "layernorm":
            params["bias"] = (0.1 * r.normal(size=64)).astype(np.float32)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    got = tl.apply_norm({k: torch.tensor(v) for k, v in params.items()}, tx,
                        kind=kind)
    want = jl.apply_norm({k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(x).astype(getattr(jnp, dtype)),
                         kind=kind)
    assert got.dtype == tx.dtype
    close(got.float(), want, 1e-5 if dtype == "float32" else 2e-2)


def test_apply_norm_routes_scaled_rmsnorm_to_the_kernel(monkeypatch):
    calls = []
    real = tl.ops.rmsnorm

    def spy(x, scale, **kw):
        calls.append(x.shape)
        return real(x, scale, **kw)

    monkeypatch.setattr(tl.ops, "rmsnorm", spy)
    x = torch.ones(2, 4, 8)
    tl.apply_norm({"scale": torch.ones(8)}, x)
    tl.apply_norm({}, x)                                    # olmo: plain
    tl.apply_norm({"scale": torch.ones(8), "bias": torch.zeros(8)}, x,
                  kind="layernorm")
    assert calls == [(2, 4, 8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_heads_matches_jax(dtype):
    need_jax()
    r = rng(2)
    x = r.normal(size=(2, 7, 4, 16)).astype(np.float32)
    scale = (1 + 0.1 * r.normal(size=16)).astype(np.float32)
    got = tl.rms_norm_heads(torch.tensor(x).to(getattr(torch, dtype)),
                            torch.tensor(scale))
    want = jl.rms_norm_heads(jnp.asarray(x).astype(getattr(jnp, dtype)),
                             jnp.asarray(scale))
    close(got.float(), want, 1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("hd,theta", [(16, 1e4), (128, 1e6)])
def test_apply_rope_matches_jax(hd, theta):
    need_jax()
    x = rng(3).normal(size=(2, 40, 3, hd)).astype(np.float32)
    for pos in (np.arange(40)[None, :], rng(4).integers(0, 300, (2, 40))):
        got = tl.apply_rope(torch.tensor(x), torch.tensor(pos), theta)
        want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        close(got, want, 1e-4)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_matches_jax(kind):
    need_jax()
    params = to_numpy(jl.mlp_init(jax.random.key(1), 32, 96, kind=kind))
    x = rng(5).normal(size=(2, 6, 32)).astype(np.float32)
    got = tl.mlp(convert.lm_params_from_numpy(params, "cpu"),
                 torch.tensor(x), kind=kind)
    want = jl.mlp(params, jnp.asarray(x), kind=kind)
    close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [32, 40])
@pytest.mark.parametrize("arch", DENSE)
def test_attention_matches_jax_blocked(arch, seq):
    """The port's ``attention`` (the flash kernel's plain version on the
    CPU) against JAX's blocked attention (its ``use_flash_kernel=False``
    path): GQA with qk-norm (qwen3), plain MHA (olmo), QKV bias (qwen2),
    with and without a ragged last tile of the JAX blocks."""
    need_jax()
    jcfg = jget(arch).reduced()
    assert not jcfg.use_flash_kernel
    params = to_numpy(jatt.attention_init(jax.random.key(2), jcfg))
    x = rng(6).normal(size=(2, seq, jcfg.d_model)).astype(np.float32)
    want = jatt.attention(params, jcfg, jnp.asarray(x))
    tcfg = port_cfg(arch)
    before = tfa.LAUNCHES
    got = tatt.attention(convert.lm_params_from_numpy(params, "cpu"), tcfg,
                         torch.tensor(x))
    assert tfa.LAUNCHES == before
    close(got, want, 1e-5)


def test_cached_attention_matches_jax():
    need_jax()
    r = rng(10)
    q = r.normal(size=(3, 1, 4, 16)).astype(np.float32)
    kc, vc = (r.normal(size=(3, 12, 2, 16)).astype(np.float32)
              for _ in range(2))
    length = np.array([1, 7, 12], np.int32)
    got = tatt.cached_attention(*(torch.tensor(a) for a in (q, kc, vc,
                                                             length)))
    want = jatt.cached_attention(*(jnp.asarray(a) for a in (q, kc, vc,
                                                             length)))
    close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_lm_params_carry_over_leaf_for_leaf():
    need_jax()
    cfg, _, params = jax_model("qwen2-7b")
    tree = to_numpy(params)
    got = convert.lm_params_from_numpy(tree, "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in flat_j:
        node = got
        for p in path:
            node = node[p.key]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), leaf)
    serving = convert.lm_params_from_numpy(tree, "cpu", dtype=torch.bfloat16)
    assert serving["blocks"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert serving["blocks"]["attn"]["wq"]["b"].dtype == torch.float32
    assert serving["embed"]["table"].dtype == torch.bfloat16
    assert serving["final_norm"]["scale"].dtype == torch.float32
    assert serving["unembed"]["w"].dtype == torch.bfloat16


def test_ssm_lm_params_carry_over_leaf_for_leaf():
    """zamba2's JAX params (``blocks.ssm.*`` stacked over the layers,
    ``shared_attn.*``) reach the port leaf for leaf; the bf16 serving copy
    keeps every SSM vector float32."""
    need_jax()
    _, _, params = jax_model("zamba2-2.7b")
    tree = to_numpy(params)
    got = convert.lm_params_from_numpy(tree, "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat_j) == len(tree_leaves(got))
    for path, leaf in flat_j:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), leaf)
    assert {"blocks", "shared_attn"} <= set(got)
    serving = convert.lm_params_from_numpy(tree, "cpu", dtype=torch.bfloat16)
    assert serving["blocks"]["ssm"]["out_proj"]["w"].dtype == torch.bfloat16
    assert serving["blocks"]["ssm"]["conv_w"].dtype == torch.float32
    assert serving["shared_attn"]["ffn"]["wo"]["w"].dtype == torch.bfloat16


def test_lm_init_has_jax_structure():
    need_jax()
    for arch in DENSE + SSM:
        _, _, jp = jax_model(arch)
        tp = tbuild(port_cfg(arch)).init(torch.Generator().manual_seed(0))
        shapes_j = jax.tree.map(lambda a: tuple(a.shape), jp)
        shapes_t = ttr.tree_map(lambda a: tuple(a.shape), tp)
        assert shapes_t == shapes_j, arch
        std = float(tp["embed"]["table"].std())
        assert 0.018 < std < 0.022


@pytest.mark.parametrize("seq", [41, 70])
@pytest.mark.parametrize("arch", DENSE)
def test_lm_forward_matches_jax(arch, seq):
    """Reduced f32 forwards (qwen3: GQA + qk-norm + tied; olmo:
    non-parametric LayerNorm; qwen2: QKV bias + untied read-out), against
    the JAX model's blocked attention; 40 and 69 positions (a JAX block
    of 32 whole or ragged)."""
    need_jax()
    cfg, model, params = jax_model(arch)
    toks = tokens(cfg, 2, seq, seed=1)
    want = model.logits(params, {"tokens": jnp.asarray(toks)})
    tmodel = tbuild(port_cfg(arch))
    got = tmodel.logits(convert.lm_params_from_numpy(to_numpy(params),
                                                     "cpu"),
                        {"tokens": torch.tensor(toks)})
    assert got.shape == (2, seq - 1, cfg.vocab_size)
    close(got, want, 1e-4)


def test_decode_steps_and_greedy_tokens_match_jax():
    """8 decode steps of reduced qwen3-0.6b (teacher forced) against JAX's,
    then the serve step's greedy tokens against JAX's decode + argmax (what
    its serve step computes)."""
    need_jax()
    cfg, model, params = jax_model("qwen3-0.6b")
    tparams = convert.lm_params_from_numpy(to_numpy(params), "cpu")
    tmodel = tbuild(port_cfg("qwen3-0.6b"))
    toks = tokens(cfg, 2, 8, seed=2)
    jcache = model.decode_init(params, {"tokens": jnp.asarray(toks)}, 20,
                               dtype=jnp.float32)
    tcache = tmodel.decode_init(tparams, {"tokens": torch.tensor(toks)}, 20,
                                dtype=torch.float32)
    for t in range(8):
        want, jcache = model.decode_step(params, jcache,
                                         jnp.asarray(toks[:, t]))
        got, tcache = tmodel.decode_step(tparams, tcache,
                                         torch.tensor(toks[:, t]))
        close(got, want, 1e-4)
    assert tcache["stack"]["length"].tolist() == [[8, 8]] * cfg.n_layers
    close(tcache["stack"]["k"], jcache["stack"]["k"], 1e-5)
    close(tcache["stack"]["v"], jcache["stack"]["v"], 1e-5)
    # greedy: 8 more tokens from both
    jtok = jnp.argmax(want, axis=-1).astype(jnp.int32)
    jout = [np.asarray(jtok)]
    for _ in range(7):
        logits, jcache = model.decode_step(params, jcache, jtok)
        jtok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        jout.append(np.asarray(jtok))
    step = make_serve_step(tmodel).step_fn
    ttok = torch.argmax(got, dim=-1).to(torch.int32)
    tout = [ttok.numpy()]
    for _ in range(7):
        ttok, tcache = step(tparams, tcache, ttok)
        tout.append(ttok.numpy())
    np.testing.assert_array_equal(np.stack(tout, 1), np.stack(jout, 1))
    # the launcher's loop gives the same tokens from the same prompts
    res = tserve.serve(tmodel, tparams, torch.tensor(toks), 8, max_len=20)
    np.testing.assert_array_equal(res.tokens.numpy(), np.stack(jout, 1))


@pytest.mark.parametrize("prompt", [8, 13])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward_in_port(arch, prompt):
    """The port's decode logits against its own teacher-forced forward, at
    the bound of tests/test_models.py (2e-3)."""
    cfg = port_cfg(arch)
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    toks = torch.tensor(tokens(cfg, 2, prompt + 1, seed=3))
    full = model.logits(params, {"tokens": toks})
    res = tserve.serve(model, params, toks[:, :prompt], 4,
                       max_len=prompt + 4, keep_prompt_logits=True)
    torch.testing.assert_close(res.prompt_logits, full, atol=2e-3,
                               rtol=2e-3)
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == torch.int32
    assert torch.equal(res.tokens[:, 0],
                       torch.argmax(full[:, -1], -1).to(torch.int32))


def test_ssm_configs_are_the_published_widths():
    """mamba2-1.3b and zamba2-2.7b at their published widths
    (the JAX package's configs, checked field for field above)."""
    m, z = tget("mamba2-1.3b"), tget("zamba2-2.7b")
    assert (m.family, m.n_layers, m.d_model, m.vocab_size,
            m.tie_embeddings) == ("ssm", 48, 2048, 50_280, True)
    assert (m.ssm.expand * m.d_model // m.ssm.head_dim, m.ssm.head_dim,
            m.ssm.state_size, m.ssm.n_groups, m.ssm.chunk_size) == (
                64, 64, 128, 1, 256)
    assert (z.family, z.n_layers, z.d_model, z.hybrid_attn_period,
            z.n_heads, z.resolved_head_dim, z.d_ff) == (
                "hybrid", 54, 2560, 6, 32, 80, 10_240)
    assert (z.ssm.expand * z.d_model // z.ssm.head_dim,
            z.ssm.state_size) == (80, 64)
    assert tfa.HEAD_DIMS.count(z.resolved_head_dim) == 1


@pytest.mark.parametrize("arch", SSM)
def test_ssm_lm_forward_matches_jax(arch):
    """Reduced f32 mamba2 (tied read-out) and zamba2 (the shared
    attention+MLP block after every 2 layers, untied read-out) over 96
    positions, three chunks of 32, against the JAX model."""
    need_jax()
    cfg, model, params = jax_model(arch)
    assert cfg.ssm.chunk_size == 32
    toks = tokens(cfg, 2, 97, seed=6)
    want = model.logits(params, {"tokens": jnp.asarray(toks)})
    got = tbuild(port_cfg(arch)).logits(
        convert.lm_params_from_numpy(to_numpy(params), "cpu"),
        {"tokens": torch.tensor(toks)})
    assert got.shape == (2, 96, cfg.vocab_size)
    close(got, want, 1e-4)


@pytest.mark.parametrize("arch", SSM)
def test_ssm_decode_steps_and_greedy_tokens_match_jax(arch):
    """8 teacher-forced decode steps of reduced mamba2 / zamba2 against
    JAX's: logits (1e-4), every cache leaf (1e-5: SSM state and conv
    buffer, zamba2's shared k/v and lengths), then 8 greedy tokens."""
    need_jax()
    cfg, model, params = jax_model(arch)
    tparams = convert.lm_params_from_numpy(to_numpy(params), "cpu")
    tmodel = tbuild(port_cfg(arch))
    toks = tokens(cfg, 2, 8, seed=7)
    jcache = model.decode_init(params, {"tokens": jnp.asarray(toks)}, 20,
                               dtype=jnp.float32)
    tcache = tmodel.decode_init(tparams, {"tokens": torch.tensor(toks)}, 20,
                                dtype=torch.float32)
    assert (ttr.tree_map(lambda a: tuple(a.shape), tcache)
            == jax.tree.map(lambda a: tuple(a.shape), jcache))
    for t in range(8):
        want, jcache = model.decode_step(params, jcache,
                                         jnp.asarray(toks[:, t]))
        got, tcache = tmodel.decode_step(tparams, tcache,
                                         torch.tensor(toks[:, t]))
        close(got, want, 1e-4)
    flat_j = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert len(flat_j) == len(tree_leaves(tcache))
    for path, leaf in flat_j:
        node = tcache
        for p in path:
            node = node[p.key]
        close(node, leaf, 1e-5)
    jtok = jnp.argmax(want, axis=-1).astype(jnp.int32)
    jout = [np.asarray(jtok)]
    for _ in range(7):
        logits, jcache = model.decode_step(params, jcache, jtok)
        jtok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        jout.append(np.asarray(jtok))
    step = make_serve_step(tmodel).step_fn
    ttok = torch.argmax(got, dim=-1).to(torch.int32)
    tout = [ttok.numpy()]
    for _ in range(7):
        ttok, tcache = step(tparams, tcache, ttok)
        tout.append(ttok.numpy())
    np.testing.assert_array_equal(np.stack(tout, 1), np.stack(jout, 1))


@pytest.mark.parametrize("arch,prompt", [("mamba2-1.3b", 64),
                                         ("zamba2-2.7b", 64),
                                         ("mamba2-1.3b", 13)])
def test_ssm_decode_matches_forward_in_port(arch, prompt):
    """The port's decode logits against its own forward over a prompt of
    two chunks (and one shorter than a chunk), at 2e-3; the decode step
    runs no scan."""
    cfg = port_cfg(arch)
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(5))
    toks = torch.tensor(tokens(cfg, 2, prompt + 1, seed=8))
    full = model.logits(params, {"tokens": toks})
    res = tserve.serve(model, params, toks[:, :prompt], 4,
                       keep_prompt_logits=True)
    torch.testing.assert_close(res.prompt_logits, full, atol=2e-3,
                               rtol=2e-3)
    assert torch.equal(res.tokens[:, 0],
                       torch.argmax(full[:, -1], -1).to(torch.int32))


def test_ssm_serving_params_keep_ssm_leaves_float32():
    """The bf16 serving copy of zamba2 holds only ``w`` and ``table`` in
    bf16 (conv_w, a_log, d_skip, dt_bias, norm_scale, norms stay float32)
    and gives bit-identical logits and decode steps to its float32
    params."""
    cfg = port_cfg("zamba2-2.7b", dtype="bfloat16")
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(6))
    serving = model.serving_params(params)
    ssm = serving["blocks"]["ssm"]
    assert ssm["in_proj"]["w"].dtype == torch.bfloat16
    assert serving["shared_attn"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    for name in ("conv_w", "conv_b", "a_log", "d_skip", "dt_bias",
                 "norm_scale"):
        assert ssm[name].dtype == torch.float32, name
    toks = torch.tensor(tokens(cfg, 2, 9, seed=9))
    assert torch.equal(model.logits(params, {"tokens": toks}),
                       model.logits(serving, {"tokens": toks}))
    a = tserve.serve(model, params, toks, 3, keep_prompt_logits=True)
    b = tserve.serve(model, serving, toks, 3, keep_prompt_logits=True)
    assert torch.equal(a.prompt_logits, b.prompt_logits)
    assert torch.equal(a.tokens, b.tokens)


def test_serving_params_give_the_same_numbers():
    """A bfloat16 model's serving copy (matrices bf16, scales f32) gives
    bit-identical logits and decode steps to its float32 params."""
    cfg = port_cfg("qwen2-7b", dtype="bfloat16")
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(2))
    serving = model.serving_params(params)
    toks = torch.tensor(tokens(cfg, 2, 7, seed=4))
    assert torch.equal(model.logits(params, {"tokens": toks}),
                       model.logits(serving, {"tokens": toks}))
    a = tserve.serve(model, params, toks, 3, keep_prompt_logits=True)
    b = tserve.serve(model, serving, toks, 3, keep_prompt_logits=True)
    assert torch.equal(a.prompt_logits, b.prompt_logits)
    assert torch.equal(a.tokens, b.tokens)


def test_rmsnorm_launch_count_on_the_path_is_zero_on_cpu():
    """On the CPU every norm takes the plain version: no launch is
    counted (the card's counts are ``chip_smoke.py``'s)."""
    cfg = port_cfg("qwen3-0.6b")
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(3))
    before = (trms.LAUNCHES, tfa.LAUNCHES)
    model.logits(params, {"tokens": torch.zeros(1, 5, dtype=torch.int64)})
    assert (trms.LAUNCHES, tfa.LAUNCHES) == before


@pytest.mark.parametrize("arch", ["qwen3-0.6b"] + SSM + MOE
                         + ["whisper-large-v3", "internvl2-1b"])
def test_serve_cli_runs_on_cpu(capsys, arch):
    res = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--new-tokens", "4"])
    assert res.tokens.shape == (2, 4)
    assert "tok/s on cpu" in capsys.readouterr().out
    with pytest.raises(ValueError):
        tserve.serve(tbuild(port_cfg("qwen3-0.6b")), None,
                     torch.zeros(1, 4, dtype=torch.int32), 8, max_len=6)


def test_cache_bytes_of_decode_32k():
    """qwen3-0.6b's decode_32k cache (batch 128) is 481 GB in bf16: more
    than one card holds."""
    n = tserve.cache_bytes(tget("qwen3-0.6b"), 128, 32_768, torch.bfloat16)
    assert n == 2 * 28 * 128 * 32_768 * 8 * 128 * 2
    assert 480e9 < n < 482e9


def float_bytes(cache) -> int:
    return sum(t.nbytes for t in tree_leaves(cache)
               if t.is_floating_point())


@pytest.mark.parametrize("arch,dtype", [
    ("qwen3-0.6b", torch.bfloat16), ("mamba2-1.3b", torch.bfloat16),
    ("zamba2-2.7b", torch.bfloat16), ("zamba2-2.7b", torch.float32),
    ("olmo-1b", torch.float32), ("deepseek-v2-lite-16b", torch.bfloat16),
    ("deepseek-v2-lite-16b", torch.float32),
    ("kimi-k2-1t-a32b", torch.bfloat16), ("internvl2-1b", torch.bfloat16)])
def test_cache_bytes_count_a_built_cache(arch, dtype):
    """``cache_bytes`` per family equals the bytes of the float leaves of
    a built reduced cache: dense k/v in ``dtype``; SSM state and conv in
    float32 whatever ``dtype``; zamba2 both, its k/v one per application
    of the shared block; MLA's (c_kv, k_rope) in ``dtype``, the leading
    dense layer's (the ``dense`` list) included, as a MoE model's dense
    k/v are."""
    cfg = port_cfg(arch)
    cache = tbuild(cfg).decode_init(
        None, {"tokens": torch.zeros(3, 1, dtype=torch.int32)}, 24,
        dtype=dtype)
    assert tserve.cache_bytes(cfg, 3, 24, dtype) == float_bytes(cache)


def test_cache_bytes_of_ssm_decode_32k(monkeypatch):
    """mamba2-1.3b at decode_32k (128 requests) needs 48 x 275,120,128 B of
    float32 state and conv, whatever the cache length: it fits one card.
    zamba2-2.7b needs 9.5 GB of SSM state and about 387 GB of shared k/v
    in bf16, so ``serve_shape`` refuses it on an 80 GB card before
    allocating anything."""
    shape = T_SHAPES["decode_32k"]
    m = tserve.cache_bytes(tget("mamba2-1.3b"), 128, shape.seq_len,
                           torch.bfloat16)
    assert m == 48 * 275_120_128 == 13_205_766_144
    z = tget("zamba2-2.7b")
    ssm_part = tserve.cache_bytes(z, 128, 0, torch.bfloat16)
    assert ssm_part == 54 * 128 * (80 * 64 * 64 + 3 * (5120 + 128)) * 4
    kv = tserve.cache_bytes(z, 128, shape.seq_len, torch.bfloat16) - ssm_part
    assert kv == 2 * 9 * 128 * 32_768 * 32 * 80 * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (80 * 10 ** 9, 80 * 10 ** 9))
    with pytest.raises(ValueError, match="zamba2-2.7b at decode_32k"):
        tserve.serve_shape(z, shape, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", SSM)
def test_reduced_ssm_model_on_card_matches_cpu(arch):
    """Reduced mamba2 / zamba2 in float32 with the kernels on the card
    against the plain versions on the CPU over two chunks: logits at 1e-4,
    identical greedy tokens, and the launch counts of one forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = port_cfg(arch)
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(7))
    on_card = ttr.tree_map(lambda p: p.cuda(), params)
    toks = torch.tensor(tokens(cfg, 2, 65, seed=10))
    want = model.logits(params, {"tokens": toks})
    trms.LAUNCHES = tfa.LAUNCHES = tscan.LAUNCHES = 0
    got = model.logits(on_card, {"tokens": toks.cuda()})
    apps = cfg.n_layers // cfg.hybrid_attn_period if cfg.hybrid_attn_period \
        else 0
    assert (tscan.LAUNCHES, tfa.LAUNCHES, trms.LAUNCHES) == (
        cfg.n_layers, apps, 2 * cfg.n_layers + 2 * apps + 1)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    a = tserve.serve(model, params, toks[:, :8], 8)
    b = tserve.serve(model, on_card, toks[:, :8].cuda(), 8)
    assert torch.equal(a.tokens, b.tokens.cpu())


@pytest.mark.gpu
def test_reduced_model_on_card_matches_cpu():
    """Reduced qwen3-0.6b in float32 with the kernels on the card against
    the plain versions on the CPU: logits at 1e-4, identical greedy
    tokens, and the launch counts of one forward and one decode step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = port_cfg("qwen3-0.6b")
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(4))
    on_card = ttr.tree_map(lambda p: p.cuda(), params)
    toks = torch.tensor(tokens(cfg, 2, 33, seed=5))
    want = model.logits(params, {"tokens": toks})
    trms.LAUNCHES = tfa.LAUNCHES = 0
    got = model.logits(on_card, {"tokens": toks.cuda()})
    assert (tfa.LAUNCHES, trms.LAUNCHES) == (cfg.n_layers,
                                             2 * cfg.n_layers + 1)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    a = tserve.serve(model, params, toks[:, :8], 8)
    b = tserve.serve(model, on_card, toks[:, :8].cuda(), 8)
    assert torch.equal(a.tokens, b.tokens.cpu())


# ---------------------------------------------------------------------------
# MoE (kimi-k2) and MoE + MLA (deepseek-v2-lite)
# ---------------------------------------------------------------------------

def high_capacity(cfg):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))


def test_moe_lm_params_carry_over_leaf_for_leaf():
    """deepseek-v2-lite's JAX params reach the port leaf for leaf: the
    ``dense_blocks`` list and the (layers, E, in, out) expert stacks. The
    bf16 serving copy keeps the router and MLA's wkv_b float32 (read in
    float32 by the routing and the absorbed decode) and the kv_norm scale
    float32."""
    need_jax()
    _, _, params = jax_model("deepseek-v2-lite-16b")
    tree = to_numpy(params)
    got = convert.lm_params_from_numpy(tree, "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat_j) == len(tree_leaves(got))
    for path, leaf in flat_j:
        node = got
        for p in path:
            node = node[p.idx if hasattr(p, "idx") else p.key]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), leaf)
    assert isinstance(got["dense_blocks"], list)
    assert got["blocks"]["ffn"]["experts"]["wi"]["w"].dim() == 4
    serving = convert.lm_params_from_numpy(tree, "cpu", dtype=torch.bfloat16)
    blk = serving["blocks"]
    assert blk["ffn"]["experts"]["wo"]["w"].dtype == torch.bfloat16
    assert blk["ffn"]["shared"]["wg"]["w"].dtype == torch.bfloat16
    assert blk["ffn"]["router"]["w"].dtype == torch.float32
    assert blk["attn"]["wkv_b"]["w"].dtype == torch.float32
    assert blk["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert blk["attn"]["kv_norm"].dtype == torch.float32
    assert serving["dense_blocks"][0]["ffn"]["wi"]["w"].dtype == \
        torch.bfloat16


@pytest.mark.parametrize("arch", MOE)
def test_moe_lm_init_has_jax_structure(arch):
    need_jax()
    _, _, jp = jax_model(arch)
    tp = tbuild(port_cfg(arch)).init(torch.Generator().manual_seed(0))
    shapes_j = jax.tree.map(lambda a: tuple(a.shape), jp)
    shapes_t = ttr.tree_map(lambda a: tuple(a.shape), tp)
    assert shapes_t == shapes_j


@pytest.mark.parametrize("seq", [41, 70])
@pytest.mark.parametrize("arch", MOE)
def test_moe_lm_forward_matches_jax(arch, seq):
    """Reduced f32 forwards of deepseek-v2-lite (MLA, 1 dense + 1 MoE
    layer, shared expert) and kimi-k2 (GQA, the same layout) against the
    JAX model: logits and the aux loss at 1e-4."""
    need_jax()
    cfg, model, params = jax_model(arch)
    toks = tokens(cfg, 2, seq, seed=11)
    want, want_aux = jtr.lm_forward(params, cfg, jnp.asarray(toks[:, :-1]))
    got, got_aux = ttr.lm_forward(
        convert.lm_params_from_numpy(to_numpy(params), "cpu"),
        port_cfg(arch), torch.tensor(toks[:, :-1]))
    assert got.shape == (2, seq - 1, cfg.vocab_size)
    close(got, want, 1e-4)
    close(got_aux, want_aux, 1e-4)
    assert float(got_aux) > 0


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_steps_and_greedy_tokens_match_jax(arch):
    """8 teacher-forced decode steps of reduced deepseek-v2-lite / kimi-k2
    against JAX's (logits at 1e-4; every cache leaf, the ``dense`` list's
    included, at 1e-5), then 8 greedy tokens, identical."""
    need_jax()
    cfg, model, params = jax_model(arch)
    tparams = convert.lm_params_from_numpy(to_numpy(params), "cpu")
    tmodel = tbuild(port_cfg(arch))
    toks = tokens(cfg, 2, 8, seed=12)
    jcache = model.decode_init(params, {"tokens": jnp.asarray(toks)}, 20,
                               dtype=jnp.float32)
    tcache = tmodel.decode_init(tparams, {"tokens": torch.tensor(toks)}, 20,
                                dtype=torch.float32)
    for t in range(8):
        want, jcache = model.decode_step(params, jcache,
                                         jnp.asarray(toks[:, t]))
        got, tcache = tmodel.decode_step(tparams, tcache,
                                         torch.tensor(toks[:, t]))
        close(got, want, 1e-4)
    flat_j = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert len(flat_j) == len(tree_leaves(tcache))
    for path, leaf in flat_j:
        node = tcache
        for p in path:
            node = node[p.idx if hasattr(p, "idx") else p.key]
        close(node, leaf, 1e-5)
    jtok = jnp.argmax(want, axis=-1).astype(jnp.int32)
    jout = [np.asarray(jtok)]
    for _ in range(7):
        logits, jcache = model.decode_step(params, jcache, jtok)
        jtok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        jout.append(np.asarray(jtok))
    step = make_serve_step(tmodel).step_fn
    ttok = torch.argmax(got, dim=-1).to(torch.int32)
    tout = [ttok.numpy()]
    for _ in range(7):
        ttok, tcache = step(tparams, tcache, ttok)
        tout.append(ttok.numpy())
    np.testing.assert_array_equal(np.stack(tout, 1), np.stack(jout, 1))


@pytest.mark.parametrize("prompt", [8, 13])
@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_matches_forward_in_port(arch, prompt):
    """The port's decode logits against its own forward at 2e-3, with a
    capacity factor of 64 (no pair drops in either path)."""
    cfg = high_capacity(port_cfg(arch))
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(13))
    toks = torch.tensor(tokens(cfg, 2, prompt + 1, seed=14))
    full = model.logits(params, {"tokens": toks})
    res = tserve.serve(model, params, toks[:, :prompt], 4,
                       max_len=prompt + 4, keep_prompt_logits=True)
    torch.testing.assert_close(res.prompt_logits, full, atol=2e-3,
                               rtol=2e-3)
    assert torch.equal(res.tokens[:, 0],
                       torch.argmax(full[:, -1], -1).to(torch.int32))


@pytest.mark.parametrize("arch,dtype", [
    ("deepseek-v2-lite-16b", "bfloat16"), ("deepseek-v2-lite-16b", "float32"),
    ("kimi-k2-1t-a32b", "bfloat16"), ("qwen3-0.6b", "bfloat16"),
    ("qwen2-7b", "bfloat16"), ("mamba2-1.3b", "bfloat16"),
    ("zamba2-2.7b", "bfloat16"), ("internvl2-1b", "bfloat16"),
    ("whisper-large-v3", "bfloat16"), ("whisper-large-v3", "float32")])
def test_init_serving_equals_serving_params_bitwise(arch, dtype):
    """The serving copy built a layer at a time (``Model.init_serving``)
    equals ``serving_params(init(gen))`` for the same seed, leaf for leaf
    and bit for bit, in tree and dtype, for every family (so the full-
    width paths that switched to it keep their numbers)."""
    cfg = port_cfg(arch, dtype=dtype)
    model = tbuild(cfg)
    want = model.serving_params(model.init(torch.Generator().manual_seed(3)))
    got = model.init_serving(torch.Generator().manual_seed(3))
    assert ttr.tree_map(lambda a: (tuple(a.shape), a.dtype), got) == \
        ttr.tree_map(lambda a: (tuple(a.shape), a.dtype), want)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(g, w)


def test_moe_serving_params_give_the_same_numbers():
    """A bfloat16 deepseek-v2-lite's serving copy (experts, MLA and dense
    matrices bf16; router, wkv_b and scales f32) gives bit-identical
    logits, aux and decode steps to its float32 params."""
    cfg = port_cfg("deepseek-v2-lite-16b", dtype="bfloat16")
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(15))
    serving = model.serving_params(params)
    toks = torch.tensor(tokens(cfg, 2, 7, seed=16))
    a_logits, a_aux = ttr.lm_forward(params, cfg, toks)
    b_logits, b_aux = ttr.lm_forward(serving, cfg, toks)
    assert torch.equal(a_logits, b_logits) and torch.equal(a_aux, b_aux)
    a = tserve.serve(model, params, toks, 3, keep_prompt_logits=True)
    b = tserve.serve(model, serving, toks, 3, keep_prompt_logits=True)
    assert torch.equal(a.prompt_logits, b.prompt_logits)
    assert torch.equal(a.tokens, b.tokens)


def test_moe_configs_are_the_published_widths():
    """deepseek-v2-lite-16b (arXiv:2405.04434, the Lite config): 27 layers,
    the first dense, 64 routed experts top-6 and 2 shared of width 1408,
    MLA with kv_lora_rank 512 and q/k heads of 128 + 64 (the flash
    kernel's head dim 192); 15.71 G parameters, 2.66 G active."""
    c = tget("deepseek-v2-lite-16b")
    assert (c.n_layers, c.d_model, c.n_heads, c.d_ff, c.vocab_size) == (
        27, 2048, 16, 10_944, 102_400)
    assert (c.moe.n_experts, c.moe.top_k, c.moe.n_shared, c.moe.d_expert,
            c.moe.n_dense_layers, c.moe.capacity_factor,
            c.moe.router_jitter) == (64, 6, 2, 1408, 1, 1.25, 0.0)
    assert (c.mla.kv_lora_rank, c.mla.qk_nope_head_dim,
            c.mla.qk_rope_head_dim, c.mla.v_head_dim) == (512, 128, 64, 128)
    assert tfa.HEAD_DIMS.count(c.mla.qk_nope_head_dim
                               + c.mla.qk_rope_head_dim) == 1
    assert round(c.param_count() / 1e9, 2) == 15.71
    assert round(c.active_param_count() / 1e9, 2) == 2.66
    k = tget("kimi-k2-1t-a32b")
    assert (k.moe.n_experts, k.moe.top_k, k.n_layers) == (384, 8, 61)


def test_cache_bytes_of_mla_decode_32k(monkeypatch):
    """deepseek-v2-lite at decode_32k (128 requests of 32,768 positions)
    needs 27 x 128 x 32,768 x 576 x 2 B = 130 GB of MLA cache in bf16, so
    ``serve_shape`` refuses it on an 80 GB card before allocating
    anything."""
    cfg = tget("deepseek-v2-lite-16b")
    shape = T_SHAPES["decode_32k"]
    n = tserve.cache_bytes(cfg, 128, shape.seq_len, torch.bfloat16)
    assert n == 27 * 128 * 32_768 * 576 * 2
    assert 130e9 < n < 131e9
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (80 * 10 ** 9, 80 * 10 ** 9))
    with pytest.raises(ValueError, match="deepseek-v2-lite-16b at decode_32k"):
        tserve.serve_shape(cfg, shape, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", MOE)
def test_reduced_moe_model_on_card_matches_cpu(arch):
    """Reduced deepseek-v2-lite (MLA at 16 + 8 columns padded to the
    kernel's head dim 32) and kimi-k2 in float32, the kernels on
    the card against the plain versions on the CPU: logits and aux at
    1e-4, identical greedy tokens, and the launch counts of one
    forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = port_cfg(arch)
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(17))
    on_card = ttr.tree_map(lambda p: p.cuda(), params)
    toks = torch.tensor(tokens(cfg, 2, 33, seed=18))
    want, want_aux = ttr.lm_forward(params, cfg, toks)
    trms.LAUNCHES = tfa.LAUNCHES = 0
    got, got_aux = ttr.lm_forward(on_card, cfg, toks.cuda())
    assert (tfa.LAUNCHES, trms.LAUNCHES) == (cfg.n_layers,
                                             2 * cfg.n_layers + 1)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    assert abs(float(got_aux) - float(want_aux)) <= 1e-4
    a = tserve.serve(model, params, toks[:, :8], 8)
    b = tserve.serve(model, on_card, toks[:, :8].cuda(), 8)
    assert torch.equal(a.tokens, b.tokens.cpu())
