"""Port parity: the flash-attention forward kernel ``flash_attention``.

The plain PyTorch version (``repro_torch.kernels.ref.flash_attention_ref``,
which ``repro_torch.kernels.ops.flash_attention`` runs on CPU tensors) is
held against the JAX package's ``ref.flash_attention_ref`` at
``tests/test_kernels.py``'s shapes, GQA included. Not against the Pallas
kernel: it does not run on this tree's JAX (ROADMAP queue 3). Tolerance
1e-5 for float32 (both compute the whole score matrix in float32, in
another summation order). For bfloat16 both compute in float32 and round
the output once, so they differ by at most one bfloat16 step where the
float32 results straddle a rounding boundary: rtol 2^-7, atol 1e-6.

Causal alignment: the port follows the Pallas kernel (kv_pos <= q_pos,
top-left); ``ref.flash_attention_ref`` of the JAX package aligns
bottom-right. The two agree when Sq == Skv, the only case ``attention()``
produces, so the JAX comparisons use Sq == Skv; the top-left alignment for
Sq != Skv is checked against a formula written out here.

The CUDA kernel is held against the plain version on the card by the
``gpu`` test at the end (and by ``chip_smoke.py``), with
``chip_smoke.py``'s tolerance: against the plain version computed in float32
on the same inputs, 1e-5 elementwise in float32. In bfloat16 the kernel
rounds each P entry and the output to bf16 (at most u = 2^-8 relatively),
so its error is at most u (|want| + P|V|), P|V| being attention over |v|:
elementwise 1e-5 + 2u (|want| + P|V|), and a norm-relative error of at
most 5e-3 in every block of 64 query rows of one (batch, head). A machine
with a card
may have no JAX: there the oracle tests skip and the ``gpu`` test runs
alone, e.g. ``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_flash_attention.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tatt

try:                     # the oracle; absent on a machine with only torch
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.kernels import ref as jref
    from repro.models import attention as jatt
except ImportError:
    jnp = jref = None

torch.set_num_threads(2)

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-6, 2 ** -7)}   # atol, rtol
# the kernel vs the plain version in float32: atol, rtol, block limit
KERNEL_TOL = {"float32": (1e-5, 1e-5, None),
              "bfloat16": (1e-5, 2 ** -7, 5e-3)}
# kv tile sizes the dropped-tile check runs at: 64 and 128; the kernel's
# own tiles (read from its source: 128 rows, 64 above head dim 128) must be
# among them
KV_TILES = (64, 128)
SOURCE = Path(tref.__file__).parent / "csrc" / "flash_attention.cu"
# (B, S, Hq, Hkv, hd), causal: tests/test_kernels.py's sweep and GQA case,
# then zamba2's head dim of 80, kimi-k2's of 112 (GQA 8 over 1), MLA's of
# 192 (deepseek-v2-lite) and of its reduced config: 16 + 8 columns padded
# to 32 and scaled by 24 ** -0.5
CASES = [((1, 128, 4, 4, 32), True), ((2, 256, 8, 8, 64), True),
         ((2, 128, 4, 4, 64), False), ((1, 512, 2, 2, 16), True),
         ((2, 128, 8, 2, 32), True), ((2, 96, 4, 4, 80), True),
         ((2, 136, 8, 1, 112), True), ((1, 160, 4, 4, 192), True),
         ((2, 40, 4, 4, 32), True)]
SCALES = {(2, 40, 4, 4, 32): 24 ** -0.5}    # the rest: hd ** -0.5


def need_jax():
    if jnp is None:
        pytest.skip("needs JAX, the oracle")


def inputs(b, sq, skv, hq, hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, hq, hd)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, hd)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, hd)).astype(np.float32))


def close(got, want, dtype):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def block_rel_err(got, want, rows=64):
    """The largest ||got - want|| / ||want|| over blocks of ``rows`` query
    rows of one (batch, head)."""
    b, s, h, d = want.shape
    pad = (0, 0, 0, 0, 0, (-s) % rows)

    def norm(x):
        return torch.nn.functional.pad(x.square(), pad).view(
            b, -1, rows, h, d).sum((2, 4)).sqrt()

    return float((norm(got - want) / norm(want).clamp_min(1e-30)).max())


def check_kernel(got, q, k, v, causal, dtype):
    """``got`` (the kernel, in ``dtype``) against the plain version in
    float32 on the same inputs under ``KERNEL_TOL``."""
    atol, rtol, block = KERNEL_TOL[dtype]
    q, k, v = q.float(), k.float(), v.float()
    want = tref.flash_attention_ref(q, k, v, causal=causal)
    scale = want.abs()
    if dtype == "bfloat16":
        scale = scale + tref.flash_attention_ref(q, k, v.abs(),
                                                 causal=causal)
    err = (got.float() - want).abs()
    assert bool((err <= atol + rtol * scale).all()), float(err.max())
    if block is not None:
        assert block_rel_err(got.float(), want) <= block


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal", CASES)
def test_plain_version_matches_jax_ref(shape, causal, dtype):
    need_jax()
    b, s, hq, hkv, hd = shape
    q, k, v = inputs(b, s, s, hq, hkv, hd, s + hq)
    tq, tk, tv = (torch.tensor(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    scale = SCALES.get(shape)
    got = tops.flash_attention(tq, tk, tv, causal, 64, 64, scale)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    jq, jk, jv = (jnp.asarray(x).astype(getattr(jnp, dtype))
                  for x in (q, k, v))
    close(got.float(), jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                                softmax_scale=scale), dtype)


@pytest.mark.parametrize("seq", [40, 70])
def test_attention_at_head_dim_112_matches_jax_blocked(seq):
    """kimi-k2's attention at its published head dim of 112 (the reduced
    config with ``head_dim=112``: GQA 4 over 2, rope) through the port's
    ``attention`` (the flash wrapper's plain version on the CPU) against
    JAX's blocked attention, at 1e-5; the wrapper refused hd 112 before
    the kernel had an instantiation for it."""
    need_jax()
    jcfg = jget("kimi-k2-1t-a32b").reduced(head_dim=112)
    assert jcfg.resolved_head_dim == 112 and not jcfg.use_flash_kernel
    params = jax.tree.map(np.asarray,
                          jatt.attention_init(jax.random.key(5), jcfg))
    x = np.random.default_rng(seq).normal(
        size=(2, seq, jcfg.d_model)).astype(np.float32)
    want = jatt.attention(params, jcfg, jnp.asarray(x))
    got = tatt.attention(convert.lm_params_from_numpy(params, "cpu"),
                         tget("kimi-k2-1t-a32b").reduced(head_dim=112),
                         torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("sq,skv", [(5, 9), (9, 5), (70, 130)])
def test_causal_mask_is_aligned_top_left(sq, skv):
    """For Sq != Skv, row i sees kv 0..i (the Pallas kernel's mask), with
    no bottom-right shift; written out in float64 here."""
    q, k, v = inputs(1, sq, skv, 4, 2, 16, sq * skv)
    got = tref.flash_attention_ref(*(torch.tensor(x) for x in (q, k, v)),
                                   causal=True)
    kk, vv = np.repeat(k, 2, axis=2), np.repeat(v, 2, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) * 16 ** -0.5
    s = np.where(np.arange(skv)[None, :] <= np.arange(sq)[:, None], s,
                 -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bhqk,bkhd->bqhd", p, vv)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_ops_is_forward_only():
    """Without a gradient ``ops.flash_attention`` is the forward alone (the
    plain version on the CPU); an input that needs a gradient takes the
    differentiable Function, whose backward ``test_torch_train_grads.py``
    holds to JAX's."""
    q, k, v = (torch.tensor(x) for x in inputs(1, 8, 8, 2, 2, 16, 0))
    before = tfa.LAUNCHES
    with torch.no_grad():
        assert tops.flash_attention(q.requires_grad_(), k, v).grad_fn is None
    assert tfa.LAUNCHES == before          # the plain version on the CPU
    out = tops.flash_attention(q, k, v)
    assert out.grad_fn is not None
    torch.testing.assert_close(out, tref.flash_attention_ref(q, k, v))


def test_wrapper_checks_its_inputs():
    q, k, v = (torch.tensor(x) for x in inputs(1, 8, 8, 4, 2, 16, 1))
    with pytest.raises(ValueError):
        tfa.flash_attention(q[..., :12], k[..., :12], v[..., :12])  # hd 12
    qp, kp, vp = (torch.tensor(x) for x in inputs(1, 8, 8, 2, 2, 24, 1))
    with pytest.raises(ValueError):        # the card's rule on the CPU too
        tfa.flash_attention(qp, kp, vp)
    with pytest.raises(ValueError):
        tfa.flash_attention(q[:, :, :3], k, v)        # 3 heads over 2
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v[:, :4])           # k, v differ
    with pytest.raises(TypeError):
        tfa.flash_attention(q, k.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v, block_q=0)


@pytest.mark.parametrize("tile", KV_TILES)
def test_kernel_tolerance_rejects_a_dropped_kv_tile(tile):
    """``KERNEL_TOL`` in bfloat16 passes the plain version rounded to
    bfloat16 (the kernel's output rounding) and rejects the same function
    with one kv tile of ``tile`` rows left out for the rows that see past
    it (the fault ``chip_smoke.py`` plants in the kernel, which skips the
    middle one of the tiles a block visits)."""
    q, k, v = (torch.tensor(x).bfloat16()
               for x in inputs(1, 1024, 1024, 4, 2, 64, 7))
    want = tref.flash_attention_ref(q.float(), k.float(), v.float())
    check_kernel(want.bfloat16(), q, k, v, True, "bfloat16")
    qr = q.float().reshape(1, 1024, 2, 2, 64) * 64 ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.float())
    pos = torch.arange(1024)
    mid = 512 // tile
    skip = (pos[None, :] // tile == mid) & (pos[:, None] >= (mid + 1) * tile)
    s = s.masked_fill((pos[None, :] > pos[:, None]) | skip, -1e30)
    bad = torch.einsum("bhgqk,bkhd->bhgqd", s.softmax(-1), v.float())
    bad = bad.permute(0, 3, 1, 2, 4).reshape(want.shape).bfloat16()
    assert block_rel_err(bad.float(), want) > 4 * KERNEL_TOL["bfloat16"][2]
    with pytest.raises(AssertionError):
        check_kernel(bad, q, k, v, True, "bfloat16")


def test_kernel_instantiates_every_head_dim():
    """The CUDA source's head-dim dispatch lists exactly ``HEAD_DIMS``, and
    its bf16 kv tiles are ones the dropped-tile check runs at."""
    src = SOURCE.read_text()
    found = re.findall(r"hd == (\d+)\) err = launch_hd<(\d+)>", src)
    assert found and all(a == b for a, b in found)
    assert tuple(int(a) for a, _ in found) == tfa.HEAD_DIMS
    tile = re.search(r"return HD > 128 \? (\d+) : (\d+);", src)
    assert tile and {int(tile.group(1)), int(tile.group(2))} <= set(KV_TILES)


@pytest.mark.parametrize("name", sorted(p.stem for p in tbuild.CSRC.glob(
    "*.cu")))
def test_build_fuses_multiply_add_for_flash_only(name):
    """Every kernel but flash attention's forward and backward is built
    with ``-fmad=false``, on which its bit-equality with its plain version
    rests; flash attention, held to a tolerance, is built with fused
    multiply-add."""
    flags = tbuild.nvcc_flags(name)
    assert ("-fmad=false" in flags) == (
        name not in ("flash_attention", "flash_attention_bwd"))
    assert set(tbuild.NVCC_FLAGS) <= set(flags)


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_card():
    """The CUDA kernel against the plain version in float32 on the same
    card tensors, under ``KERNEL_TOL``; ragged lengths, GQA, both masks,
    Sq != Skv (top-left causal, and non-causal as whisper's cross
    attention), every head dim; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [(1, 128, 128, 4, 4, 32, True), (2, 200, 200, 8, 2, 64, True),
             (2, 100, 100, 4, 4, 64, False), (1, 77, 77, 6, 3, 16, True),
             (1, 70, 130, 4, 2, 128, True), (2, 130, 60, 4, 1, 128, False),
             (4, 1024, 1024, 16, 8, 128, True),
             (2, 300, 300, 8, 8, 80, True), (1, 129, 129, 4, 2, 80, False),
             (2, 333, 333, 4, 2, 192, True), (1, 200, 170, 4, 4, 192, False),
             (1, 70, 130, 4, 4, 192, True), (2, 300, 300, 8, 1, 112, True),
             (1, 300, 700, 4, 2, 112, True), (2, 333, 200, 4, 4, 112, False),
             (2, 97, 300, 4, 4, 64, False)]
    for b, sq, skv, hq, hkv, hd, causal in cases:
        for dtype in ("float32", "bfloat16"):
            q, k, v = (torch.tensor(x, device="cuda").to(getattr(torch,
                                                                 dtype))
                       for x in inputs(b, sq, skv, hq, hkv, hd, sq))
            before = tfa.LAUNCHES
            got = tfa.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert tfa.LAUNCHES == before + 1
            check_kernel(got, q, k, v, causal, dtype)
    with pytest.raises(ValueError):                   # not contiguous
        tfa.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError):        # no instantiation at head dim 24
        tfa.flash_attention(*(torch.zeros(1, 8, 2, 24, device="cuda")
                              for _ in range(3)))
