"""Port parity: the backward functions of the three kernels on the LM path
(``flash_attention``, ``rmsnorm``, ``ssd_state_scan``).

Each kernel's ``torch.autograd.Function`` (``FlashAttentionFn``,
``RMSNormFn``, ``SSDStateScanFn``, which ``repro_torch.kernels.ops`` takes
whenever an input needs a gradient) runs its plain forward on CPU tensors
and its plain backward on both devices. Its gradients are held against
two references:

- ``torch.autograd`` of the port's own plain version (``ref.*_ref``) on
  the same inputs, at rtol 1e-5: the same function differentiated two
  ways in float32, in another summation order;
- ``jax.vjp`` of the JAX package's reference (``repro.kernels.ref``), the
  function JAX differentiates (its flash custom VJP recomputes through
  it; its models differentiate the plain norm and scan with XLA), at rtol
  1e-4.

Gradients are compared elementwise with atol = rtol x the largest
magnitude of the reference leaf, so entries near zero are held to the
leaf's scale. Flash runs causal at Sq == Skv (where the JAX reference's
bottom-right causal mask equals the port's top-left one), and non-causal
at Sq == Skv and at Sq != Skv (whisper's cross attention: the reshapes of
q and the cotangent take Sq, those of k and v Skv); GQA; head dims 64,
112 (kimi-k2's), 128, and 192 as MLA calls it (deepseek-v2-lite: q and k
of 128 + 64 columns, v zero-padded from 128, the scale (128 + 64)^-0.5,
and the cotangent zero in v's padded columns, which the model slices
off).

The ``gpu`` test holds the repair that lets gradients through the CUDA
kernels: on CUDA tensors each call returns an output with a ``grad_fn``,
launches its kernel once, and gives the CPU's gradients (flash in bf16
within a bf16 step, the norm and the scan in float32 at 1e-5). It skips
without a card; ``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_train_grads.py`` runs it on the card's machine.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trms
from repro_torch.kernels import ssd_scan as tscan

try:                     # the oracle; absent on a machine with only torch
    import jax
    import jax.numpy as jnp

    from repro.kernels import ref as jref
except ImportError:
    jax = None

torch.set_num_threads(2)

AUTOGRAD_RTOL = 1e-5
JAX_RTOL = 1e-4


def need_jax():
    if jax is None:
        pytest.skip("needs JAX, the oracle")


def close(got, want, rtol):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want.detach().float() if isinstance(want, torch.Tensor)
                      else want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def port_grads(fn, inputs, cotangents):
    """Gradients of sum(out * cotangent) over the outputs of ``fn``."""
    leaves = [torch.tensor(x).requires_grad_() if x is not None else None
              for x in inputs]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    total = sum((o * torch.tensor(c)).sum() for o, c in zip(out, cotangents))
    return out, torch.autograd.grad(total, [x for x in leaves
                                            if x is not None])


def jax_grads(fn, inputs, cotangents):
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in inputs))
    ct = tuple(jnp.asarray(c) for c in cotangents)
    return vjp(ct if isinstance(out, tuple) else ct[0])


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

# MLA's call (models/attention.py::mla_attention at deepseek-v2-lite's
# widths): q and k of nope 128 + rope 64 columns, v of 128 zero-padded to
# the same 192, scores scaled by (128 + 64) ** -0.5
MLA_HD, MLA_V, MLA_SCALE = 192, 128, (128 + 64) ** -0.5

FLASH_CASES = [  # (B, S or (Sq, Skv), Hq, Hkv, hd, causal)
    (2, 40, 4, 4, 64, True), (1, 64, 4, 2, 64, False),
    (2, 33, 8, 2, 128, True), (1, 48, 2, 1, 128, False),
    pytest.param(2, (24, 40), 4, 2, 64, False, id="2-24x40-4-2-64-False"),
    pytest.param(1, (16, 50), 4, 4, 64, False, id="1-16x50-4-4-64-False"),
    pytest.param(2, 33, 4, 4, MLA_HD, True, id="2-33-4-4-192mla-True"),
    pytest.param(1, 40, 4, 2, 112, True, id="1-40-4-2-112-True"),
    pytest.param(1, (20, 36), 8, 2, 112, False, id="1-20x36-8-2-112-False")]


def flash_scale(hd):
    """The score scale a model passes at ``hd``: MLA's at 192, else the
    default hd ** -0.5 (None)."""
    return MLA_SCALE if hd == MLA_HD else None


def flash_inputs(b, s, hq, hkv, hd, seed):
    """q, k, v and the output cotangent g; ``s`` is S or (Sq, Skv). At
    MLA's head dim v's columns past 128 and g's are zero, as the model
    pads v and slices the output."""
    sq, skv = s if isinstance(s, tuple) else (s, s)
    r = np.random.default_rng(seed)
    q = r.normal(size=(b, sq, hq, hd)).astype(np.float32)
    k, v = (r.normal(size=(b, skv, hkv, hd)).astype(np.float32)
            for _ in range(2))
    g = r.normal(size=(b, sq, hq, hd)).astype(np.float32)
    if hd == MLA_HD:
        v[..., MLA_V:] = 0
        g[..., MLA_V:] = 0
    return q, k, v, g


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal", FLASH_CASES)
def test_flash_backward_matches_autograd_of_plain_version(b, s, hq, hkv,
                                                          hd, causal):
    q, k, v, g = flash_inputs(b, s, hq, hkv, hd, 0)
    scale = flash_scale(hd)
    before = tfa.BACKWARD_CALLS
    out, got = port_grads(lambda *x: tops.flash_attention(
        *x, causal=causal, scale=scale), (q, k, v), (g,))
    assert out[0].grad_fn is not None
    assert tfa.BACKWARD_CALLS == before + 1
    _, want = port_grads(lambda *x: tref.flash_attention_ref(
        *x, causal=causal, scale=scale), (q, k, v), (g,))
    for a, w in zip(got, want):
        close(a, w, AUTOGRAD_RTOL)
    if hd == MLA_HD:      # v's zero columns give zero output columns
        assert out[0][..., MLA_V:].abs().max() == 0


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal", FLASH_CASES)
def test_flash_backward_matches_jax_vjp(b, s, hq, hkv, hd, causal):
    need_jax()
    q, k, v, g = flash_inputs(b, s, hq, hkv, hd, 1)
    scale = flash_scale(hd)
    got = tfa.flash_attention_bwd(*(torch.tensor(x) for x in (q, k, v, g)),
                                  causal=causal, scale=scale)
    want = jax_grads(lambda *x: jref.flash_attention_ref(
        *x, causal=causal, softmax_scale=scale), (q, k, v), (g,))
    for a, w in zip(got, want):
        close(a, w, JAX_RTOL)


def test_flash_backward_takes_the_scale():
    """A ``scale`` other than hd ** -0.5 (MLA's, padded q and k) reaches
    the backward: the Function's gradients are autograd's through the plain
    version at that scale."""
    q, k, v, g = flash_inputs(1, 12, 2, 2, 32, 4)
    _, got = port_grads(lambda *x: tops.flash_attention(*x, scale=0.2),
                        (q, k, v), (g,))
    _, want = port_grads(lambda *x: tref.flash_attention_ref(*x, scale=0.2),
                         (q, k, v), (g,))
    for a, w in zip(got, want):
        close(a, w, AUTOGRAD_RTOL)


def test_flash_backward_keeps_the_input_dtype():
    q, k, v, g = (torch.tensor(x).bfloat16()
                  for x in flash_inputs(1, 16, 4, 2, 64, 2))
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, g)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    want = tfa.flash_attention_bwd(q.float(), k.float(), v.float(),
                                   g.float())
    for a, w in zip((dq, dk, dv), want):   # one bf16 rounding of the same
        close(a, w, 2 ** -7)


def test_no_gradient_takes_the_plain_dispatch():
    q, k, v, _ = (torch.tensor(x) for x in flash_inputs(1, 8, 2, 2, 64, 3))
    assert tops.flash_attention(q, k, v).grad_fn is None
    with torch.no_grad():
        assert tops.flash_attention(q.requires_grad_(), k, v).grad_fn is None


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

NORM_CASES = [(6, 64), (3, 37), (2, 5, 128)]


def norm_inputs(shape, seed):
    r = np.random.default_rng(seed)
    x = r.normal(size=shape).astype(np.float32)
    scale = (1 + 0.2 * r.normal(size=shape[-1])).astype(np.float32)
    g = r.normal(size=shape).astype(np.float32)
    return x, scale, g


@pytest.mark.parametrize("shape", NORM_CASES)
def test_rmsnorm_backward_matches_autograd_and_jax(shape):
    x, scale, g = norm_inputs(shape, 4)
    before = trms.BACKWARD_CALLS
    out, got = port_grads(lambda *a: tops.rmsnorm(*a), (x, scale), (g,))
    assert out[0].grad_fn is not None
    assert trms.BACKWARD_CALLS == before + 1
    # dscale is the reduction over every row
    assert got[1].shape == scale.shape
    _, want = port_grads(lambda *a: tref.rmsnorm_ref(*a), (x, scale), (g,))
    for a, w in zip(got, want):
        close(a, w, AUTOGRAD_RTOL)
    need_jax()
    want = jax_grads(lambda *a: jref.rmsnorm_ref(*a), (x, scale), (g,))
    for a, w in zip(got, want):
        close(a, w, JAX_RTOL)


def test_rmsnorm_backward_casts_dx_to_the_input_dtype():
    x, scale, g = (torch.tensor(a) for a in norm_inputs((4, 64), 5))
    dx, dscale = trms.rmsnorm_bwd(x.bfloat16(), scale, g.bfloat16())
    assert (dx.dtype, dscale.dtype) == (torch.bfloat16, torch.float32)
    want_dx, want_ds = trms.rmsnorm_bwd(x.bfloat16().float(), scale,
                                        g.bfloat16().float())
    close(dx, want_dx, 2 ** -7)
    close(dscale, want_ds, AUTOGRAD_RTOL)


# ---------------------------------------------------------------------------
# ssd_state_scan
# ---------------------------------------------------------------------------

SCAN_CASES = [(4, 1, 2, 8, 16), (3, 2, 3, 5, 7), (1, 1, 2, 4, 4)]


def scan_inputs(shape, seed):
    nc, b, h, n, p = shape
    r = np.random.default_rng(seed)
    states = r.normal(size=shape).astype(np.float32)
    decay = r.uniform(0.3, 1.0, (nc, b, h)).astype(np.float32)
    init = r.normal(size=(b, h, n, p)).astype(np.float32)
    g_ent = r.normal(size=shape).astype(np.float32)
    g_fin = r.normal(size=(b, h, n, p)).astype(np.float32)
    return states, decay, init, g_ent, g_fin


@pytest.mark.parametrize("with_init", [True, False])
@pytest.mark.parametrize("shape", SCAN_CASES)
def test_scan_backward_matches_autograd_and_jax(shape, with_init):
    states, decay, init, g_ent, g_fin = scan_inputs(shape, 6)
    init = init if with_init else None
    before = tscan.BACKWARD_CALLS
    out, got = port_grads(lambda *a: tops.ssd_state_scan(*a),
                          (states, decay, init), (g_ent, g_fin))
    assert all(o.grad_fn is not None for o in out)
    assert tscan.BACKWARD_CALLS == before + 1
    assert len(got) == (3 if with_init else 2)   # g_initial when given
    _, want = port_grads(lambda *a: tref.ssd_state_scan_ref(*a),
                         (states, decay, init), (g_ent, g_fin))
    for a, w in zip(got, want):
        close(a, w, AUTOGRAD_RTOL)
    need_jax()
    if with_init:
        want = jax_grads(lambda *a: jref.ssd_state_scan_ref(*a),
                         (states, decay, init), (g_ent, g_fin))
    else:
        want = jax_grads(lambda s, d: jref.ssd_state_scan_ref(s, d),
                         (states, decay), (g_ent, g_fin))
    for a, w in zip(got, want):
        close(a, w, JAX_RTOL)


def test_scan_backward_g_initial_is_the_carry_past_chunk_zero():
    """g_initial = g_entering[0] + decay[0] * (the carry after chunk 0):
    with one chunk, g_entering[0] + decay[0] * g_final."""
    states, decay, init, g_ent, g_fin = scan_inputs((1, 1, 2, 3, 4), 7)
    entering, _ = tref.ssd_state_scan_ref(torch.tensor(states),
                                          torch.tensor(decay),
                                          torch.tensor(init))
    g_s, g_d, g_i = tscan.ssd_state_scan_bwd(
        torch.tensor(decay), entering, torch.tensor(g_ent),
        torch.tensor(g_fin))
    assert torch.equal(g_s[0], torch.tensor(g_fin))
    close(g_i, g_ent[0] + decay[0][..., None, None] * g_fin, 1e-6)
    close(g_d[0], (g_fin * init).sum((-2, -1)), 1e-6)


# ---------------------------------------------------------------------------
# the card: gradients through the kernels
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_gradients_through_the_kernels_on_card_match_cpu():
    """On CUDA tensors each differentiable call launches its kernel once,
    returns an output with a grad_fn, and its backward gives the CPU's
    gradients: flash in bf16 (the backward rounds its float32 result to
    bf16 once, so one bf16 step, rtol 2^-7) at qwen3's GQA layer,
    whisper's cross attention (448 queries over 1500 frames,
    non-causal), MLA's head dim 192 with its scale and kimi-k2's 112; the
    norm and the scan in float32 at 1e-5 (another summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    flash = [(2, 256, 16, 8, 128, True), (2, (448, 1500), 20, 20, 64, False),
             (1, 512, 16, 16, MLA_HD, True), (1, 256, 16, 2, 112, True)]
    cases = [
        (functools.partial(tops.flash_attention, causal=causal,
                           scale=flash_scale(hd)), tfa,
         [torch.tensor(x).bfloat16()
          for x in flash_inputs(b, s, hq, hkv, hd, 8)], 2 ** -7)
        for b, s, hq, hkv, hd, causal in flash] + [
        (tops.rmsnorm, trms,
         [torch.tensor(x) for x in norm_inputs((64, 1024), 9)], 1e-5),
        (tops.ssd_state_scan, tscan,
         [torch.tensor(x) for x in scan_inputs((8, 2, 4, 16, 8), 10)], 1e-5)]
    for fn, mod, ins, rtol in cases:
        n_in = 2 if fn is tops.rmsnorm else 3
        grads = {}
        for dev in ("cpu", "cuda"):
            xs = [x.to(dev).requires_grad_() for x in ins[:n_in]]
            before = mod.LAUNCHES
            out = fn(*xs)
            out = out if isinstance(out, tuple) else (out,)
            assert all(o.grad_fn is not None for o in out)
            assert mod.LAUNCHES == before + (dev == "cuda")
            total = sum((o.float() * c.to(dev).float()).sum()
                        for o, c in zip(out, ins[n_in:]))
            grads[dev] = [g.cpu() for g in torch.autograd.grad(total, xs)]
        for a, w in zip(grads["cuda"], grads["cpu"]):
            close(a, w, rtol)
