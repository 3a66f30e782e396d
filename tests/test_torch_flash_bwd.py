"""Port parity: the flash-attention backward (``flash_attention_backward``,
the backward of ``FlashAttentionFn``) and its kernel's plain version.

The kernel (``csrc/flash_attention_bwd.cu``) computes the gradients from
the forward's saved output o and the rows' logsumexp lse (log2 units): P =
2^(c log2(e) q k^T - lse), D = rowsum(g o), dS = P (g v^T - D), dq = c dS
k, dk = c dS^T q, dv = P^T g. Its plain version
(``repro_torch.kernels.ref.flash_attention_bwd_ref``, which the wrapper
runs on CPU tensors) is held:

- against ``jax.vjp`` of the JAX package's ``ref.flash_attention_ref`` (the
  function its custom VJP, ``repro/kernels/ops.py::_fa_bwd``,
  differentiates) at ``test_torch_train_grads.py``'s ``FLASH_CASES``, rtol
  1e-4 (the bound of that file's JAX comparisons);
- against ``flash_attention_bwd``, the port's whole recompute, at rtol
  1e-5 (one function in float32, two summation orders).

The plain forward's lse is held against ``jax.nn.logsumexp`` of the JAX
reference's scaled, masked scores (converted to log2 units) at 1e-5.
Gradients are compared elementwise with atol = rtol x the largest
magnitude of the reference leaf.

The kernel's tolerance is ``chip_smoke.py``'s ``FLASH_BWD_TOL``, applied
by its ``flash_error`` (both imported from there): elementwise |got -
want| <= atol + rtol (|want| + A), A = P^T|g| for dv, c |dS|^T |q| for dk
and c |dS| |k| for dq (``flash_attention_bwd_ref(magnitudes=True)``; the
bf16 kernel rounds P and dS to bf16 as the products' operands and each
result once, each by at most u = 2^-8 relatively: rtol 2u), and in bf16
a norm-relative error of at most 1e-2 in every block of 64 rows of one
(batch, head). The tolerance tests show that it passes the plain version
rounded to bf16 and rejects the functions of the faults ``chip_smoke.py``
plants in the kernel: D left out, lse read as a natural log, dK/dV from
the first q head of each GQA group only, and a q tile left out of dK/dV;
and that ``FLASH_LSE_ATOL`` rejects the forward's two planted lse faults
(the scale left out of the running max, natural-log units). Each planted
fault's anchor occurs once in its source.

The ``gpu`` test holds the kernel against its plain version on the card
(skips without one; ``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_flash_bwd.py`` runs it on the card's machine).
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from test_torch_train_grads import (FLASH_CASES, JAX_RTOL, close,
                                    flash_inputs, flash_scale, jax_grads,
                                    need_jax)

try:                     # the oracle; absent on a machine with only torch
    import jax
    import jax.numpy as jnp

    from repro.kernels import ref as jref
except ImportError:
    jax = None

torch.set_num_threads(2)

RECOMPUTE_RTOL = 1e-5
CSRC = Path(tref.__file__).parent / "csrc"
SOURCE = CSRC / "flash_attention_bwd.cu"


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports torch inside its
    functions): the tolerances and the error measure it applies on the
    card."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


smoke = _chip_smoke()


def plain_grads(b, s, hq, hkv, hd, causal, seed, dtype=torch.float32):
    """The inputs and (o, lse) of the plain forward, then its backward."""
    q, k, v, g = (torch.tensor(x).to(dtype)
                  for x in flash_inputs(b, s, hq, hkv, hd, seed))
    scale = flash_scale(hd)
    o, lse = tref.flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                      return_lse=True)
    return (q, k, v, o, lse, g), tref.flash_attention_bwd_ref(
        q, k, v, o, lse, g, causal=causal, scale=scale)


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal", FLASH_CASES)
def test_plain_backward_matches_jax_vjp(b, s, hq, hkv, hd, causal):
    need_jax()
    (q, k, v, _, _, g), got = plain_grads(b, s, hq, hkv, hd, causal, 1)
    want = jax_grads(lambda *x: jref.flash_attention_ref(
        *x, causal=causal, softmax_scale=flash_scale(hd)),
        [x.numpy() for x in (q, k, v)], (g.numpy(),))
    for a, w in zip(got, want):
        close(a, w, JAX_RTOL)


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal", FLASH_CASES)
def test_plain_backward_matches_recompute(b, s, hq, hkv, hd, causal):
    (q, k, v, _, _, g), got = plain_grads(b, s, hq, hkv, hd, causal, 2)
    want = tfa.flash_attention_bwd(q, k, v, g, causal=causal,
                                   scale=flash_scale(hd))
    for a, w in zip(got, want):
        close(a, w, RECOMPUTE_RTOL)


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal", [
    (2, 40, 4, 2, 64, True), (1, (24, 40), 4, 2, 64, False),
    (1, 33, 4, 4, 192, True)])
def test_plain_lse_matches_jax_logsumexp(b, s, hq, hkv, hd, causal):
    """lse in log2 units: log2 e x logsumexp of the scaled scores, masked
    as the JAX reference masks them (Sq == Skv where causal)."""
    need_jax()
    q, k, v, _ = flash_inputs(b, s, hq, hkv, hd, 3)
    scale = flash_scale(hd)
    _, got = tref.flash_attention_ref(*(torch.tensor(x) for x in (q, k, v)),
                                      causal=causal, scale=scale,
                                      return_lse=True)
    sq, skv = q.shape[1], k.shape[1]
    c = hd ** -0.5 if scale is None else scale
    qr = jnp.asarray(q).reshape(b, sq, hkv, hq // hkv, hd) * c
    sc = jnp.einsum("bqhgd,bkhd->bhgqk", qr, jnp.asarray(k))
    if causal:
        mask = jnp.tril(jnp.ones((sq, skv), bool), k=skv - sq)
        sc = jnp.where(mask, sc, -1e30)
    want = np.asarray(jax.nn.logsumexp(sc, axis=-1)).reshape(b, hq, sq)
    close(got, want * tref.LOG2E, 1e-5)


@pytest.mark.parametrize("hd", [64, 192])
def test_function_saves_output_and_lse(hd):
    """On CPU tensors ``FlashAttentionFn`` saves q, k, v, the output and
    the plain forward's lse, and its gradients are JAX's."""
    need_jax()
    causal = True
    q, k, v, g = flash_inputs(2, 24, 4, 2, hd, 4)
    scale = flash_scale(hd)
    xs = [torch.tensor(x).requires_grad_() for x in (q, k, v)]
    before, launched = tfa.BACKWARD_CALLS, tfa.BWD_LAUNCHES
    out = tops.flash_attention(*xs, causal=causal, scale=scale)
    saved = out.grad_fn.saved_tensors
    _, lse = tref.flash_attention_ref(*xs, causal=causal, scale=scale,
                                      return_lse=True)
    assert len(saved) == 5
    assert torch.equal(saved[3], out) and torch.equal(saved[4], lse)
    got = torch.autograd.grad(out, xs, torch.tensor(g))
    assert tfa.BACKWARD_CALLS == before + 1
    assert tfa.BWD_LAUNCHES == launched       # the plain version
    want = jax_grads(lambda *x: jref.flash_attention_ref(
        *x, causal=causal, softmax_scale=scale), (q, k, v), (g,))
    for a, w in zip(got, want):
        close(a, w, JAX_RTOL)


def test_backward_checks_its_inputs():
    (q, k, v, o, lse, g), _ = plain_grads(1, 16, 4, 2, 64, True, 5)
    with pytest.raises(ValueError):                      # o's shape
        tfa.flash_attention_backward(q, k, v, o[:, :8], lse, g)
    with pytest.raises(ValueError):                      # lse's shape
        tfa.flash_attention_backward(q, k, v, o, lse[:, :, :8], g)
    with pytest.raises(ValueError):                      # lse's dtype
        tfa.flash_attention_backward(q, k, v, o, lse.double(), g)
    with pytest.raises(ValueError):                      # g's shape
        tfa.flash_attention_backward(q, k, v, o, lse, g[..., :32])
    with pytest.raises(TypeError):                       # o's dtype
        tfa.flash_attention_backward(q, k, v, o.bfloat16(), lse, g)
    (q, k, v, o, lse, g), _ = plain_grads(1, 16, 2, 2, 24, False, 5)
    with pytest.raises(ValueError):                      # head dim 24
        tfa.flash_attention_backward(q, k, v, o, lse, g, causal=False)


def test_kernel_instantiates_every_head_dim():
    """The backward source's head-dim dispatch lists exactly
    ``HEAD_DIMS``, and its scratch padding is the wrapper's ``BWD_PAD``."""
    src = SOURCE.read_text()
    found = re.findall(r"hd == (\d+)\) err = launch_hd<(\d+)>", src)
    assert found and all(a == b for a, b in found)
    assert tuple(int(a) for a, _ in found) == tfa.HEAD_DIMS
    pad = re.search(r"constexpr int kPad = (\d+);", src)
    assert pad and int(pad.group(1)) == tfa.BWD_PAD


# ---------------------------------------------------------------------------
# the kernel's tolerance
# ---------------------------------------------------------------------------

def within(got, want, mag, dtype) -> bool:
    return smoke.flash_error(got, want, mag, dtype,
                             smoke.FLASH_BWD_TOL[dtype])[1]


FAULT_SHAPE = (1, 512, 4, 2, 64, True)


def fault_case():
    """bf16 inputs at ``FAULT_SHAPE``, the plain version's float32 result
    on them (the kernel's oracle) and the tolerance's magnitudes A."""
    b, s, hq, hkv, hd, causal = FAULT_SHAPE
    ins, _ = plain_grads(b, s, hq, hkv, hd, causal, 6, torch.bfloat16)
    f32 = [x.float() for x in ins]
    want, mags = tref.flash_attention_bwd_ref(*f32, causal=causal,
                                              magnitudes=True)
    return ins, f32, want, mags


def test_tolerance_passes_one_bf16_rounding():
    ins, _, want, mags = fault_case()
    got = tref.flash_attention_bwd_ref(*ins, causal=True)      # bf16 out
    assert all(within(a, w, m, "bfloat16")
               for a, w, m in zip(got, want, mags))


def test_tolerance_with_o_err_passes_another_forwards_o():
    """Phase 21's card-vs-CPU form: the gradients from a bf16 forward's o
    and lse, rounded to bf16, against the float32 plain backward from the
    float32 forward's o and lse, under ``FLASH_BWD_TOL`` with A widened by
    ``o_err`` (row 0's dS is 0 exactly, so D's rounding alone shows
    there)."""
    b, s, hq, hkv, hd, causal = FAULT_SHAPE
    q, k, v, g = (torch.tensor(x).bfloat16()
                  for x in flash_inputs(b, s, hq, hkv, hd, 7))
    o, lse = tref.flash_attention_ref(q, k, v, return_lse=True)
    got = tref.flash_attention_bwd_ref(q, k, v, o, lse, g)
    f32 = [x.float() for x in (q, k, v)]
    o32, lse32 = tref.flash_attention_ref(*f32, return_lse=True)
    want, mags = tref.flash_attention_bwd_ref(
        *f32, o32, lse32, g.float(), magnitudes=True, o_err=True)
    assert all(within(a, w, m, "bfloat16")
               for a, w, m in zip(got, want, mags))


@pytest.mark.parametrize("fault", ["no_d", "natural_lse", "first_head",
                                   "skipped_q_tile"])
def test_tolerance_rejects_the_planted_faults(fault):
    """Each fault's function, rounded to bf16 as the kernel rounds, fails
    ``FLASH_BWD_TOL`` in at least one of the gradients it changes."""
    ins, (q, k, v, o, lse, g), want, mags = fault_case()
    hkv = k.shape[2]
    if fault == "no_d":                  # dS = P dP: D of o = 0 is 0
        o = torch.zeros_like(o)
    elif fault == "natural_lse":         # lse taken as ln: x log2 e
        lse = lse * tref.LOG2E
    elif fault == "first_head":          # dK, dV from head 0 of a group
        g = g.clone().unflatten(2, (hkv, -1))
        g[:, :, :, 1:] = 0
        g = g.flatten(2, 3)
    else:                                # one q tile of 64 rows left out
        g = g.clone()
        g[:, 256:320] = 0
    bad = tref.flash_attention_bwd_ref(q, k, v, o, lse, g, causal=True)
    checked = range(1, 3) if fault in ("first_head", "skipped_q_tile") \
        else range(3)
    assert not all(within(bad[i].bfloat16(), want[i], mags[i], "bfloat16")
                   for i in checked)


@pytest.mark.parametrize("fault", ["lse_without_scale", "lse_natural_log"])
def test_lse_tolerance_rejects_the_forward_faults(fault):
    """The lse of the forward's two planted lse faults fails
    ``FLASH_LSE_ATOL`` against the plain forward's, which passes it."""
    _, (q, k, v, _, lse, _), _, _ = fault_case()
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    c = hd ** -0.5
    if fault == "lse_without_scale":     # m + log2(l), m the raw max
        s = torch.einsum("bqhgd,bkhd->bhgqk",
                         q.reshape(b, sq, hkv, hq // hkv, hd), k)
        s = s.masked_fill(~torch.ones(sq, sq, dtype=torch.bool).tril(),
                          -torch.inf)
        m = s.amax(-1).reshape(b, hq, sq)
        bad = lse - m * c * tref.LOG2E + m
    else:                                # (m c log2 e + log2 l) ln 2
        bad = lse / tref.LOG2E
    assert smoke.lse_error(lse.clone(), lse)[1]
    assert not smoke.lse_error(bad, lse)[1]


@pytest.mark.parametrize("kernel,name", [
    *(("flash_attention", f) for f in smoke.FLASH_FAULTS),
    *(("flash_attention_bwd", f) for f in smoke.FLASH_BWD_FAULTS)])
def test_planted_fault_anchors_occur_once(kernel, name):
    """Each fault ``chip_smoke.py`` plants replaces text that occurs
    exactly once in its kernel's source, by other text."""
    old, new = (smoke.FLASH_FAULTS if kernel == "flash_attention"
                else smoke.FLASH_BWD_FAULTS)[name]
    assert (CSRC / f"{kernel}.cu").read_text().count(old) == 1
    assert new != old


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_kernel_matches_plain_version_on_card():
    """The backward kernel against its plain version in float32 on the
    same card tensors (o and lse from the forward kernel), under
    ``FLASH_BWD_TOL``, and that lse against the plain forward's under
    ``FLASH_LSE_ATOL``, at small shapes of every head dim in both dtypes:
    causal and not, GQA, Sq != Skv both ways, ragged lengths; one launch
    a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [(2, 200, 200, 4, 2, True), (1, 77, 150, 2, 1, False),
             (1, 150, 77, 2, 2, True), (1, 77, 300, 4, 4, True)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for hd in tfa.HEAD_DIMS:
        for b, sq, skv, hq, hkv, causal in cases:
            for dtype in (torch.float32, torch.bfloat16):
                q, g = (torch.randn(b, sq, hq, hd, generator=gen,
                                    device="cuda").to(dtype)
                        for _ in range(2))
                k, v = (torch.randn(b, skv, hkv, hd, generator=gen,
                                    device="cuda").to(dtype)
                        for _ in range(2))
                o, lse = tfa.flash_attention(q, k, v, causal=causal,
                                             return_lse=True)
                before = tfa.BWD_LAUNCHES
                got = tfa.flash_attention_backward(q, k, v, o, lse, g,
                                                   causal=causal)
                torch.cuda.synchronize()
                assert tfa.BWD_LAUNCHES == before + 1
                case = (hd, b, sq, skv, dtype)
                _, want_lse = tref.flash_attention_ref(
                    q.float(), k.float(), v.float(), causal=causal,
                    return_lse=True)
                assert smoke.lse_error(lse, want_lse)[1], case
                want, mags = tref.flash_attention_bwd_ref(
                    *(x.float() for x in (q, k, v, o, lse, g)),
                    causal=causal, magnitudes=True)
                name = str(dtype).removeprefix("torch.")
                for a, w, m in zip(got, want, mags):
                    assert within(a, w, m, name), case
