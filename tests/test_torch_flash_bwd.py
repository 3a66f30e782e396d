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
the first q head of each GQA group only, a q tile left out of the walk,
and one kv tile's dQ partials left out of the ordered sum; and that
``FLASH_LSE_ATOL`` rejects the forward's two planted lse faults (the
scale left out of the running max, natural-log units). Each planted
fault's anchor occurs once in its source.

The launch plan (``bwd_plan``: the walk's split of a GQA group over
blocks, its grid and scratch) is checked by shape, and against the
source's tile sizes.

The ``gpu`` test holds the kernel against its plain version on the card
and two calls to the same bits (skips without one; ``PYTHONPATH=src
python -m pytest --noconftest -m gpu tests/test_torch_flash_bwd.py`` runs
it on the card's machine).
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
                                   "skipped_q_tile", "dropped_dq_partial"])
def test_tolerance_rejects_the_planted_faults(fault):
    """Each fault's function, rounded to bf16 as the kernel rounds, fails
    ``FLASH_BWD_TOL`` in at least one of the gradients it changes."""
    ins, (q, k, v, o, lse, g), want, mags = fault_case()
    hkv = k.shape[2]
    checked = range(3)
    if fault == "no_d":                  # dS = P dP: D of o = 0 is 0
        o = torch.zeros_like(o)
    elif fault == "natural_lse":         # lse taken as ln: x log2 e
        lse = lse * tref.LOG2E
    elif fault == "first_head":          # dK, dV from head 0 of a group
        g = g.clone().unflatten(2, (hkv, -1))
        g[:, :, :, 1:] = 0
        g = g.flatten(2, 3)
        checked = range(1, 3)
    elif fault == "skipped_q_tile":      # one q tile of 64 rows left out
        g = g.clone()
        g[:, 256:320] = 0
        checked = range(1, 3)
    if fault == "dropped_dq_partial":
        # dQ without kv tile 2 of 4 (the middle one, as planted): the
        # tile's part c dS k is the plain dq with k zero off its rows (P
        # comes from lse, so dS on the tile's rows is unchanged)
        lo, hi = 2 * tfa.BWD_KV_ROWS, 3 * tfa.BWD_KV_ROWS
        k_tile = torch.zeros_like(k)
        k_tile[:, lo:hi] = k[:, lo:hi]
        part = tref.flash_attention_bwd_ref(q, k_tile, v, o, lse, g,
                                            causal=True)[0]
        assert float(part.abs().max()) > 0
        bad = (want[0] - part, *want[1:])
        checked = range(1)
    else:
        bad = tref.flash_attention_bwd_ref(q, k, v, o, lse, g, causal=True)
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


# (B, Sq, Skv, Hq, Hkv, hd, causal) of every train path's attention (the
# shapes of chip_smoke.py's phase 21b) and small ones
PLAN_SHAPES = [
    (4, 4096, 4096, 16, 8, 128, True),       # qwen3-0.6b
    (4, 4096, 4096, 16, 16, 192, True),      # deepseek-v2-lite's MLA
    (4, 4352, 4352, 14, 2, 64, True),        # internvl2-1b, sync batch
    (2, 4352, 4352, 14, 2, 64, True),        # internvl2-1b, a pod
    (4, 1500, 1500, 20, 20, 64, False),      # whisper encoder
    (4, 448, 1500, 20, 20, 64, False),       # whisper cross attention
    (4, 448, 448, 20, 20, 64, True),         # whisper decoder
    (1, 1024, 1024, 16, 8, 128, True),       # phase 21's card-vs-CPU slice
    (2, 200, 200, 4, 2, 64, True), (1, 77, 150, 2, 1, 112, False),
    (1, 150, 77, 8, 1, 80, True), (1, 300, 300, 24, 3, 16, True),
    (3, 96, 96, 9, 1, 32, False), (2, 200, 200, 4, 2, 64, False),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_bwd_plan_covers_every_head_once(shape):
    """The walk's ranks split each GQA group's q heads into consecutive
    ranges that cover every head exactly once, at most 8 and at most the
    group's size of them; the grid is (Hkv * split, B, kv tiles); the
    split is the fewest ranks whose longest walk is within the balanced
    share (or the most allowed); the scratch is sized as the kernel reads
    it (float32 dQ tiles of the padded rows, an int32 count per 64-row
    tile, float32 dK and dV partials per rank only when split)."""
    b, sq, skv, hq, hkv, hd, causal = shape
    plan = tfa.bwd_plan(*shape)
    group = hq // hkv
    covered = [h for lo, hi in plan.heads for h in range(lo, hi)]
    assert covered == list(range(group))
    assert all(hi > lo for lo, hi in plan.heads)
    assert 1 <= plan.split <= min(group, 8) == min(hq // hkv, 8)
    assert len(plan.heads) == plan.split
    n_kv = -(-skv // tfa.BWD_KV_ROWS)
    assert plan.grid == (hkv * plan.split, b, n_kv)
    assert plan.walk == (hd <= tfa.BWD_WALK_MAX_HD)
    per_head = -(-sq // tfa.BWD_Q_ROWS)      # kv tile 0 sees every q tile
    width = max(hi - lo for lo, hi in plan.heads)
    assert plan.longest == width * per_head
    if plan.split > 1:       # one rank fewer would be too long
        fewer = -(-group // (plan.split - 1)) * per_head
        assert fewer > plan.balanced
    if plan.split < min(group, 8):
        assert plan.longest <= plan.balanced
    pad = -(-sq // tfa.BWD_PAD) * tfa.BWD_PAD
    assert plan.stats_bytes == 2 * b * hq * pad * 4
    assert plan.dq_acc_bytes == (b * hq * pad * hd * 4 if plan.walk else 0)
    assert plan.sem_bytes == (b * hq * pad // tfa.BWD_Q_ROWS * 4
                              if plan.walk else 0)
    assert plan.kv_part_bytes == (plan.split * 2 * b * skv * hkv * hd * 4
                                  if plan.split > 1 else 0)
    assert plan.split == 1 or plan.walk


def test_bwd_plan_train_shapes():
    """At the train shapes: internvl2's pod (GQA 7, batch 2) splits its
    groups so the longest walk is within the balanced share (it was 1.9x
    it with one block per group); MHA (whisper), qwen3's GQA 2 and the
    sync batch keep one block; hd 192 and float32 take the three walks;
    qwen3's dQ sums take 134 MB."""
    pod = tfa.bwd_plan(2, 4352, 4352, 14, 2, 64, True)
    assert pod.split == 3 and pod.longest <= pod.balanced
    assert pod.heads == ((0, 2), (2, 4), (4, 7))
    for shape in [(4, 1500, 1500, 20, 20, 64, False),
                  (4, 448, 1500, 20, 20, 64, False),
                  (4, 448, 448, 20, 20, 64, True),
                  (4, 4096, 4096, 16, 8, 128, True),
                  (4, 4352, 4352, 14, 2, 64, True)]:
        assert tfa.bwd_plan(*shape).split == 1, shape
    assert not tfa.bwd_plan(4, 4096, 4096, 16, 16, 192, True).walk
    assert not tfa.bwd_plan(2, 200, 200, 4, 2, 64, True,
                            torch.float32).walk
    qwen = tfa.bwd_plan(4, 4096, 4096, 16, 8, 128, True)
    assert qwen.dq_acc_bytes == 134_217_728


def test_bwd_plan_matches_the_source():
    """The wrapper's tile sizes and head-dim limit are the kernel's."""
    src = SOURCE.read_text()

    def const(name):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found, name
        return int(found.group(1))

    assert const("kBQ") == tfa.BWD_Q_ROWS
    assert const("kBKV") == tfa.BWD_KV_ROWS
    assert "if constexpr (HD <= 128) {\n    return launch_walk<HD>" in src
    assert tfa.BWD_WALK_MAX_HD == 128


def test_counter_slots_match_the_source():
    """``chip_smoke.py`` reads the walk's counters in the order of the
    source's ``ProfSlot`` enum, and ``scripts/flash_bwd_study.py`` names
    the backward's kernels as the source does."""
    src = SOURCE.read_text()
    enum = src[src.index("enum ProfSlot {"):src.index("kProfSlots")]
    slots = re.findall(r"^  kProf(\w+),", enum, re.M)
    snake = [re.sub(r"(?<!^)(?=[A-Z])", "_", x).lower() for x in slots]
    assert snake == list(smoke.BWD_COUNTER_SLOTS)
    path = Path(__file__).resolve().parents[1] / "scripts" / (
        "flash_bwd_study.py")
    spec = importlib.util.spec_from_file_location("flash_bwd_study", path)
    study = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(study)
    kernels = set(re.findall(r"void __launch_bounds__\([^)]*\)\s+"
                             r"flash_bwd_(\w+?)(?:_bf16|_f32)?\(", src))
    assert kernels == set(study.KERNELS)


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


@pytest.mark.gpu
def test_kernel_gives_the_same_bits_on_card():
    """Two calls give the same bits at GQA shapes with several kv tiles,
    causal and not, one block per group and split over ranks (the walk's
    dQ sums run in kv-tile order, its dK and dV partials in rank order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for b, sq, skv, hq, hkv, hd, causal in [
            (2, 1000, 1000, 14, 2, 64, True), (1, 1024, 1024, 16, 8, 128, True),
            (2, 700, 900, 8, 2, 128, False), (1, 600, 600, 6, 3, 112, True)]:
        q, g = (torch.randn(b, sq, hq, hd, generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        k, v = (torch.randn(b, skv, hkv, hd, generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        o, lse = tfa.flash_attention(q, k, v, causal=causal,
                                     return_lse=True)
        first = tfa.flash_attention_backward(q, k, v, o, lse, g,
                                             causal=causal)
        for _ in range(3):
            again = tfa.flash_attention_backward(q, k, v, o, lse, g,
                                                 causal=causal)
            assert all(torch.equal(x, y) for x, y in zip(first, again)), (
                b, sq, skv, hq, hkv, hd, causal)
