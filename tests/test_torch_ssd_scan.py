"""Port parity: the Mamba2 inter-chunk state scan ``ssd_state_scan``.

The plain PyTorch version (``repro_torch.kernels.ref.ssd_state_scan_ref``,
which ``repro_torch.kernels.ops.ssd_state_scan`` runs on CPU tensors) is
held against the JAX package's ``ref.ssd_state_scan_ref`` and its Pallas
kernel (interpret mode off the TPU), at ``tests/test_kernels.py``'s shapes
and ragged ones, with and without an initial state, in float32 and with
bfloat16 states. Tolerance rtol 1e-6 (atol 1e-6 for entries near zero):
the same float32 multiply and add per step, which XLA on the CPU rounds
once and the port twice, so the two agree to a float32 ulp or two; the
bfloat16 test states its own bound.

The CUDA kernel itself is held against the plain version on the card by
the ``gpu`` test at the end (and by ``chip_smoke.py``): bit for bit, since
it rounds the product and the sum as the plain version does. A machine with
a card may have no JAX: there the oracle tests skip and the ``gpu`` test
runs alone, e.g. ``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_ssd_scan.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tscan

try:                     # the oracle; absent on a machine with only torch
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:
    jnp = jops = jref = None

torch.set_num_threads(2)

# (NC, B, H, N, P): tests/test_kernels.py's sweep, then ragged shapes
SHAPES = [(4, 1, 2, 8, 16), (16, 2, 4, 32, 8), (3, 1, 5, 7, 9), (1, 2, 3, 4, 5)]
TOL = 1e-6


def need_jax():
    if jnp is None:
        pytest.skip("needs JAX, the oracle")


def inputs(shape, seed):
    nc, b, h, n, p = shape
    rng = np.random.default_rng(seed)
    states = rng.normal(size=shape).astype(np.float32)
    decay = rng.uniform(0.3, 1.0, (nc, b, h)).astype(np.float32)
    init = rng.normal(size=(b, h, n, p)).astype(np.float32)
    return states, decay, init


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("with_init", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_pallas_and_jax_ref(shape, with_init):
    need_jax()
    states, decay, init = inputs(shape, sum(shape))
    t_init = torch.tensor(init) if with_init else None
    ent, fin = tops.ssd_state_scan(torch.tensor(states), torch.tensor(decay),
                                   t_init)
    assert ent.shape == shape and fin.shape == shape[1:]
    assert ent.dtype == fin.dtype == torch.float32
    j_init = jnp.asarray(init) if with_init else None
    for fn in (jops.ssd_state_scan, jref.ssd_state_scan_ref):
        j_ent, j_fin = fn(jnp.asarray(states), jnp.asarray(decay), j_init)
        close(ent, j_ent)
        close(fin, j_fin)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_plain_version_bf16_states_match_jax(shape):
    """bfloat16 states: a float32 carry, outputs rounded to bfloat16 once.
    The carry is the float32 scan of the bfloat16 values, bit for bit, and
    that scan meets the JAX reference and the Pallas kernel at rtol 1e-6.
    The rounded outputs then meet JAX's within one bfloat16 ulp (2^-7
    relative at most): XLA on the CPU rounds each step's multiply-add once,
    not twice, so a carry one float32 ulp away can round to the neighbouring
    bfloat16 (2 of 32,768 entries at the larger shape)."""
    need_jax()
    states, decay, init = inputs(shape, 7)
    ts = torch.tensor(states).to(torch.bfloat16)
    args = (torch.tensor(decay), torch.tensor(init))
    ent, fin = tops.ssd_state_scan(ts, *args)
    assert ent.dtype == fin.dtype == torch.bfloat16
    ent32, fin32 = tops.ssd_state_scan(ts.float(), *args)
    assert torch.equal(ent, ent32.to(torch.bfloat16))
    assert torch.equal(fin, fin32.to(torch.bfloat16))
    js = jnp.asarray(states).astype(jnp.bfloat16)
    for fn in (jops.ssd_state_scan, jref.ssd_state_scan_ref):
        j_ent, j_fin = fn(js.astype(jnp.float32), jnp.asarray(decay),
                          jnp.asarray(init))
        close(ent32, j_ent)
        close(fin32, j_fin)
        j_ent, j_fin = fn(js, jnp.asarray(decay), jnp.asarray(init))
        for got, want in ((ent, j_ent), (fin, j_fin)):
            want = np.asarray(want, np.float32)
            np.testing.assert_allclose(got.float().numpy(), want,
                                       rtol=2 ** -7, atol=0)
            assert (got.float().numpy() != want).mean() < 1e-3


def test_plain_version_is_the_recurrence():
    """Without JAX: entering[0] is the initial state, entering[c + 1] =
    decay[c] * entering[c] + states[c] and final follows the last chunk,
    against the loop in float64."""
    states, decay, init = (torch.tensor(a).double()
                           for a in inputs((5, 2, 3, 4, 6), 3))
    ent, fin = tref.ssd_state_scan_ref(states.float(), decay.float(),
                                       init.float())
    carry = init
    for c in range(5):
        torch.testing.assert_close(ent[c].double(), carry, rtol=1e-6,
                                   atol=1e-6)
        carry = carry * decay[c][..., None, None] + states[c]
    torch.testing.assert_close(fin.double(), carry, rtol=1e-6, atol=1e-6)
    ent0, _ = tref.ssd_state_scan_ref(states.float(), decay.float())
    assert not ent0[0].any()


def test_cpu_wrapper_launches_nothing():
    states, decay, init = (torch.tensor(a) for a in inputs((2, 1, 2, 3, 4),
                                                           1))
    before = tscan.LAUNCHES
    tops.ssd_state_scan(states, decay, init)
    assert tscan.LAUNCHES == before


def test_wrapper_checks_its_inputs():
    states, decay, init = (torch.tensor(a) for a in inputs((2, 1, 2, 3, 4),
                                                           2))
    with pytest.raises(ValueError):
        tscan.ssd_state_scan(states[0], decay, init)           # rank
    with pytest.raises(ValueError):
        tscan.ssd_state_scan(states, decay[:, :, :1], init)    # decay shape
    with pytest.raises(ValueError):
        tscan.ssd_state_scan(states, decay, init[..., :2])     # init shape
    with pytest.raises(ValueError):
        tscan.ssd_state_scan(states[:0], decay[:0], init)      # empty
    with pytest.raises(TypeError):
        tscan.ssd_state_scan(states.half(), decay, init)       # no f16
    with pytest.raises(TypeError):
        tscan.ssd_state_scan(states, decay.int(), init)
    with pytest.raises(ValueError):
        tscan.ssd_state_scan(states, decay.to("meta"), init)   # two devices


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_card():
    """The CUDA kernel against the plain version on the same card tensors:
    bit for bit, float32 and bfloat16 states, with and without an initial
    state, at a ragged shape and at mamba2-1.3b's head widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for shape in [(3, 1, 5, 7, 9), (4, 2, 64, 128, 64), (16, 2, 4, 32, 8)]:
        states, decay, init = (torch.tensor(a).cuda()
                               for a in inputs(shape, 5))
        for dtype in (torch.float32, torch.bfloat16):
            for start in (init, None):
                s = states.to(dtype)
                before = tscan.LAUNCHES
                got = tscan.ssd_state_scan(s, decay, start)
                torch.cuda.synchronize()
                assert tscan.LAUNCHES == before + 1
                want = tref.ssd_state_scan_ref(s, decay, start)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype == dtype
                    assert torch.equal(g, w), (shape, dtype, start is None)
    with pytest.raises(ValueError):                            # not contiguous
        s = torch.ones(2, 1, 2, 4, 3, device="cuda").transpose(3, 4)
        tscan.ssd_state_scan(s, torch.ones(2, 1, 2, device="cuda"))
