"""Port parity: the fused RMSNorm kernel ``rmsnorm``.

The plain PyTorch version (``repro_torch.kernels.ref.rmsnorm_ref``, which
``repro_torch.kernels.ops.rmsnorm`` runs on CPU tensors) is held against
the JAX package's Pallas kernel (interpret mode off the TPU) and its
``ref.rmsnorm_ref``, at ``tests/test_kernels.py``'s shapes in float32 and
bfloat16, plus ragged widths. Tolerance 1e-5 for float32 (float32
statistics summed in another order) and 2e-2 for bfloat16 (the output's
rounding), as ``tests/test_kernels.py`` states them.

The CUDA kernel itself is held against the plain version on the card by
the ``gpu`` test at the end (and by ``chip_smoke.py``): bit for bit, since
it sums in the plain version's order with ``-fmad=false``. A machine with a
card may have no JAX: there the oracle tests skip and the ``gpu`` test
runs alone, e.g. ``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_rmsnorm.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trms

try:                     # the oracle; absent on a machine with only torch
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:
    jnp = jops = jref = None

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (rows, d): tests/test_kernels.py's sweep, then ragged widths
SHAPES = [(64, 128), (1000, 256), (3, 512)]
RAGGED = [(5, 37), (4, 1030), (2, 3584)]


def need_jax():
    if jnp is None:
        pytest.skip("needs JAX, the oracle")


def inputs(rows, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    scale = (rng.normal(size=d) * 0.1 + 1.0).astype(np.float32)
    return x, scale


def as_torch(x, scale, dtype):
    return (torch.tensor(x).to(getattr(torch, dtype)),
            torch.tensor(scale).to(getattr(torch, dtype)))


def as_jax(x, scale, dtype):
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            jnp.asarray(scale).astype(getattr(jnp, dtype)))


def close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", SHAPES)
def test_plain_version_matches_pallas_and_jax_ref(rows, d, dtype):
    need_jax()
    x, scale = inputs(rows, d, rows + d)
    tx, ts = as_torch(x, scale, dtype)
    plain = tops.rmsnorm(tx, ts)
    assert plain.dtype == tx.dtype and plain.shape == tx.shape
    jx, js = as_jax(x, scale, dtype)
    close(plain.float(), jops.rmsnorm(jx, js, block_rows=32), dtype)
    close(plain.float(), jref.rmsnorm_ref(jx, js), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", RAGGED)
def test_plain_version_ragged_widths_match_jax_ref(rows, d, dtype):
    need_jax()
    x, scale = inputs(rows, d, d)
    tx, ts = as_torch(x, scale, dtype)
    got = tops.rmsnorm(tx.reshape(rows, 1, d), ts)       # leading dims kept
    assert got.shape == (rows, 1, d)
    close(got.float().reshape(rows, d),
          jref.rmsnorm_ref(*as_jax(x, scale, dtype)), dtype)


def test_plain_version_is_rmsnorm_in_float32():
    """Without JAX: the plain version against the formula in float64, at
    every vector width's summation order."""
    x, scale = inputs(6, 1024, 3)
    tx, ts = torch.tensor(x), torch.tensor(scale)
    xd = tx.double()
    want = xd / torch.sqrt((xd * xd).mean(-1, keepdim=True) + 1e-6) \
        * ts.double()
    for vec in (1, 2, 4, 8):
        got = tref.rmsnorm_ref(tx, ts, vec=vec)
        torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)


def test_cpu_wrapper_launches_nothing():
    x, scale = inputs(3, 64, 1)
    before = trms.LAUNCHES
    tops.rmsnorm(torch.tensor(x), torch.tensor(scale))
    assert trms.LAUNCHES == before


def test_vector_width_follows_length():
    assert trms.vector_width(1024, torch.bfloat16) == 8
    assert trms.vector_width(1024, torch.float32) == 4
    assert trms.vector_width(3584, torch.bfloat16) == 8
    assert trms.vector_width(1030, torch.bfloat16) == 2
    assert trms.vector_width(37, torch.float32) == 1


def test_wrapper_checks_its_inputs():
    x, scale = (torch.tensor(a) for a in inputs(3, 16, 2))
    with pytest.raises(ValueError):
        trms.rmsnorm(x, scale[:8])                   # scale width
    with pytest.raises(TypeError):
        trms.rmsnorm(x.half(), scale)                # no float16 kernel
    with pytest.raises(ValueError):
        trms.rmsnorm(x[:0], scale)                   # empty
    with pytest.raises(ValueError):
        trms.rmsnorm(x, scale.to("meta"))            # two devices


def test_kernel_instantiates_every_vector_width():
    """The CUDA source's launch<T, V> dispatch lists exactly the
    (dtype, width) pairs of ``VEC_WIDTHS``, its register budgets
    (launch_k<T, V, K>) exactly ``HELD_VECTORS``, and its rows per block
    are the plain version's ``RMSNORM_WARPS``: one warp a row, whose lanes
    give the plain version its order."""
    src = (Path(tref.__file__).parent / "csrc" / "rmsnorm.cu").read_text()
    found = re.findall(r"dtype == (\d) && vec == (\d)\) err = "
                       r"launch<(float|__nv_bfloat16), (\d)>", src)
    names = {"float": 0, "__nv_bfloat16": 1}
    assert found and all(int(d) == names[t] and v == v2
                         for d, v, t, v2 in found)
    assert [(int(d), int(v)) for d, v, _, _ in found] == [
        (trms.DTYPES[dt], v) for dt, widths in trms.VEC_WIDTHS.items()
        for v in widths]
    warps = re.search(r"constexpr int kWarps = (\d+);", src)
    assert int(warps.group(1)) == tref.RMSNORM_WARPS
    held = re.findall(r"per_lane <= (\d+)\)\s*return launch_k<T, V, (\d+)>",
                      src)
    last = re.findall(r"return launch_k<T, V, (\d+)>\(", src)
    assert [int(a) for a, b in held if a == b] == list(trms.HELD_VECTORS[:-1])
    assert int(last[-1]) == trms.HELD_VECTORS[-1]


@pytest.mark.parametrize("d,vec,held", [(1024, 8, 4), (37, 1, 4),
                                        (2048, 8, 8), (3584, 8, 16),
                                        (5120, 8, 24), (65_536, 8, 24)])
def test_row_held_in_registers_up_to_qwen3_32b(d, vec, held):
    """The register budget follows the row: d = 1024 bf16 holds four
    vectors a lane, qwen2-7b's 3584 and qwen3-32b's 5120 still fit, and a
    wider row keeps 24 and reads the rest twice."""
    assert trms.held_vectors(d, vec) == held
    assert held * 32 * vec >= d or held == trms.HELD_VECTORS[-1]


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_card():
    """The CUDA kernel against the plain version on the same card tensors:
    bit for bit in float32 and bfloat16; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for rows, d in SHAPES + RAGGED + [(16_384, 1024), (8, 1024), (1, 1)]:
        for dtype in ("float32", "bfloat16"):
            x, scale = (t.cuda() for t in as_torch(*inputs(rows, d, d),
                                                   dtype))
            before = trms.LAUNCHES
            got = trms.rmsnorm(x, scale)
            torch.cuda.synchronize()
            assert trms.LAUNCHES == before + 1
            want = tref.rmsnorm_ref(x, scale,
                                    vec=trms.vector_width(d, x.dtype))
            assert torch.equal(got, want), (rows, d, dtype)
    with pytest.raises(ValueError):                  # not contiguous
        trms.rmsnorm(torch.ones(8, 4, device="cuda").t(),
                     torch.ones(8, device="cuda"))
