"""Port parity: the eq. (8)/(14) weighted-mean kernel ``hier_aggregate``.

The plain PyTorch version (``repro_torch.kernels.ref.hier_aggregate_ref``)
and ``repro_torch.kernels.ops.hier_aggregate_tree`` on CPU tensors are held
against the JAX package's Pallas kernel (interpret mode off the TPU) and
its ``ref.hier_aggregate_ref``, at ``tests/test_kernels.py``'s shapes plus
a bfloat16 case. Tolerance 1e-5 for float32 (both accumulate in float32,
in another order) and 2e-2 for bfloat16 (the output's rounding).

The CUDA kernel itself is held against the plain version on the card by
the ``gpu`` test at the end (and by ``chip_smoke.py``): bit for bit in
float32, since it sums in the plain version's order with ``-fmad=false``.
A machine with a card may have no JAX: there the oracle tests skip and the
``gpu`` test runs alone, e.g.
``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_hier_aggregate.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import hier_aggregate as tha
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

try:                     # the oracle; absent on a machine with only torch
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:
    jnp = jops = jref = None

torch.set_num_threads(2)


def need_jax():
    if jnp is None:
        pytest.skip("needs JAX, the oracle")

# (C, P, Pallas block_p): tests/test_kernels.py's sweep
SHAPES = [(4, 100, 64), (32, 4096, 1024), (1, 17, 8)]


def inputs(c, p, seed):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(c, p)).astype(np.float32)
    w = (rng.uniform(size=c) + 0.05).astype(np.float32)
    return u, w


@pytest.mark.parametrize("c,p,block", SHAPES)
def test_plain_version_matches_pallas_and_jax_ref(c, p, block):
    need_jax()
    u, w = inputs(c, p, c + p)
    plain = tref.hier_aggregate_ref(torch.tensor(u), torch.tensor(w))
    assert plain.dtype == torch.float32 and plain.shape == (p,)
    pallas = jops.hier_aggregate(jnp.asarray(u), jnp.asarray(w),
                                 block_p=block)
    np.testing.assert_allclose(plain.numpy(), np.asarray(pallas), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(
        plain.numpy(), np.asarray(jref.hier_aggregate_ref(jnp.asarray(u),
                                                          jnp.asarray(w))),
        atol=1e-5, rtol=1e-5)


def test_plain_version_bfloat16_matches_pallas():
    need_jax()
    u, w = inputs(16, 1000, 3)
    u16 = torch.tensor(u).to(torch.bfloat16)
    plain = tref.hier_aggregate_ref(u16, torch.tensor(w))
    assert plain.dtype == torch.bfloat16
    ju = jnp.asarray(u16.float().numpy()).astype(jnp.bfloat16)
    pallas = jops.hier_aggregate(ju, jnp.asarray(w), block_p=256)
    np.testing.assert_allclose(plain.float().numpy(),
                               np.asarray(pallas, np.float32), atol=2e-2,
                               rtol=2e-2)


def test_plain_version_sums_many_weights_in_the_kernels_order():
    """C above one block's threads: every thread adds several weights
    before the warp reduction. Held against float64."""
    u, w = inputs(600, 33, 9)
    got = tref.hier_aggregate_ref(torch.tensor(u), torch.tensor(w))
    want = (w.astype(np.float64) / w.astype(np.float64).sum()) @ u
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    total = tref.thread_block_sum(torch.tensor(w)[None], tref.AGG_THREADS)
    assert abs(total.item() - w.astype(np.float64).sum()) < 1e-3


def test_zero_weights_give_zeros_not_nan():
    """All weights 0: the floor at 1e-30 gives 0 weights and a zero mean
    (the trainer gates such a group out), as the Pallas kernel does."""
    need_jax()
    u, _ = inputs(3, 10, 4)
    got = tref.hier_aggregate_ref(torch.tensor(u), torch.zeros(3))
    assert torch.equal(got, torch.zeros(10))
    np.testing.assert_array_equal(
        np.asarray(jops.hier_aggregate(jnp.asarray(u), jnp.zeros(3))),
        np.zeros(10))


def test_tree_mean_matches_pallas_tree_mean():
    need_jax()
    rng = np.random.default_rng(5)
    trees = [{"w": rng.normal(size=(3, 3)).astype(np.float32),
              "b": rng.normal(size=(2,)).astype(np.float32),
              "z": [rng.normal(size=(4,)).astype(np.float32)]}
             for _ in range(4)]
    weights = np.asarray([1.0, 1.0, 1.0, 5.0], np.float32)
    got = tops.hier_aggregate_tree(
        [{"w": torch.tensor(t["w"]), "b": torch.tensor(t["b"]),
          "z": [torch.tensor(t["z"][0])]} for t in trees], weights)
    want = jops.hier_aggregate_tree(
        [{"w": jnp.asarray(t["w"]), "b": jnp.asarray(t["b"]),
          "z": [jnp.asarray(t["z"][0])]} for t in trees],
        jnp.asarray(weights))
    assert isinstance(got["z"], list) and got["w"].shape == (3, 3)
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["z"][0].numpy(), np.asarray(want["z"][0]),
                               rtol=1e-5, atol=1e-5)
    # tests/test_kernels.py's analytic case
    const = [{"w": torch.full((3, 3), float(i)), "b": torch.full((2,),
                                                                float(i))}
             for i in range(4)]
    out = tops.hier_aggregate_tree(const, weights)
    assert torch.allclose(out["w"], torch.tensor((0 + 1 + 2 + 5 * 3) / 8.0))
    assert torch.allclose(out["b"], torch.tensor((0 + 1 + 2 + 5 * 3) / 8.0))


def test_wrapper_takes_the_plain_version_on_cpu():
    u, w = inputs(5, 37, 6)
    before = tha.LAUNCHES
    got = tops.hier_aggregate(torch.tensor(u), torch.tensor(w))
    assert tha.LAUNCHES == before     # the plain version launches nothing
    assert torch.equal(got, tref.hier_aggregate_ref(torch.tensor(u),
                                                    torch.tensor(w)))


def test_wrapper_checks_its_inputs():
    u, w = (torch.tensor(x) for x in inputs(4, 9, 7))
    with pytest.raises(ValueError):
        tha.hier_aggregate(u[0], w)                  # not (C, P)
    with pytest.raises(ValueError):
        tha.hier_aggregate(u, w[:3])                 # weights not (C,)
    with pytest.raises(ValueError):
        tha.hier_aggregate(u[:0], w[:0])             # empty
    with pytest.raises(TypeError):
        tha.hier_aggregate(u.double(), w)            # float64 updates
    with pytest.raises(TypeError):
        tha.hier_aggregate(u, w.to(torch.bfloat16))  # weights not float32
    with pytest.raises(ValueError):
        tha.hier_aggregate(u, w.to("meta"))          # two devices


def test_vector_width_follows_length_and_alignment():
    f32 = torch.zeros(3, 101_770)
    assert tha.vector_width(f32) == 2                # 101,770 = 2 * 50,885
    assert tha.vector_width(torch.zeros(3, 4096)) == 4
    assert tha.vector_width(torch.zeros(3, 17)) == 1
    assert tha.vector_width(torch.zeros(2, 64, dtype=torch.bfloat16)) == 8
    assert tha.vector_width(torch.zeros(2, 6, dtype=torch.bfloat16)) == 2
    shifted = torch.zeros(3 * 4096 + 1)[1:].view(3, 4096)   # 4-byte offset
    assert tha.vector_width(shifted) == 1


def test_kernel_instantiates_every_vector_width():
    """The CUDA source's launch<T, V> dispatch lists exactly the
    (dtype, width) pairs of ``VEC_WIDTHS``, which the wrapper picks from,
    and its thread count is the plain version's ``AGG_THREADS``."""
    src = (Path(tref.__file__).parent / "csrc" / "hier_aggregate.cu"
           ).read_text()
    found = re.findall(r"dtype == (\d) && vec == (\d)\) err = "
                       r"launch<(float|__nv_bfloat16), (\d)>", src)
    names = {"float": 0, "__nv_bfloat16": 1}
    assert found and all(int(d) == names[t] and v == v2
                         for d, v, t, v2 in found)
    assert [(int(d), int(v)) for d, v, _, _ in found] == [
        (tha.DTYPES[dt], v) for dt, widths in tha.VEC_WIDTHS.items()
        for v in widths]
    threads = re.search(r"constexpr int kThreads = (\d+);", src)
    assert int(threads.group(1)) == tref.AGG_THREADS
    splits = re.search(r"constexpr int kMaxSplits = (\d+);", src)
    assert int(splits.group(1)) == tref.AGG_MAX_SPLITS <= 8


def test_splits_follow_the_shape():
    """``agg_splits``: about ``AGG_BLOCKS`` blocks, at most
    ``AGG_MAX_SPLITS`` splits and never more than C, none empty, and one
    split for a small C."""
    assert tref.agg_splits(1000, 101_770) == (3, 334)   # the cloud mean
    assert tref.agg_splits(131, 101_770) == (3, 44)     # an edge group
    assert tref.agg_splits(70, 101_770) == (1, 70)
    assert tref.agg_splits(1, 17) == (1, 1)
    assert tref.agg_splits(37, 4099) == (1, 37)
    assert tref.agg_splits(400, 4099) == (8, 50)
    for c in (1, 2, 5, 9, 131, 1000, 4097):
        for p in (1, 17, 4099, 101_770, 10**7):
            splits, rows = tref.agg_splits(c, p)
            assert 1 <= splits <= min(c, tref.AGG_MAX_SPLITS)
            assert (splits - 1) * rows < c <= splits * rows
            assert splits == 1 or rows >= tref.AGG_MIN_ROWS


def emulate_splits(u, w):
    """The kernel in float32, written out: the weight sum in thread order
    (thread t adds w[t], w[t + 256], ..., then each warp's halving tree and
    one over the warp partials), each split's rows added in turn to a sum
    that starts at 0, then the split sums added in split order. Vectorised
    over the columns only, whose sums are independent."""
    c, p = u.shape
    t = tref.AGG_THREADS
    threads = [np.float32(0)] * t
    for i, x in enumerate(w):
        threads[i % t] = np.float32(threads[i % t] + x)

    def tree(vals):
        while len(vals) > 1:
            h = len(vals) // 2
            vals = [np.float32(vals[i] + vals[i + h]) for i in range(h)]
        return vals[0]

    warps = [tree(threads[k:k + 32]) for k in range(0, t, 32)]
    total = np.maximum(tree(warps + [np.float32(0)] * (32 - len(warps))),
                       np.float32(1e-30))
    wn = (w / total).astype(np.float32)
    splits, rows = tref.agg_splits(c, p)
    parts = []
    for q in range(splits):
        acc = np.zeros(p, np.float32)
        for i in range(q * rows, min(c, (q + 1) * rows)):
            acc = acc + wn[i] * u[i]
        parts.append(acc)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


@pytest.mark.parametrize("c,p", [(1, 33), (131, 40), (1000, 2000)])
def test_plain_version_follows_the_kernels_splits(c, p):
    """``hier_aggregate_ref`` against the written-out kernel, bit for bit,
    at C = 1 (one split), 131 and 1000 (eight splits)."""
    u, w = inputs(c, p, c)
    got = tref.hier_aggregate_ref(torch.tensor(u), torch.tensor(w))
    want = emulate_splits(u, w)
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_card():
    """The CUDA kernel against the plain version on the same card tensors:
    bit for bit in float32, 2e-2 in bfloat16; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for c, p, _ in SHAPES + [(37, 4099, 0), (300, 1030, 0), (2500, 8, 0),
                             (1000, 101_770, 0), (131, 101_770, 0)]:
        u, w = (torch.tensor(x, device="cuda") for x in inputs(c, p, c))
        before = tha.LAUNCHES
        got = tha.hier_aggregate(u, w)
        torch.cuda.synchronize()
        assert tha.LAUNCHES == before + 1
        assert torch.equal(got, tref.hier_aggregate_ref(u, w))
    u, w = (torch.tensor(x, device="cuda") for x in inputs(16, 1000, 3))
    u16 = u.to(torch.bfloat16)
    got = tha.hier_aggregate(u16, w)
    torch.testing.assert_close(got.float(),
                               tref.hier_aggregate_ref(u16, w).float(),
                               atol=2e-2, rtol=2e-2)
    with pytest.raises(ValueError):                  # not contiguous
        tha.hier_aggregate(u.t(), torch.ones(1000, device="cuda"))
