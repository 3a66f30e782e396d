"""Port parity: ``repro_torch.core.compression`` against
``repro.core.compression``.

- TopK: the kept mask is identical (a tie at the threshold included:
  every entry whose magnitude equals the k-th largest is kept), with the
  kept values and the error-feedback residual at rtol 1e-6 (the residual
  is ``u + e - kept``, the same float32 adds);
- Int8: bit-identical (the same per-tensor scale, a division by it,
  round half to even, clip);
- ``wire_bytes`` and ``no_compression_bytes``: equal.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import compression as tc
from repro_torch.utils import tree_leaves, tree_map

try:                     # the oracle; absent on a machine with only torch
    import jax
    import jax.numpy as jnp

    from repro.core import compression as jc
except ImportError:
    jax = None

torch.set_num_threads(2)


def need_jax():
    if jax is None:
        pytest.skip("needs JAX, the oracle")


def tree(seed):
    r = np.random.default_rng(seed)
    return {"w": r.normal(size=(2, 37, 19)).astype(np.float32),
            "b": r.normal(size=(2, 5)).astype(np.float32),
            "s": {"scale": (1e-3 * r.normal(size=(2, 300))).astype(np.float32)}}


def both(t):
    return jax.tree.map(jnp.asarray, t), tree_map(torch.tensor, t)


@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.5])
def test_topk_matches_jax(ratio):
    need_jax()
    ju, tu = both(tree(0))
    je, te = both(tree_map(lambda x: 0.1 * x, tree(1)))
    jk, jr = jc.TopKCompressor(ratio).compress(ju, je)
    tk, tr = tc.TopKCompressor(ratio).compress(tu, te)
    for a, b in zip(tree_leaves(tk), jax.tree.leaves(jk)):
        b = np.asarray(b)
        np.testing.assert_array_equal(a.numpy() != 0, b != 0)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=0)
    for a, b in zip(tree_leaves(tr), jax.tree.leaves(jr)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert (tc.TopKCompressor(ratio).wire_bytes(tu)
            == jc.TopKCompressor(ratio).wire_bytes(ju))


def test_topk_keeps_every_tie_at_the_threshold():
    """k = 2 of 8 entries, and four share the second-largest magnitude:
    all five of magnitude >= the threshold are kept on both sides."""
    need_jax()
    x = np.array([[5.0, -3.0, 3.0, 0.5], [3.0, 1.0, -3.0, 0.25]],
                 np.float32)
    zeros = np.zeros_like(x)
    tk, tr = tc.TopKCompressor(0.25).compress(torch.tensor(x),
                                              torch.tensor(zeros))
    jk, jr = jc.TopKCompressor(0.25).compress(jnp.asarray(x),
                                              jnp.asarray(zeros))
    assert int((tk != 0).sum()) == 5
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_topk_init_state_is_zeros():
    t = tree_map(torch.tensor, tree(2))
    state = tc.TopKCompressor().init_state(t)
    assert all(not s.any() for s in tree_leaves(state))


@pytest.mark.parametrize("seed", [3, 4])
def test_int8_is_bit_identical_to_jax(seed):
    need_jax()
    ju, tu = both(tree(seed))
    jq, _ = jc.Int8Compressor().compress(ju, ())
    tq, state = tc.Int8Compressor().compress(tu, ())
    assert state == ()
    for a, b in zip(tree_leaves(tq), jax.tree.leaves(jq)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tc.Int8Compressor().wire_bytes(tu) == jc.Int8Compressor(
    ).wire_bytes(ju)


def test_int8_rounds_half_to_even_and_keeps_zero():
    """Entries at k + 0.5 quantization steps round to the even k, as
    ``jnp.round`` does; an all-zero leaf stays zero (scale floor 1e-12)."""
    u = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    q, _ = tc.Int8Compressor().compress(u, ())
    assert q.tolist() == [127.0, 0.0, 2.0, 2.0, -0.0, -2.0]
    z, _ = tc.Int8Compressor().compress(torch.zeros(4), ())
    assert not z.any()


def test_no_compression_bytes_matches_jax():
    need_jax()
    ju, tu = both(tree(5))
    for nbytes in (2, 4):
        assert (tc.no_compression_bytes(tu, nbytes)
                == jc.no_compression_bytes(ju, nbytes))
