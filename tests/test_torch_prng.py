"""Port parity: ``repro_torch.core.prng`` reproduces the ``jax.random``
calls of the association engine bit for bit (threefry2x32, partitionable
layout, int32 ``randint``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

torch.set_num_threads(2)


def _bits(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key) if jnp.issubdtype(
        key.dtype, jax.dtypes.prng_key) else key).astype(np.int64)


def test_jax_defaults_are_the_ported_layout():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_prng_key(seed):
    assert np.array_equal(prng.PRNGKey(seed).numpy(),
                          _bits(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 3])
@pytest.mark.parametrize("seed", [0, 7])
def test_split(seed, num):
    got = prng.split(prng.PRNGKey(seed), num)
    assert got.shape == (num, 2)
    assert np.array_equal(got.numpy(),
                          _bits(jax.random.split(jax.random.PRNGKey(seed),
                                                 num)))


@pytest.mark.parametrize("data", [0, 1, 2, 3])
def test_fold_in(data):
    key = jax.random.split(jax.random.PRNGKey(3))[1]
    got = prng.fold_in(torch.as_tensor(_bits(key)), data)
    assert np.array_equal(got.numpy(), _bits(jax.random.fold_in(key, data)))


@pytest.mark.parametrize("span", [2, 14, 20, 1000, 2**20 + 3])
def test_randint(span):
    """The engine's draw, ``randint(sub, (S, 2), 0, n)`` at S = 64, and a
    range with a negative lower end."""
    key = jax.random.split(jax.random.PRNGKey(11))[1]
    tkey = torch.as_tensor(_bits(key))
    for lo in (0, -5):
        want = np.asarray(jax.random.randint(key, (64, 2), lo, lo + span,
                                             dtype=jnp.int32))
        got = prng.randint(tkey, (64, 2), lo, lo + span)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want.astype(np.int64))
        assert got.min() >= lo and got.max() < lo + span


def test_engine_stream_anchors():
    """The first exchange round of a run with seed 0: split, then draw."""
    key, sub = prng.split(prng.PRNGKey(0))
    assert prng.PRNGKey(0).tolist() == [0, 0]
    assert prng.split(prng.PRNGKey(0)).tolist() == [
        [1797259609, 2579123966], [928981903, 3453687069]]
    assert prng.randint(sub, (4, 2), 0, 20).tolist() == [
        [2, 2], [16, 15], [11, 7], [12, 10]]
    jkey, jsub = jax.random.split(jax.random.PRNGKey(0))
    assert np.array_equal(key.numpy(), _bits(jkey))
