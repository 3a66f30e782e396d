"""The JAX PRNG calls the association engine makes, bit for bit, in torch.

``PRNGKey``, ``split``, ``fold_in`` and ``randint`` (int32) of
``jax.random`` under its default implementation, threefry2x32 with the
partitionable bit layout (``jax_threefry_partitionable``): a key is two
uint32 words, ``split`` hashes the counters ``(0, i)``, ``fold_in`` hashes
``(0, data)``, and random bits of a shape hash the 64-bit row-major counter
split into its high and low words, then xor the two output words.

torch has little uint32 arithmetic, so every word is held in an int64
tensor and masked to 32 bits after each add, multiply and rotate. Keys are
``(2,)`` int64 tensors on the host; draws come out on the host too, and a
caller moves them where it needs them, so a draw is the same whatever
device the engine runs on.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b mod 2^32`` for words below 2^32, in 16-bit halves of ``b``
    so that no product leaves int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter words ``x1, x2``
    under the key ``(k1, k2)``; the words are int64 tensors below 2^32."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def _words(key: torch.Tensor) -> tuple[int, int]:
    k1, k2 = (int(v) for v in key.reshape(2).tolist())
    return k1 & _M32, k2 & _M32


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32 bits."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64)


def _counters(n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low words of the counters 0 .. n-1."""
    count = torch.arange(n, dtype=torch.int64)
    return count >> 32, count & _M32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(num, 2)`` keys."""
    hi, lo = _counters(num)
    b1, b2 = threefry2x32(*_words(key), hi, lo)
    return torch.stack([b1, b2], dim=1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a data word below 2^32."""
    b1, b2 = threefry2x32(*_words(key), torch.zeros(1, dtype=torch.int64),
                          torch.tensor([int(data) & _M32]))
    return torch.cat([b1, b2])


def random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element of ``shape``, as int64 words."""
    n = 1
    for s in shape:
        n *= int(s)
    hi, lo = _counters(n)
    b1, b2 = threefry2x32(*_words(key), hi, lo)
    return (b1 ^ b2).reshape(shape)


def randint(key: torch.Tensor, shape: tuple[int, ...], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32 (JAX's
    default integer type without x64): two draws of 32 bits, each taken
    mod the span, joined as ``hi * (2^32 mod span) + lo`` in uint32
    wrap-around (the square of 2^16 wraps to 0 once the span exceeds
    2^16), then mod the span. Returns int64 values."""
    minval, maxval = int(minval), int(maxval)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span_t = torch.tensor(span, dtype=torch.int64)
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & _M32) % span
    offset = (_mul32(higher % span_t, torch.tensor(multiplier))
              + lower % span_t) & _M32
    return minval + offset % span_t
