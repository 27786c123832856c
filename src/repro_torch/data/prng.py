"""JAX's counter-based PRNG in integer torch: ``threefry2x32``.

The port's data pipeline draws its batches as the JAX package's does, so
that a batch is the same array in both packages and a checkpoint of
either resumes on the same data.  This is the key derivation of
``jax.random`` under the ``threefry2x32`` implementation with
``jax_threefry_partitionable=True`` (jax 0.9's default):

* :func:`prng_key` — ``jax.random.PRNGKey(seed)``: the key ``(0, seed)``
  for a 32-bit seed;
* :func:`fold_in` — ``jax.random.fold_in``: one hash of the counter
  ``(0, data)`` under the key;
* :func:`split` — ``jax.random.split``: key ``i`` is the hash of the
  counter ``(0, i)``;
* :func:`random_bits` — 32-bit draws: the hash of each element's
  row-major index, its two words xored;
* :func:`uniform` — ``jax.random.uniform`` in f32: 23 random mantissa
  bits under the exponent of 1.0, minus 1, scaled into
  ``[minval, maxval)``.

A key is a CPU ``int64`` tensor of two uint32 words.  The words live in
int64 with an explicit ``& 0xFFFFFFFF`` after each add and shift, as the
port's other u32 arithmetic does (``repro_torch/examples/phold.py``).
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) of the counter words
    ``(x0, x1)`` under the key ``(k0, k1)``; every argument an int64
    tensor of uint32 values (the key words 0-d), broadcast together."""
    ks = (k0, k1, (k0 ^ k1 ^ _PARITY) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed that fits 32 bits."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64)


def _counts(n: int):
    """The high and low words of the 64-bit iota ``0 .. n-1``."""
    idx = torch.arange(n, dtype=torch.int64)
    return idx >> 32, idx & _MASK


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``."""
    hi, lo = threefry2x32(key[0], key[1], torch.zeros((), dtype=torch.int64),
                          torch.tensor(int(data) & _MASK))
    return torch.stack([hi, lo])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``[num, 2]`` keys."""
    return torch.stack(threefry2x32(key[0], key[1], *_counts(num)), dim=1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits an element (uint32 values in int64), ``shape``."""
    b0, b1 = threefry2x32(key[0], key[1], *_counts(math.prod(shape)))
    return (b0 ^ b1).reshape(shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    bits = (random_bits(key, shape) >> 9) | 0x3F800000   # exponent of 1.0
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # XLA contracts ``floats * (hi - lo) + lo`` into one fused
    # multiply-add: the f32 product is exact in f64, so the f64 sum
    # rounded once to f32 gives the fused result.
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)
