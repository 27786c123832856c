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
  ``[minval, maxval)``;
* :func:`normal` — ``jax.random.normal`` in f32: ``sqrt(2) *
  erf_inv(u)`` with ``u`` uniform in ``(-1, 1)`` (its low end
  ``nextafter(-1, 0)``), through :func:`erf_inv_f32`, XLA's f32
  ``erf_inv``.  That is Giles's single-precision polynomial behind
  ``w = -log1p(-u^2)``; XLA evaluates the log with its own f32
  polynomial, which torch has not, so a draw lies within 3 f32 ulps of
  JAX's, and about 0.6% of the elements differ at all
  (``tests/test_torch_mrope.py`` counts them).

A key is a CPU ``int64`` tensor of two uint32 words.  The words live in
int64 with an explicit ``& 0xFFFFFFFF`` after each add and shift, as the
port's other u32 arithmetic does (``repro_torch/examples/phold.py``).
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
# Giles (2010), "Approximating the erfinv function": the coefficients of
# XLA's f32 ``erf_inv`` for w = -log1p(-x^2) below 5 and from 5 up.
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)
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
    # XLA contracts ``floats * (hi - lo) + lo`` into one multiply-add.
    return torch.maximum(lo, _fma_f32(floats, hi - lo, lo))


def _fma_f32(a, b, c):
    """``a * b + c`` of f32 tensors rounded once to f32, as XLA's
    contracted multiply-add: the f32 product is exact in f64, so the f64
    sum rounded once to f32 gives the fused result."""
    return (a.double() * b.double() + c.double()).float()


def erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` (``jax.lax.erf_inv``): Giles's polynomial in
    ``w = -log1p(-x^2)``, its Horner steps fused multiply-adds as XLA
    contracts them; +-inf at +-1.  ``log1p`` splits as XLA's does, at
    ``|x| = sqrt(2) - 1``, into ``log1p`` and ``log(1 + x)``, each taken in
    f64 and rounded once.  ``sqrt(2) * torch.erfinv`` in f64, rounded once
    to f32, is no stand-in: it is nearer the true value than XLA's
    polynomial, and so lies up to 91 f32 ulps from JAX's draw, with 66%
    of the elements differing (seeds 0 and 3;
    ``tests/test_torch_mrope.py``)."""
    x = x.float()
    m = x * -x
    small = torch.log1p(m.double()).float()
    large = torch.log((1.0 + m).double()).float()
    w = -torch.where(m.abs() < 0.41421356237309504880, small, large)
    lt = w < 5.0
    lo = torch.tensor(_ERFINV_W_LT_5, dtype=torch.float32)
    hi = torch.tensor(_ERFINV_W_GE_5, dtype=torch.float32)
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, lo[0], hi[0])
    for i in range(1, len(_ERFINV_W_LT_5)):
        p = _fma_f32(p, w, torch.where(lt, lo[i], hi[i]))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``, within 3 f32 ulps
    (:func:`erf_inv_f32`)."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
    u = uniform(key, shape, minval=lo, maxval=1.0)
    return torch.tensor(math.sqrt(2), dtype=torch.float32) * erf_inv_f32(u)
