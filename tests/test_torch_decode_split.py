"""Split-K decode attention, the algorithm of the port's CUDA kernel,
against the JAX package.

``decode_attention_split_plain`` (per-range online-softmax state, then
the f32 merge) takes numpy-seeded inputs beside JAX's
``decode_attention_pallas`` (interpret mode) and the port's
``decode_attention_plain``, in f32 to 1e-5 (the same math, summed in
another order).  The lengths sit at 0, 1, a range boundary +- 1 and S,
so that ranges past a sequence's end (m = -1e30, l = 0) and sequences
with no key at all go through the merge; and at the ranges
``choose_splits`` gives the CUDA kernel (whole 32-key tiles, the last
range possibly short), held to the plain version.  ``choose_splits`` is
checked to cover the cache exactly from shapes alone.  The kernel itself
is held to these plain versions on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_pallas
from repro_torch.kernels import decode_attention as tdecode

TOL = 1e-5
S = 96
SPLITS = (1, 2, 3, 4, 8)
# 0, 1, each range boundary of SPLITS (ceil(S / splits) multiples) +- 1,
# and S.
LENGTHS = (0, 1, 11, 12, 13, 23, 24, 25, 31, 32, 33, 47, 48, 49, 95, S)


def _inputs(rng, B, H, KV, D):
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, KV, S, D)).astype(np.float32)
    v = rng.standard_normal((B, KV, S, D)).astype(np.float32)
    return q, k, v


@functools.lru_cache(maxsize=None)
def _case(G, D):
    """Inputs of one head layout and JAX's Pallas decode on them."""
    KV = 2 if G == 1 else 1
    rng = np.random.default_rng([G, D])
    q, k, v = _inputs(rng, len(LENGTHS), G * KV, KV, D)
    lens = np.asarray(LENGTHS, np.int32)
    want = np.asarray(decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        block_k=32))
    return q, k, v, lens, want


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("G,D", [(1, 64), (4, 64), (8, 64), (1, 160),
                                 (4, 160), (8, 160)])
def test_split_plain_matches_jax_and_plain(splits, G, D):
    q, k, v, lens, want = _case(G, D)
    edge = -(-S // splits)
    assert {edge - 1, edge, edge + 1} & set(LENGTHS) or splits == 1
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tl = torch.from_numpy(lens)
    got = tdecode.decode_attention_split_plain(tq, tk, tv, tl, splits)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        got.numpy(), tdecode.decode_attention_plain(tq, tk, tv, tl).numpy(),
        rtol=TOL, atol=TOL)
    assert np.all(got[0].numpy() == 0.0)        # length 0 comes out 0


# (B, KV, S) of decode shapes ``chip_smoke.py`` runs the kernel at:
# serving's cache (S 256), S 4096 at B 4 and 6, and two whose last range
# is short (300 keys in 4 ranges of 96, the last 12).
KERNEL_SHAPES = [(4, 8, 256), (4, 8, 4096), (6, 8, 4096), (2, 2, 300),
                 (2, 8, 128)]


@pytest.mark.parametrize("B,KV,S_", KERNEL_SHAPES)
def test_split_plain_at_the_kernels_ranges(B, KV, S_):
    """The ranges ``choose_splits`` gives the CUDA kernel on a 132-SM
    card, lengths at 0, 1 and each side of the first and the last range
    boundary, and S."""
    splits, chunk = tdecode.choose_splits(B, KV, S_, 132)
    last = (splits - 1) * chunk
    lengths = sorted({0, 1, chunk - 1, chunk, chunk + 1, last - 1, last,
                      last + 1, S_ - 1, S_} & set(range(S_ + 1)))
    rng = np.random.default_rng([B, KV, S_])
    q = rng.standard_normal((len(lengths), 4, 64)).astype(np.float32)
    k = rng.standard_normal((len(lengths), 1, S_, 64)).astype(np.float32)
    v = rng.standard_normal((len(lengths), 1, S_, 64)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tl = torch.tensor(lengths, dtype=torch.int32)
    got = tdecode.decode_attention_split_plain(tq, tk, tv, tl, splits, chunk)
    np.testing.assert_allclose(
        got.numpy(), tdecode.decode_attention_plain(tq, tk, tv, tl).numpy(),
        rtol=TOL, atol=TOL)
    assert np.all(got[0].numpy() == 0.0)        # length 0 comes out 0


def test_kernel_shapes_include_a_short_last_range():
    pairs = [tdecode.choose_splits(B, KV, S_, 132)
             for B, KV, S_ in KERNEL_SHAPES]
    assert any(splits * chunk > S_ for (splits, chunk), (_, _, S_)
               in zip(pairs, KERNEL_SHAPES))


@pytest.mark.parametrize("splits,chunk", [(2, 32), (5, 20), (4, 32)])
def test_split_plain_refuses_ranges_the_kernel_never_has(splits, chunk):
    """80 keys: 2 x 32 leaves keys 64-79 out; 5 x 20 and 4 x 32 leave the
    last range empty."""
    q, k, v = (torch.zeros(s) for s in ((1, 2, 16), (1, 1, 80, 16),
                                        (1, 1, 80, 16)))
    with pytest.raises(ValueError):
        tdecode.decode_attention_split_plain(
            q, k, v, torch.tensor([80], dtype=torch.int32), splits, chunk)


def test_split_plain_keeps_the_input_dtype():
    rng = np.random.default_rng(3)
    q, k, v = _inputs(rng, 2, 4, 2, 64)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    tl = torch.tensor([5, S], dtype=torch.int32)
    got = tdecode.decode_attention_split_plain(tq, tk, tv, tl, 3)
    want = tdecode.decode_attention_plain(tq, tk, tv, tl)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=1e-2)


@pytest.mark.parametrize("B,KV,S_,sm", [
    (4, 8, 256, 132), (4, 8, 4096, 132), (1, 8, 256, 132), (1, 1, 1, 132),
    (3, 2, 31, 132), (4, 8, 130, 132), (64, 8, 256, 132), (2, 4, 1000, 16),
    (1, 8, 65536, 132), (4, 8, 64, 132)])
def test_choose_splits_covers_the_cache(B, KV, S_, sm):
    splits, chunk = tdecode.choose_splits(B, KV, S_, sm)
    assert splits >= 1 and chunk >= 1
    assert chunk % tdecode.SPLIT_TILE == 0
    # [i * chunk, min((i + 1) * chunk, S)) for i < splits covers [0, S)
    # exactly, and the last range is not empty.
    assert (splits - 1) * chunk < S_ <= splits * chunk
    assert splits <= max(1, S_ // tdecode.SPLIT_MIN_KEYS)
    assert B * KV * splits < B * KV * 2 + sm     # about one block an SM


def test_choose_splits_fills_the_card_at_the_serve_shape():
    """B 4, KV 8, S 256 on 132 SMs: more blocks than B * KV = 32."""
    splits, chunk = tdecode.choose_splits(4, 8, 256, 132)
    assert (splits, chunk) == (4, 64)
    assert 4 * 8 * splits > 32


def test_choose_splits_never_takes_lengths():
    """The host chooses the splits from shapes: serving's one host read
    per decode batch stays one."""
    params = list(inspect.signature(tdecode.choose_splits).parameters)
    assert params == ["B", "KV", "S", "sm_count"]
