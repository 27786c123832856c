"""The port's attention kernel modules against the JAX package.

Same numpy-seeded inputs through ``repro.kernels`` (the ``ref.py``
oracles, and the Pallas kernels through ``repro.kernels.ops`` in
interpret mode) and ``repro_torch.kernels``.  On CPU tensors the port's
wrappers run their plain versions; the CUDA kernels are held to those
plain versions on the card by ``chip_smoke.py``.

Tolerances: 1e-5 in f32 (the same math, summed in another order) and
2e-2 in bf16 (one rounding of an O(1) output, plus bf16 inputs summed
in another order).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(rng, shape, dtype):
    """One N(0,1) array in both packages, rounded to ``dtype`` alike."""
    jdt, tdt, _ = DTYPES[dtype]
    x = jnp.asarray(rng.standard_normal(shape), jnp.float32).astype(jdt)
    t = torch.from_numpy(np.array(x, np.float32)).to(tdt)
    return x, t


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

# (G, B, KV, T, S, D): square shapes, and S not a multiple of the
# Pallas kernel's 128-key block (its tail is padded and masked).
FLASH_SHAPES = [
    (1, 2, 2, 64, 64, 32),
    (2, 1, 2, 64, 160, 16),
    (4, 1, 1, 32, 160, 16),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G,B,KV,T,S,D", FLASH_SHAPES)
def test_flash_matches_jax(dtype, causal, G, B, KV, T, S, D):
    rng = np.random.default_rng([B, KV, T, S, D, G, int(causal)])
    H = KV * G
    tol = DTYPES[dtype][2]
    # model layout [B,T,H,D] / [B,S,KV,D]
    jq, tq = _pair(rng, (B, T, H, D), dtype)
    jk, tk = _pair(rng, (B, S, KV, D), dtype)
    jv, tv = _pair(rng, (B, S, KV, D), dtype)

    want_ops = jops.flash_attention(jq, jk, jv, causal=causal)
    got_ops = tops.flash_attention(tq, tk, tv, causal=causal)
    assert got_ops.dtype == tq.dtype and got_ops.shape == tq.shape
    _close(got_ops, want_ops, tol)

    # kernel layout [B,H,T,D] / [B,KV,S,D]: wrapper and oracle
    kl = lambda x: x.transpose(0, 2, 1, 3)
    want_ref = jref.flash_attention_ref(kl(jq), kl(jk), kl(jv), causal=causal)
    tl = lambda x: x.transpose(1, 2)
    _close(tref.flash_attention_ref(tl(tq), tl(tk), tl(tv), causal=causal),
           want_ref, tol)
    _close(tflash.flash_attention(tl(tq), tl(tk), tl(tv), causal=causal),
           want_ref, tol)


def test_flash_keeps_the_block_q_shape_rule():
    q = torch.zeros((1, 2, 160, 16))
    k = torch.zeros((1, 2, 160, 16))
    with pytest.raises(ValueError, match="multiple of block_q"):
        tflash.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="multiple of block_q"):
        jops.flash_attention(jnp.zeros((1, 160, 2, 16)),
                             jnp.zeros((1, 160, 2, 16)),
                             jnp.zeros((1, 160, 2, 16)))


def test_flash_first_key_is_valid_for_every_row():
    """With ``-1e30`` masking, a row whose first tiles are fully masked
    would carry exp(0) terms until a valid tile wipes them (corr = 0);
    causal rows always see key 0 in the first tile, so both packages
    come out as the softmax over their valid keys.  Pinned on a
    sequence of one key and on constant scores."""
    q = torch.zeros((1, 1, 32, 16))
    k = torch.zeros((1, 1, 32, 16))
    v = torch.arange(32, dtype=torch.float32).reshape(1, 1, 32, 1) \
        .expand(1, 1, 32, 16).contiguous()
    o = tflash.flash_attention(q, k, v, causal=True)
    # row t averages v[0..t] = t / 2
    want = (torch.arange(32, dtype=torch.float32) / 2)[:, None]
    torch.testing.assert_close(o[0, 0], want.expand(32, 16))
    jo = jops.flash_attention(jnp.asarray(q.numpy()).transpose(0, 2, 1, 3),
                              jnp.asarray(k.numpy()).transpose(0, 2, 1, 3),
                              jnp.asarray(v.numpy()).transpose(0, 2, 1, 3))
    np.testing.assert_allclose(np.asarray(jo)[0, :, 0, 0], want[:, 0].numpy(),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

# (G, S, lengths): lengths 1 and S, and S not a multiple of the Pallas
# kernel's 512-key block.
DECODE_SHAPES = [
    (1, 64, (1, 17, 64)),
    (2, 600, (1, 513, 600)),
    (4, 64, (64, 1, 33)),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("G,S,lengths", DECODE_SHAPES)
def test_decode_matches_jax(dtype, G, S, lengths):
    rng = np.random.default_rng([S, G, len(dtype)])
    B, KV, D = len(lengths), 2, 32
    H = KV * G
    tol = DTYPES[dtype][2]
    jq, tq = _pair(rng, (B, H, D), dtype)
    jk, tk = _pair(rng, (B, S, KV, D), dtype)      # model layout
    jv, tv = _pair(rng, (B, S, KV, D), dtype)
    jl = jnp.asarray(lengths, jnp.int32)
    tlen = torch.tensor(lengths, dtype=torch.int32)

    want_ops = jops.decode_attention(jq, jk, jv, jl)
    got_ops = tops.decode_attention(tq, tk, tv, tlen)
    assert got_ops.dtype == tq.dtype and got_ops.shape == tq.shape
    _close(got_ops, want_ops, tol)

    kl = lambda x: x.transpose(0, 2, 1, 3)
    want_ref = jref.decode_attention_ref(jq, kl(jk), kl(jv), jl)
    tl = lambda x: x.transpose(1, 2)
    _close(tref.decode_attention_ref(tq, tl(tk), tl(tv), tlen), want_ref,
           tol)
    _close(tdecode.decode_attention(tq, tl(tk), tl(tv), tlen), want_ref, tol)


def test_decode_length_zero_is_zero_as_the_kernel_gives_it():
    """The Pallas kernel skips every block of a length-0 sequence and
    returns 0; the port's wrapper (both routes) does the same, while
    the oracle gives a uniform softmax over all S keys — in both
    packages."""
    rng = np.random.default_rng(7)
    B, H, KV, S, D = 2, 4, 2, 64, 16
    jq, tq = _pair(rng, (B, H, D), "f32")
    jk, tk = _pair(rng, (B, S, KV, D), "f32")
    jv, tv = _pair(rng, (B, S, KV, D), "f32")
    jl = jnp.asarray([0, 5], jnp.int32)
    tlen = torch.tensor([0, 5], dtype=torch.int32)

    want = np.asarray(jops.decode_attention(jq, jk, jv, jl))
    got = tops.decode_attention(tq, tk, tv, tlen)
    assert np.all(want[0] == 0.0)
    assert torch.all(got[0] == 0.0)
    _close(got, want, 1e-5)

    kl = lambda x: x.transpose(0, 2, 1, 3)
    want_ref = np.asarray(jref.decode_attention_ref(jq, kl(jk), kl(jv), jl))
    got_ref = tref.decode_attention_ref(tq, tk.transpose(1, 2),
                                        tv.transpose(1, 2), tlen)
    uniform = tv.float().mean(dim=1)                 # [B,KV,D]
    torch.testing.assert_close(got_ref[0].reshape(KV, -1, D),
                               uniform[0][:, None].expand(KV, H // KV, D))
    _close(got_ref, want_ref, 1e-5)


def test_wrappers_reject_other_devices():
    q = torch.zeros((1, 2, 32, 16), device="meta")
    with pytest.raises(ValueError, match="no flash_attention kernel"):
        tflash.flash_attention(q, q, q)
    qd = torch.zeros((1, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no decode_attention kernel"):
        tdecode.decode_attention(qd, q, q, torch.zeros(1, dtype=torch.int32,
                                                       device="meta"))


def test_cpu_route_launches_no_kernel():
    tflash.reset_launches()
    tdecode.reset_launches()
    q = torch.zeros((1, 2, 32, 16))
    tflash.flash_attention(q, q, q)
    tdecode.decode_attention(q[:, :, 0], q, q,
                             torch.tensor([3], dtype=torch.int32))
    assert tflash.LAUNCHES == {"flash_attention": 0}
    assert tdecode.LAUNCHES == {"decode_attention": 0}
