"""The port's ``rwkv6_scan`` module against the JAX package.

Same numpy-seeded inputs through ``repro.kernels`` (the Pallas kernel
``rwkv6_scan_pallas`` in interpret mode, as ``tests/test_kernels.py``
runs it, and the ``ref.py`` oracle) and ``repro_torch.kernels`` (the
plain version the wrapper takes on the CPU, and the port's oracle).  The
final state, which the Pallas kernel drops, is held against a JAX
``lax.scan`` of the same recurrence.  The CUDA kernel is held to the
plain version on the card by ``chip_smoke.py``.

Tolerances are the JAX sweep's (``tests/test_kernels.py``): 2e-4 in f32
(the chunked and the sequential forms sum in another order) and 3e-2
with bf16 inputs, relative and absolute.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_scan_pallas
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_scan as tscan

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}

# (B, H, T, K, chunk): the JAX sweep's padded tail and K = 32 cases, and
# the serving head size K = 64 kept short for interpret-mode time.
SHAPES = [(2, 3, 100, 16, 32), (2, 1, 64, 32, 16), (1, 2, 40, 64, 16)]


def _inputs(seed, B, H, T, K, dtype, decay="normal"):
    """r, k, v, logw, u as (JAX arrays, torch tensors), rounded to
    ``dtype`` alike.  ``decay="strong"`` puts log w near -20 (down to
    about -150): w underflows toward 0 but never past it."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    shape = (B, H, T, K)
    shift = 3.0 if decay == "strong" else -1.0
    arrays = [rng.standard_normal(shape), rng.standard_normal(shape),
              rng.standard_normal(shape),
              -np.exp(rng.standard_normal(shape) * 0.5 + shift),
              rng.standard_normal((H, K)) * 0.1]
    js = [jnp.asarray(a, jnp.float32).astype(jdt) for a in arrays]
    ts = [torch.from_numpy(np.array(j, np.float32)).to(tdt) for j in js]
    return js, ts


def _jax_final_state(k, v, logw):
    """S_T of the recurrence, by a JAX ``lax.scan`` in f32."""
    B, H, T, K = k.shape
    f = lambda a: jnp.moveaxis(a.astype(jnp.float32), 2, 0)

    def step(S, xs):
        kt, vt, wt = xs
        return wt[..., None] * S + jnp.einsum("bhk,bhv->bhkv", kt, vt), None

    S, _ = jax.lax.scan(step, jnp.zeros((B, H, K, K), jnp.float32),
                        (f(k), f(v), jnp.exp(f(logw))))
    return np.asarray(S)


def _close(got, want, tol):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,T,K,chunk", SHAPES)
def test_plain_matches_pallas_and_ref(dtype, B, H, T, K, chunk):
    tol = DTYPES[dtype][2]
    (jr, jk, jv, jw, ju), (tr, tk, tv, tw, tu) = _inputs(
        B * 1000 + T, B, H, T, K, dtype)
    pallas = rwkv6_scan_pallas(jr, jk, jv, jw, ju, chunk=chunk)
    oracle = jref.rwkv6_scan_ref(jr, jk, jv, jw, ju)
    y, S = tscan.rwkv6_scan(tr, tk, tv, tw, tu)
    assert tuple(y.shape) == (B, H, T, K) and tuple(S.shape) == (B, H, K, K)
    _close(y, pallas, tol)
    _close(y, oracle, tol)
    _close(tref.rwkv6_scan_ref(tr, tk, tv, tw, tu), oracle, tol)
    _close(S, _jax_final_state(jk, jv, jw), tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_strong_decay_has_no_underflow(dtype):
    """log w near -20: the exact pair decays of the Pallas kernel and
    the port's sequential product stay finite and agree."""
    tol = DTYPES[dtype][2]
    (jr, jk, jv, jw, ju), (tr, tk, tv, tw, tu) = _inputs(
        7, 1, 2, 48, 16, dtype, decay="strong")
    assert float(tw.float().max()) < -0.5 and float(tw.float().min()) < -60
    pallas = rwkv6_scan_pallas(jr, jk, jv, jw, ju, chunk=16)
    y, S = tscan.rwkv6_scan(tr, tk, tv, tw, tu)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(S).all())
    _close(y, pallas, tol)
    _close(S, _jax_final_state(jk, jv, jw), tol)


def test_model_layout_views_through_ops():
    """``ops.rwkv6_scan`` takes ``[B,H,T,K]`` views of the model's
    ``[B,T,H,K]`` streams, as JAX's ``ops.rwkv6_scan`` takes the
    transposed arrays."""
    B, H, T, K = 2, 2, 24, 16
    (jr, jk, jv, jw, ju), _ = _inputs(3, B, H, T, K, "f32")
    want = jops.rwkv6_scan(jr, jk, jv, jw, ju, chunk=8)
    model = [torch.from_numpy(np.array(a)).transpose(1, 2).contiguous()
             for a in (jr, jk, jv, jw)]                   # [B,T,H,K]
    views = [t.transpose(1, 2) for t in model]            # [B,H,T,K] views
    assert not views[0].is_contiguous() and views[0].stride(-1) == 1
    u = torch.from_numpy(np.array(ju))
    y = tops.rwkv6_scan(*views, u, chunk=8)
    _close(y, want, 2e-4)
    y2, S = tops.rwkv6_scan(*views, u, chunk=8, return_state=True)
    assert torch.equal(y, y2) and tuple(S.shape) == (B, H, K, K)


def test_wrapper_rejects_other_devices_and_shapes():
    _, (r, k, v, w, u) = _inputs(1, 1, 2, 8, 16, "f32")
    meta = [t.to("meta") for t in (r, k, v, w, u)]
    with pytest.raises(ValueError, match="no rwkv6_scan kernel"):
        tscan.rwkv6_scan(*meta)
    _, (r8, k8, v8, w8, u8) = _inputs(1, 1, 2, 8, 8, "f32")
    with pytest.raises(ValueError, match="head dim K=8"):
        tscan.rwkv6_scan(r8, k8, v8, w8, u8)
    with pytest.raises(ValueError, match="k has shape"):
        tscan.rwkv6_scan(r, k[:, :, :4], v, w, u)
    with pytest.raises(ValueError, match="u has shape"):
        tscan.rwkv6_scan(r, k, v, w, u[:1])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tscan.rwkv6_scan(*(t.half() for t in (r, k, v, w, u)))
    with pytest.raises(TypeError, match="logw has dtype"):
        tscan.rwkv6_scan(r, k, v, w.bfloat16(), u)
    strided = torch.zeros((1, 2, 8, 32))[..., ::2]
    with pytest.raises(ValueError, match="contiguous last dim"):
        tscan.rwkv6_scan(r, strided, v, w, u)
    with pytest.raises(ValueError, match="empty scan"):
        tscan.rwkv6_scan(*(t[:, :, :0] for t in (r, k, v, w)), u)


def test_cpu_route_launches_no_kernel():
    tscan.reset_launches()
    _, (r, k, v, w, u) = _inputs(2, 1, 2, 8, 16, "bf16")
    tscan.rwkv6_scan(r, k, v, w, u)
    tops.rwkv6_scan(r, k, v, w, u)
    assert tscan.LAUNCHES == {"rwkv6_scan": 0}
