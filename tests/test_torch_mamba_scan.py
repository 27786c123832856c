"""The port's ``mamba_scan`` module against the JAX package.

Same numpy-seeded inputs through ``repro.kernels`` (the Pallas kernel
``mamba_scan_pallas`` in interpret mode, as ``tests/test_kernels.py``
runs it, and the ``ref.py`` oracle) and ``repro_torch.kernels`` (the
plain version the wrapper takes on the CPU, and the port's oracle).  The
final state, which the Pallas kernel drops, is held against the ``h_fin``
of JAX's ``mamba_apply(return_state=True)`` on the same layer.  The CUDA
kernel is held to the plain version on the card by ``chip_smoke.py``.

Tolerance: rtol = atol = 3e-5, the JAX sweep's for f32
(``tests/test_kernels.py``): the sequential and the chunked forms sum
the same f32 products in another order.  With bf16 inputs both packages
convert the same values to f32 first, so the same tolerance holds.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.mamba_scan import mamba_scan_pallas
from repro.models import ssm as jssm
from repro_torch.kernels import mamba_scan as tscan
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import ssm as tssm
from repro_torch.models.model import _to_tensor

TOL = dict(rtol=3e-5, atol=3e-5)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}

# (B, T, I, N, chunk, block_i): T not a multiple of chunk, each N the
# kernel instantiates, and the JAX sweep's production-ish dims.
SHAPES = [(2, 50, 64, 8, 16, 32), (1, 37, 128, 16, 16, 128),
          (3, 33, 32, 4, 8, 32)]


def _inputs(seed, B, T, I, N, dtype, layout="contiguous", R=5):
    """xdt, dt, bc, cc, a as (JAX arrays, torch tensors), the streams
    rounded to ``dtype`` alike, ``a`` in f32 (as the JAX sweep).
    ``layout="proj"``: bc and cc are column slices of one ``[B,T,R+2N]``
    array, as the model's ``x_proj`` output hands them over."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((B, T, I))
    dt = np.log1p(np.exp(rng.standard_normal((B, T, I))))      # softplus
    proj = rng.standard_normal((B, T, R + 2 * N))
    a = -np.exp(rng.standard_normal((I, N)) * 0.3)
    j = [jnp.asarray(v, jnp.float32).astype(jdt) for v in (xdt, dt, proj)]
    ja = jnp.asarray(a, jnp.float32)
    t = [torch.from_numpy(np.array(v, np.float32)).to(tdt) for v in j]
    ta = torch.from_numpy(np.array(ja))
    jb, jc = j[2][..., R:R + N], j[2][..., R + N:]
    if layout == "proj":
        tb, tc = t[2][..., R:R + N], t[2][..., R + N:]
        assert not tb.is_contiguous() and tb.stride(-1) == 1
    else:
        tb, tc = t[2][..., R:R + N].contiguous(), t[2][..., R + N:].contiguous()
    return (j[0], j[1], jb, jc, ja), (t[0], t[1], tb, tc, ta)


def _jax_final_state(xdt, dt, bc, cc, a):
    """h_T of the recurrence, by a JAX ``lax.scan`` in f32."""
    f = lambda v: jnp.moveaxis(v.astype(jnp.float32), 1, 0)

    def step(h, xs):
        x_t, dt_t, b_t = xs
        return jnp.exp(dt_t[..., None] * a) * h + \
            x_t[..., None] * b_t[:, None, :], None

    B, _, I = xdt.shape
    h, _ = jax.lax.scan(step, jnp.zeros((B, I, a.shape[-1]), jnp.float32),
                        (f(xdt), f(dt), f(bc)))
    return np.asarray(h)


@functools.lru_cache(maxsize=None)
def _jax_outputs(seed, B, T, I, N, dtype, chunk, bi):
    """(Pallas y, oracle y, h_T) on the JAX side; the bc/cc layout does
    not reach JAX, so both layouts share one interpret-mode run."""
    js, _ = _inputs(seed, B, T, I, N, dtype)
    return (np.asarray(mamba_scan_pallas(*js, chunk=chunk, block_i=bi)),
            np.asarray(jref.mamba_scan_ref(*js)), _jax_final_state(*js))


def _close(got, want):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **TOL)


@pytest.mark.parametrize("layout", ["contiguous", "proj"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,T,I,N,chunk,bi", SHAPES)
def test_plain_matches_pallas_and_ref(dtype, layout, B, T, I, N, chunk, bi):
    seed = B * 1000 + T
    _, ts = _inputs(seed, B, T, I, N, dtype, layout)
    pallas, oracle, h_fin = _jax_outputs(seed, B, T, I, N, dtype, chunk, bi)
    y, h = tscan.mamba_scan(*ts)
    assert tuple(y.shape) == (B, T, I) and tuple(h.shape) == (B, I, N)
    _close(y, pallas)
    _close(y, oracle)
    _close(tref.mamba_scan_ref(*ts), oracle)
    _close(h, h_fin)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_strong_decay_stays_finite(dtype):
    """dt up to ~20: exp(dt·A) underflows toward 0 but never past it."""
    js, ts = _inputs(7, 1, 40, 32, 16, dtype)
    jx, jd, jb, jc, ja = js
    tx, td, tb, tc, ta = ts
    jd, td = jd * 8.0, td * 8.0
    assert float(td.float().max()) > 15.0
    pallas = mamba_scan_pallas(jx, jd, jb, jc, ja, chunk=16, block_i=32)
    y, h = tscan.mamba_scan(tx, td, tb, tc, ta)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    _close(y, pallas)
    _close(h, _jax_final_state(jx, jd, jb, jc, ja))


def test_ops_takes_the_jax_call():
    """``ops.mamba_scan`` takes the JAX wrapper's call (``chunk``,
    ``block_i``) and, with ``return_state``, also gives h_T."""
    js, ts = _inputs(3, 2, 24, 64, 8, "f32", "proj")
    want = jops.mamba_scan(*js, chunk=8, block_i=32)
    y = tops.mamba_scan(*ts, chunk=8, block_i=32)
    _close(y, want)
    y2, h = tops.mamba_scan(*ts, chunk=8, block_i=32, return_state=True)
    assert torch.equal(y, y2) and tuple(h.shape) == (2, 64, 8)


def test_final_state_matches_jax_mamba_apply():
    """The plain scan's h_T, fed the inputs of one mamba layer, equals
    the ``h_fin`` of JAX's ``mamba_apply(return_state=True)`` there; the
    port's ``mamba_apply(impl="pallas")`` returns it too."""
    D, N, K, T = 32, 4, 4, 13
    params = jssm.mamba_init(jax.random.PRNGKey(3), d_model=D, d_state=N,
                             d_conv=K)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((2, T, D)), jnp.float32).astype(
        jnp.bfloat16)
    _, (h_fin, _) = jax.jit(functools.partial(
        jssm.mamba_apply, d_state=N, d_conv=K, chunk=8,
        return_state=True))(params, x)
    tp = {k: _to_tensor(np.asarray(v)) for k, v in params.items()
          if k != "meta"}
    tx = _to_tensor(np.asarray(x))
    xs, _ = tssm._mamba_project(tp, tx)
    xs = tssm._conv1d_causal(tp, xs)
    dt, bc, cc = tssm._mamba_ssm_inputs(tp, xs, d_state=N, dt_rank=2)
    a = -torch.exp(tp["A_log"])
    _, h = tscan.mamba_scan(dt * xs.float(), dt, bc, cc, a)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_fin), **TOL)
    _, (h2, _) = tssm.mamba_apply(tp, tx, d_state=N, d_conv=K, chunk=8,
                                  return_state=True, impl="pallas")
    assert torch.equal(h, h2)


def test_wrapper_rejects_other_devices_and_shapes():
    _, (x, d, b, c, a) = _inputs(1, 1, 8, 16, 4, "f32")
    meta = [t.to("meta") for t in (x, d, b, c, a)]
    with pytest.raises(ValueError, match="no mamba_scan kernel"):
        tscan.mamba_scan(*meta)
    _, (x2, d2, b2, c2, a2) = _inputs(1, 1, 8, 16, 2, "f32")
    with pytest.raises(ValueError, match="state dim N=2"):
        tscan.mamba_scan(x2, d2, b2, c2, a2)
    with pytest.raises(ValueError, match="dt has shape"):
        tscan.mamba_scan(x, d[:, :4], b, c, a)
    with pytest.raises(ValueError, match="a has shape"):
        tscan.mamba_scan(x, d, b, c, a[:1])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tscan.mamba_scan(*(t.half() for t in (x, d, b, c, a)))
    with pytest.raises(TypeError, match="cc has dtype"):
        tscan.mamba_scan(x, d, b, c.bfloat16(), a)
    with pytest.raises(TypeError, match="a has dtype"):
        tscan.mamba_scan(x, d, b, c, a.half())
    strided = torch.zeros((1, 8, 8))[..., ::2]
    with pytest.raises(ValueError, match="contiguous last dim"):
        tscan.mamba_scan(x, d, strided, c, a)
    with pytest.raises(ValueError, match="empty scan"):
        tscan.mamba_scan(*(t[:, :0] for t in (x, d, b, c)), a)


def test_cpu_route_launches_no_kernel():
    tscan.reset_launches()
    _, ts = _inputs(2, 1, 8, 16, 4, "bf16")
    tscan.mamba_scan(*ts)
    tops.mamba_scan(*ts, return_state=True)
    assert tscan.LAUNCHES == {"mamba_scan": 0}
