"""Mamba selective scan: a hand-written CUDA kernel for Hopper, the plain
PyTorch version beside it.

Counterpart of :func:`repro.kernels.mamba_scan.mamba_scan_pallas`:

    h_t = exp(dt_t · A) ⊙ h_{t-1} + xdt_t · B_t,    y_t = C_t · h_t,
    h_0 = 0

Layout contract, as there: xdt/dt ``[B, T, I]``, bc/cc ``[B, T, N]``,
a ``[I, N]`` (negative) -> y ``[B, T, I]`` f32.  Unlike the Pallas
kernel, both routes also return the final state h_T ``[B, I, N]`` f32,
which the model's prefill keeps for decode.  The operands may be strided
(the last dim contiguous): bc and cc are column slices of the model's
``x_proj`` output, read in place.

:func:`mamba_scan` takes the plain version (:func:`mamba_scan_plain`,
the sequential recurrence in f32) for tensors on the CPU and the CUDA
kernel (``src/repro_torch/csrc/mamba_scan.cu``, built at first use) for
tensors on a CUDA device; anything else raises.  ``LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.ref import mamba_scan_ref

# Kernel launches since the last reset.  Only the CUDA route adds to it,
# at the launch.
LAUNCHES = {"mamba_scan": 0}

STATE_DIMS = (4, 8, 16)                  # N, a template argument
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels._build import load

        lib = load("mamba_scan")
        c = ctypes
        lib.mamba_scan_launch.argtypes = (
            [c.c_int, c.c_int] + [c.c_void_p] * 7 + [c.c_int] * 4
            + [c.POINTER(c.c_longlong), c.c_void_p])
        lib.mamba_scan_launch.restype = c.c_int
        _LIB = lib
    return _LIB


def check_operands(xdt, dt, bc, cc, a) -> None:
    """Shapes, dtypes, devices and contiguous last dims, as the kernel
    reads them; raises on anything else.  xdt, dt, bc and cc share one
    dtype; ``a`` is f32 or that dtype."""
    if xdt.dim() != 3:
        raise ValueError(f"xdt must be [B,T,I], got shape "
                         f"{tuple(xdt.shape)}")
    B, T, I = xdt.shape
    if bc.dim() != 3:
        raise ValueError(f"bc must be [B,T,N], got shape {tuple(bc.shape)}")
    N = bc.shape[-1]
    if N not in STATE_DIMS:
        raise ValueError(f"state dim N={N} not in {STATE_DIMS}")
    if min(B, T, I) < 1:
        raise ValueError(f"empty scan: shape {tuple(xdt.shape)}")
    if xdt.dtype not in DTYPES:
        raise TypeError(f"mamba_scan takes float32 or bfloat16, not "
                        f"{xdt.dtype}")
    for name, t, shape in (("xdt", xdt, (B, T, I)), ("dt", dt, (B, T, I)),
                           ("bc", bc, (B, T, N)), ("cc", cc, (B, T, N)),
                           ("a", a, (I, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.dtype != xdt.dtype and not (name == "a"
                                         and t.dtype == torch.float32):
            raise TypeError(f"{name} has dtype {t.dtype}, expected "
                            f"{xdt.dtype}")
        if t.device != xdt.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{xdt.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last dim")


# The plain version: the sequential recurrence in f32, with its state.
mamba_scan_plain = functools.partial(mamba_scan_ref, return_state=True)


def mamba_scan_cuda(xdt, dt, bc, cc, a):
    """The same function as one launch of the CUDA kernel."""
    check_operands(xdt, dt, bc, cc, a)
    B, T, I = xdt.shape
    N = bc.shape[-1]
    lib = _lib()
    y = torch.empty((B, T, I), dtype=torch.float32, device=xdt.device)
    h_out = torch.empty((B, I, N), dtype=torch.float32, device=xdt.device)
    strides = (ctypes.c_longlong * 11)(
        *xdt.stride()[:2], *dt.stride()[:2], *bc.stride()[:2],
        *cc.stride()[:2], *y.stride()[:2], a.stride(0))
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device).cuda_stream
        status = lib.mamba_scan_launch(
            DTYPES[xdt.dtype], DTYPES[a.dtype], xdt.data_ptr(),
            dt.data_ptr(), bc.data_ptr(), cc.data_ptr(), a.data_ptr(),
            y.data_ptr(), h_out.data_ptr(), B, T, I, N, strides, stream)
    if status != 0:
        raise RuntimeError(f"mamba_scan launch failed: cudaError {status}")
    LAUNCHES["mamba_scan"] += 1
    return y, h_out


def mamba_scan(xdt, dt, bc, cc, a):
    """xdt/dt: [B,T,I]; bc/cc: [B,T,N]; a: [I,N] -> (y [B,T,I] f32,
    h_T [B,I,N] f32)."""
    if xdt.device.type == "cpu":
        check_operands(xdt, dt, bc, cc, a)
        return mamba_scan_plain(xdt, dt, bc, cc, a)
    if xdt.device.type == "cuda":
        return mamba_scan_cuda(xdt, dt, bc, cc, a)
    raise ValueError(f"no mamba_scan kernel for device {xdt.device}")
