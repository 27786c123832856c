"""RWKV6 WKV scan: a hand-written CUDA kernel for Hopper, the plain
PyTorch version beside it.

Counterpart of :func:`repro.kernels.rwkv6_scan.rwkv6_scan_pallas`:

    y_t = r_t · (S_{t-1} + u ⊙ k_t v_tᵀ)
    S_t = diag(exp(logw_t)) S_{t-1} + k_t v_tᵀ,    S_0 = 0

Layout contract, as there: r/k/v/logw ``[B, H, T, K]`` (V == K), u
``[H, K]`` -> y ``[B, H, T, K]`` f32.  Unlike the Pallas kernel, both
routes also return the final state S_T ``[B, H, K, K]`` f32, which the
model's prefill keeps for decode.  The inputs may be strided views of
the model's ``[B, T, H, K]`` streams (the last dim contiguous): the
kernel reads them through their strides and writes y in r's strides, so
the model-layout transposes copy nothing.

:func:`rwkv6_scan` takes the plain version (:func:`rwkv6_scan_plain`,
the sequential recurrence in f32) for tensors on the CPU and the CUDA
kernel (``src/repro_torch/csrc/rwkv6_scan.cu``, built at first use) for
tensors on a CUDA device; anything else raises.  ``LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.ref import rwkv6_scan_ref

# Kernel launches since the last reset.  Only the CUDA route adds to it,
# at the launch.
LAUNCHES = {"rwkv6_scan": 0}

HEAD_DIMS = (16, 32, 64)                # K, a template argument
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels._build import load

        lib = load("rwkv6_scan")
        c = ctypes
        lib.rwkv6_scan_launch.argtypes = (
            [c.c_int] + [c.c_void_p] * 7 + [c.c_int] * 4
            + [c.POINTER(c.c_longlong), c.c_void_p])
        lib.rwkv6_scan_launch.restype = c.c_int
        _LIB = lib
    return _LIB


def check_operands(r, k, v, logw, u) -> None:
    """Shapes, dtypes, devices and contiguous last dims, as the kernel
    reads them; raises on anything else."""
    if r.dim() != 4:
        raise ValueError(f"r must be [B,H,T,K], got shape {tuple(r.shape)}")
    B, H, T, K = r.shape
    if K not in HEAD_DIMS:
        raise ValueError(f"head dim K={K} not in {HEAD_DIMS}")
    if min(B, H, T) < 1:
        raise ValueError(f"empty scan: shape {tuple(r.shape)}")
    if r.dtype not in DTYPES:
        raise TypeError(f"rwkv6_scan takes float32 or bfloat16, not "
                        f"{r.dtype}")
    for name, t, shape in (("r", r, (B, H, T, K)), ("k", k, (B, H, T, K)),
                           ("v", v, (B, H, T, K)),
                           ("logw", logw, (B, H, T, K)), ("u", u, (H, K))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.dtype != r.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected "
                            f"{r.dtype}")
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, expected {r.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last dim")


# The plain version: the sequential recurrence in f32, with its state.
rwkv6_scan_plain = functools.partial(rwkv6_scan_ref, return_state=True)


def rwkv6_scan_cuda(r, k, v, logw, u):
    """The same function as one launch of the CUDA kernel."""
    check_operands(r, k, v, logw, u)
    B, H, T, K = r.shape
    lib = _lib()
    # y in r's strides: a [B,T,H,K] view stays one, so y.transpose(1, 2)
    # is contiguous for the model.
    y = torch.empty_like(r, dtype=torch.float32)
    s_out = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    strides = (ctypes.c_longlong * 16)(
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *logw.stride()[:3], *y.stride()[:3], u.stride(0))
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        status = lib.rwkv6_scan_launch(
            DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
            logw.data_ptr(), u.data_ptr(), y.data_ptr(), s_out.data_ptr(),
            B, H, T, K, strides, stream)
    if status != 0:
        raise RuntimeError(f"rwkv6_scan launch failed: cudaError {status}")
    LAUNCHES["rwkv6_scan"] += 1
    return y, s_out


def rwkv6_scan(r, k, v, logw, u):
    """r/k/v/logw: [B,H,T,K]; u: [H,K] -> (y [B,H,T,K] f32,
    S_T [B,H,K,K] f32)."""
    if r.device.type == "cpu":
        check_operands(r, k, v, logw, u)
        return rwkv6_scan_plain(r, k, v, logw, u)
    if r.device.type == "cuda":
        return rwkv6_scan_cuda(r, k, v, logw, u)
    raise ValueError(f"no rwkv6_scan kernel for device {r.device}")
