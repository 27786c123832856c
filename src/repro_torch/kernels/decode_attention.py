"""Decode attention: a hand-written CUDA kernel for Hopper, the plain
PyTorch version beside it.

Counterpart of :func:`repro.kernels.decode_attention.decode_attention_pallas`:
one query token per sequence against its KV cache, the G = H / KV query
heads of a group sharing each cache read, online softmax in f32, keys
at or past ``lengths[b]`` never read.  Layout contract, as there:
q ``[B, H, D]``; caches ``[B, KV, S, D]``; lengths ``i32[B]`` ->
``[B, H, D]``.  The caches may be strided views of the model's
``[B, S, KV, D]`` cache (the last dim contiguous).

A sequence with ``lengths[b] == 0`` comes out 0, as the Pallas kernel
gives it (every block skipped), on both routes; the oracle
(:func:`repro_torch.kernels.ref.decode_attention_ref`) gives a uniform
softmax over all ``S`` keys there.  Serving never passes 0.

:func:`decode_attention` takes the plain version
(:func:`decode_attention_plain`) for tensors on the CPU and the CUDA
kernel (``src/repro_torch/csrc/attention.cu``) for tensors on a CUDA
device; anything else raises.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.flash_attention import (
    DTYPES,
    SMEM_LIMIT,
    check_head_dim,
    check_operand,
)
from repro_torch.kernels.ref import decode_attention_ref

# Kernel launches since the last reset.  Only the CUDA route adds to it,
# at the launch.
LAUNCHES = {"decode_attention": 0}

_LIB = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels._build import load

        lib = load("attention")
        c = ctypes
        lib.decode_attention_launch.argtypes = (
            [c.c_int] + [c.c_void_p] * 5 + [c.c_int] * 5
            + [c.POINTER(c.c_longlong), c.c_float, c.c_void_p])
        lib.decode_attention_launch.restype = c.c_int
        lib.decode_attention_smem_bytes.argtypes = [c.c_int, c.c_int]
        lib.decode_attention_smem_bytes.restype = c.c_longlong
        _LIB = lib
    return _LIB


def decode_attention_plain(q, k_cache, v_cache, lengths):
    """The plain version: full score rows in f32 (the oracle), and 0 for
    a sequence of length 0, where the kernel reads no key."""
    o = decode_attention_ref(q, k_cache, v_cache, lengths)
    return torch.where(lengths.to(q.device)[:, None, None] > 0, o, 0.0)


def decode_attention_cuda(q, k_cache, v_cache, lengths):
    """The same function as one launch of the CUDA kernel."""
    B, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"decode_attention takes float32 or bfloat16, "
                        f"not {q.dtype}")
    check_operand("q", q, q)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        check_operand(name, t, q)
        if tuple(t.shape) != (B, KV, S, D):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(B, KV, S, D)}")
    if lengths.device != q.device or lengths.dtype != torch.int32 \
            or tuple(lengths.shape) != (B,) or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous int32 [B] tensor on "
                         f"{q.device}")
    check_head_dim(D)
    if KV < 1 or H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    lib = _lib()
    smem = lib.decode_attention_smem_bytes(H // KV, D)
    if smem > SMEM_LIMIT:
        raise ValueError(f"G={H // KV}, head_dim {D} need {smem} bytes of "
                         "shared memory")
    scale = 1.0 / math.sqrt(D)
    o = torch.empty_like(q)
    strides = (ctypes.c_longlong * 10)(
        *q.stride()[:2], *k_cache.stride()[:3], *v_cache.stride()[:3],
        *o.stride()[:2])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.decode_attention_launch(
            DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), lengths.data_ptr(), o.data_ptr(), B, H, KV,
            S, D, strides, float(scale), stream)
    if status != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError "
                           f"{status}")
    LAUNCHES["decode_attention"] += 1
    return o


def decode_attention(q, k_cache, v_cache, lengths):
    """q: [B,H,D]; caches: [B,KV,S,D]; lengths: i32[B] -> [B,H,D]."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths)
    if q.device.type == "cuda":
        return decode_attention_cuda(q, k_cache, v_cache, lengths)
    raise ValueError(f"no decode_attention kernel for device {q.device}")
