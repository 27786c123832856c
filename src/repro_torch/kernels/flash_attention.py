"""Flash attention: a hand-written CUDA kernel for Hopper, the plain
PyTorch version beside it.

Counterpart of :func:`repro.kernels.flash_attention.flash_attention_pallas`
(blocked attention, causal or not, GQA ``h -> h // G``, online softmax
in f32, future key tiles skipped).  Layout contract, as there:
q ``[B, H, T, D]``; k/v ``[B, KV, S, D]`` -> ``[B, H, T, D]``.  The
inputs may be strided views (the last dim contiguous): the kernel reads
them through their strides, so the model-layout wrapper
(:func:`repro_torch.kernels.ops.flash_attention`) copies nothing.

:func:`flash_attention` takes the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`) for tensors on the
CPU and the CUDA kernel (``src/repro_torch/csrc/attention.cu``, built at
first use) for tensors on a CUDA device; anything else raises.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.ref import flash_attention_ref

# Kernel launches since the last reset.  Only the CUDA route adds to it,
# at the launch.
LAUNCHES = {"flash_attention": 0}

MAX_HEAD_DIM = 256
SMEM_LIMIT = 232_448        # dynamic shared memory a block may use (H100)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

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
        lib.flash_attention_launch.argtypes = (
            [c.c_int] + [c.c_void_p] * 4 + [c.c_int] * 6
            + [c.POINTER(c.c_longlong), c.c_int, c.c_float, c.c_void_p])
        lib.flash_attention_launch.restype = c.c_int
        lib.flash_attention_smem_bytes.argtypes = [c.c_int]
        lib.flash_attention_smem_bytes.restype = c.c_longlong
        _LIB = lib
    return _LIB


def check_head_dim(D: int) -> None:
    if D % 16 or not 16 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} must be a multiple of 16 in "
                         f"[16, {MAX_HEAD_DIM}]")


def check_operand(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    """Device, dtype and a contiguous last dim, as the kernels read."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype != like.dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {like.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have a contiguous last dim")


# The plain version: full score matrices in f32.
flash_attention_plain = flash_attention_ref


def flash_attention_cuda(q, k, v, *, causal: bool = True):
    """The same function as one launch of the CUDA kernel."""
    B, H, T, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, "
                        f"not {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        check_operand(name, t, q)
        if tuple(t.shape) != (B, KV, S, D):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(B, KV, S, D)}")
    check_operand("q", q, q)
    check_head_dim(D)
    if KV < 1 or H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    lib = _lib()
    smem = lib.flash_attention_smem_bytes(D)
    if smem > SMEM_LIMIT:
        raise ValueError(f"head_dim {D} needs {smem} bytes of shared memory")
    scale = 1.0 / math.sqrt(D)
    o = torch.empty_like(q)          # q's strides: [B,T,H,D] views stay so
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.flash_attention_launch(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), B, H, KV, T, S, D, strides, int(causal),
            float(scale), stream)
    if status != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError "
                           f"{status}")
    LAUNCHES["flash_attention"] += 1
    return o


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128):
    """q: [B,H,T,D]; k/v: [B,KV,S,D] -> [B,H,T,D].

    ``block_q`` is the Pallas kernel's query tile; it is kept so that
    both packages accept the same shapes (``T`` must be a multiple of
    ``min(block_q, T)``).  The CUDA kernel tiles on its own.
    """
    T = q.shape[2]
    block_q = min(block_q, T)
    if T % block_q:
        raise ValueError(f"T={T} must be a multiple of block_q={block_q}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal)
    raise ValueError(f"no flash_attention kernel for device {q.device}")
