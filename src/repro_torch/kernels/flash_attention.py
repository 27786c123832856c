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
``LAUNCHES`` counts wrapper calls that launched the kernel.

Routes on the card (:func:`flash_route`): bf16 inputs (what serving
passes) go to the tensor-core kernel (``wgmma`` for both products,
16-byte-aligned rows; the softmax weights enter the P V product as three
bf16 terms, so the sums keep f32 precision as the Pallas kernel's do);
f32 inputs go to the exact-f32 kernel on the CUDA cores.  Both take
every head dim of :func:`check_head_dim`.  A call launches one kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._build import (
    PLANS,
    launch_on,
    refuse_autograd,
    remember,
    signature,
)
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
        lib.decode_attention_launch.argtypes = (
            [c.c_int] + [c.c_void_p] * 6 + [c.c_int] * 7
            + [c.POINTER(c.c_longlong), c.c_float, c.c_void_p])
        lib.decode_attention_launch.restype = c.c_int
        for fn in (lib.flash_attention_smem_bytes,
                   lib.decode_attention_smem_bytes):
            fn.argtypes = [c.c_int, c.c_int]
            fn.restype = c.c_longlong
        status = lib.attention_init()
        if status != 0:
            raise RuntimeError(f"attention kernels: setting their shared-"
                               f"memory limits failed: cudaError {status}")
        _LIB = lib
    return _LIB


def check_head_dim(D: int) -> None:
    if D % 16 or not 16 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} must be a multiple of 16 in "
                         f"[16, {MAX_HEAD_DIM}]")


def flash_route(dtype: torch.dtype, D: int) -> str:
    """Which kernel a call of this dtype and head dim launches:
    ``"wgmma"`` (bf16, on the tensor cores) or ``"cuda_core"`` (f32)."""
    check_head_dim(D)
    return "wgmma" if dtype == torch.bfloat16 else "cuda_core"


def check_operand(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    """Device, dtype and a contiguous last dim, as the kernels read."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype != like.dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {like.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have a contiguous last dim")


def check_rows_aligned(name: str, t: torch.Tensor) -> None:
    """Every row starts on 16 bytes, as the kernels' 16-byte copies read."""
    step = 16 // t.element_size()
    if t.data_ptr() % 16 or any(s % step for s in t.stride()[:-1]):
        raise ValueError(f"{name}'s rows must start on 16-byte boundaries "
                         f"(data_ptr {t.data_ptr()}, strides {t.stride()})")


def check_smem(kind: str, code: int, D: int, smem_bytes) -> None:
    """Raises if a launch of this (dtype, head_dim) needs more shared
    memory than a block may use."""
    smem = smem_bytes(code, D)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{kind}: head_dim {D} needs {smem} bytes of "
                         "shared memory")


def check_data_aligned(*named) -> None:
    """Each operand's first element on 16 bytes (checked every call: the
    pointers change from call to call)."""
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}'s data must start on 16 bytes "
                             f"(data_ptr {t.data_ptr()})")


# The plain version: full score matrices in f32.
flash_attention_plain = flash_attention_ref


def _flash_plan(q, k, v):
    """Every check of a call, and its launch arguments."""
    B, H, T, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    code = DTYPES.get(q.dtype)
    if code is None:
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
    if code == 1:
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_rows_aligned(name, t)
    lib = _lib()
    check_smem("flash_attention", code, D, lib.flash_attention_smem_bytes)
    o_stride = torch.empty_like(q).stride()     # what each call's o gets
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o_stride[:3])
    return (lib.flash_attention_launch, code, (B, H, KV, T, S, D), strides,
            1.0 / math.sqrt(D))


def flash_attention_cuda(q, k, v, *, causal: bool = True):
    """The same function as one launch of the CUDA kernel."""
    refuse_autograd("flash_attention", q, k, v)
    key = ("flash",) + signature(q, k, v)
    plan = PLANS.get(key) or remember(key, _flash_plan(q, k, v))
    launch, code, dims, strides, scale = plan
    if code == 1:
        check_data_aligned(("q", q), ("k", k), ("v", v))
    o = torch.empty_like(q)          # q's strides: [B,T,H,D] views stay so
    status = launch_on(q.device, launch, code, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), o.data_ptr(), *dims, strides,
                       int(causal), scale)
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
        refuse_autograd("flash_attention", q, k, v)
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal)
    raise ValueError(f"no flash_attention kernel for device {q.device}")
