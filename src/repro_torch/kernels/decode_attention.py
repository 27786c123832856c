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
device; anything else raises.  ``LAUNCHES`` counts wrapper calls that
launched the kernel.

The CUDA route is split-K flash-decoding: :func:`choose_splits` cuts the
cache's S rows into key ranges from (B, KV, S, the SM count), never from
``lengths`` (which lie on the card), one block per (range, KV group, b);
with more than one range a second kernel, launched from the same C
entry point, merges the ranges' (m, l, acc) in f32, so one wrapper call
is then two CUDA launches.  :func:`decode_attention_split_plain` is the
same algorithm in plain torch, for the tests.
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
from repro_torch.kernels.flash_attention import (
    DTYPES,
    _lib,
    check_data_aligned,
    check_head_dim,
    check_operand,
    check_rows_aligned,
    check_smem,
)
from repro_torch.kernels.ref import decode_attention_ref

# Kernel launches since the last reset.  Only the CUDA route adds to it,
# at the launch.
LAUNCHES = {"decode_attention": 0}

SPLIT_MIN_KEYS = 64      # keys a split reads at least
SPLIT_TILE = 32          # the kernel's key tile; a split is a whole number
_NEG = -1e30
_SM_COUNT: dict = {}     # device index -> streaming multiprocessors


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def choose_splits(B: int, KV: int, S: int, sm_count: int):
    """``(splits, chunk)``: the cache's ``S`` rows cut into ``splits``
    ranges of ``chunk`` keys (the last one may be shorter), enough for
    about one block per SM over the ``B * KV`` groups, no more than
    ``S // SPLIT_MIN_KEYS`` of them, each a whole number of
    ``SPLIT_TILE``-key tiles.  The ranges cover ``[0, S)`` and none is
    empty.  It reads only shapes: a sequence's length lies on the card
    and is never read on the host."""
    want = max(1, -(-sm_count // (B * KV)))
    want = min(want, max(1, S // SPLIT_MIN_KEYS))
    chunk = -(-S // want)
    chunk = -(-chunk // SPLIT_TILE) * SPLIT_TILE
    return -(-S // chunk), chunk


def decode_attention_plain(q, k_cache, v_cache, lengths):
    """The plain version: full score rows in f32 (the oracle), and 0 for
    a sequence of length 0, where the kernel reads no key."""
    o = decode_attention_ref(q, k_cache, v_cache, lengths)
    return torch.where(lengths.to(q.device)[:, None, None] > 0, o, 0.0)


def decode_attention_split_plain(q, k_cache, v_cache, lengths, splits,
                                 chunk=None):
    """Split-K decode attention in plain torch, for the tests, with the
    CUDA kernel's ranges: the cache's S rows cut into ``splits`` ranges of
    ``chunk`` keys, ``[i * chunk, min((i + 1) * chunk, S))``, the last one
    possibly shorter and none empty (``choose_splits`` gives the pair;
    ``chunk`` defaults to ``ceil(S / splits)``).  Per range, the
    online-softmax state (m, l, acc) of its keys before ``lengths[b]`` in
    f32, masked keys at -1e30 and a range with no such key at m = -1e30,
    l = 0; then the f32 merge
    ``sum acc_i e^(m_i - M) / max(sum l_i e^(m_i - M), 1e-30)``.  A
    sequence of length 0 comes out 0."""
    B, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, D)
    kf, vf = k_cache.float(), v_cache.float()
    pos = torch.arange(S, device=q.device)
    lens = lengths.to(q.device).long()
    if chunk is None:
        chunk = -(-S // splits)
    if not (splits - 1) * chunk < S <= splits * chunk:
        raise ValueError(f"{splits} ranges of {chunk} keys do not cut "
                         f"{S} keys into non-empty ranges")
    ms, ls, accs = [], [], []
    for i in range(splits):
        lo, hi = i * chunk, min((i + 1) * chunk, S)
        s = torch.einsum("bkgd,bksd->bkgs", qf, kf[:, :, lo:hi]) \
            / math.sqrt(D)
        valid = (pos[lo:hi][None, :] < lens[:, None])[:, None, None, :]
        s = torch.where(valid, s, _NEG)
        m = torch.maximum(torch.full((B, KV, G, 1), _NEG, device=q.device),
                          s.amax(-1, keepdim=True))
        p = torch.where(valid, torch.exp(s - m), 0.0)
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(torch.einsum("bkgs,bksd->bkgd", p, vf[:, :, lo:hi]))
    M = torch.stack(ms).amax(0)
    w = [torch.exp(m - M) for m in ms]
    L = sum(l * wi for l, wi in zip(ls, w))
    A = sum(a * wi for a, wi in zip(accs, w))
    return (A / torch.clamp(L, min=1e-30)).reshape(B, H, D).to(q.dtype)


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors, asked once per device."""
    n = _SM_COUNT.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SM_COUNT[device.index] = n
    return n


def _decode_plan(q, k_cache, v_cache, lengths):
    """Every check of a call, the splits, and its launch arguments."""
    B, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    code = DTYPES.get(q.dtype)
    if code is None:
        raise TypeError(f"decode_attention takes float32 or bfloat16, "
                        f"not {q.dtype}")
    check_operand("q", q, q)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        check_operand(name, t, q)
        if tuple(t.shape) != (B, KV, S, D):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(B, KV, S, D)}")
        check_rows_aligned(name, t)
    if lengths.device != q.device or lengths.dtype != torch.int32 \
            or tuple(lengths.shape) != (B,) or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous int32 [B] tensor on "
                         f"{q.device}")
    check_head_dim(D)
    if KV < 1 or H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    lib = _lib()
    check_smem("decode_attention", code, D, lib.decode_attention_smem_bytes)
    splits, chunk = choose_splits(B, KV, S, sm_count(q.device))
    o_stride = torch.empty_like(q).stride()     # what each call's o gets
    strides = (ctypes.c_longlong * 10)(
        *q.stride()[:2], *k_cache.stride()[:3], *v_cache.stride()[:3],
        *o_stride[:2])
    return (lib.decode_attention_launch, code, (B, H, KV, S, D, splits,
                                                 chunk), strides,
            1.0 / math.sqrt(D), B * H * splits * (D + 2) if splits > 1 else 0)


def decode_attention_cuda(q, k_cache, v_cache, lengths):
    """The same function through the CUDA kernel: one C call, which
    launches the split kernel and, with more than one split, the merge
    kernel.  The partials' workspace comes from ``torch.empty``."""
    refuse_autograd("decode_attention", q, k_cache, v_cache)
    key = ("decode",) + signature(q, k_cache, v_cache, lengths)
    plan = PLANS.get(key) or remember(
        key, _decode_plan(q, k_cache, v_cache, lengths))
    launch, code, dims, strides, scale, ws_floats = plan
    check_data_aligned(("k_cache", k_cache), ("v_cache", v_cache))
    o = torch.empty_like(q)
    ws = (torch.empty(ws_floats, dtype=torch.float32, device=q.device)
          if ws_floats else None)
    status = launch_on(q.device, launch, code, q.data_ptr(),
                       k_cache.data_ptr(), v_cache.data_ptr(),
                       lengths.data_ptr(), o.data_ptr(),
                       None if ws is None else ws.data_ptr(), *dims, strides,
                       scale)
    if status != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError "
                           f"{status}")
    LAUNCHES["decode_attention"] += 1
    return o


def decode_attention(q, k_cache, v_cache, lengths):
    """q: [B,H,D]; caches: [B,KV,S,D]; lengths: i32[B] -> [B,H,D]."""
    if q.device.type == "cpu":
        refuse_autograd("decode_attention", q, k_cache, v_cache)
        return decode_attention_plain(q, k_cache, v_cache, lengths)
    if q.device.type == "cuda":
        return decode_attention_cuda(q, k_cache, v_cache, lengths)
    raise ValueError(f"no decode_attention kernel for device {q.device}")
