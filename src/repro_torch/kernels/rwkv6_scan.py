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

The CUDA kernel's decomposition (:func:`rwkv6_scan_plan`): a block owns
``BLOCK_COLS`` columns of S of one (b, h), so a head is ``K / 16``
blocks; ``ROW_LANES`` lanes split a column's K rows
(:func:`rwkv6_lane_rows`), each partial ``r · S[rows, v]`` goes to
shared memory, and the partials of a tile of ``TILE`` tokens are summed
once, with the bonus term.  :func:`rwkv6_scan_split_plain` is that
algorithm in plain torch, for the tests; :func:`rwkv6_thread_cells`
names the state cells one thread of the launch owns.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels._build import (
    PLANS,
    copy_width,
    launch_on,
    pointer_width,
    refuse_autograd,
    remember,
    signature,
)
from repro_torch.kernels.ref import rwkv6_scan_ref

# Kernel launches since the last reset.  Only the CUDA route adds to it,
# at the launch.
LAUNCHES = {"rwkv6_scan": 0}

HEAD_DIMS = (16, 32, 64)                # K, a template argument
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The kernel's constants (csrc/rwkv6_scan.cu: kTile, kCols, kRowLanes,
# kWalkers, kThreads).
TILE = 16               # tokens a tile of the cp.async ring
BLOCK_COLS = 16         # columns of S a block
ROW_LANES = 8           # lanes over the K rows of a column
WALKERS = BLOCK_COLS * ROW_LANES     # threads 0-127 hold the state
THREADS = WALKERS + 128              # 128-255 load, prepare and sum

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
            [c.c_int] + [c.c_void_p] * 7 + [c.c_int] * 6
            + [c.POINTER(c.c_longlong), c.c_void_p])
        lib.rwkv6_scan_launch.restype = c.c_int
        _LIB = lib
    return _LIB


class ScanPlan(NamedTuple):
    grid: int           # blocks: B * H * col_groups
    threads: int        # a block
    col_groups: int     # blocks a head: K / BLOCK_COLS
    rows_per_lane: int  # K / ROW_LANES
    tile: int


def rwkv6_scan_plan(B: int, H: int, K: int) -> ScanPlan:
    """The launch plan, from shapes alone."""
    if K not in HEAD_DIMS:
        raise ValueError(f"head dim K={K} not in {HEAD_DIMS}")
    groups = K // BLOCK_COLS
    return ScanPlan(B * H * groups, THREADS, groups, K // ROW_LANES, TILE)


def rwkv6_lane_rows(K: int, g: int) -> list:
    """The rows of S that row lane ``g`` holds: runs of ``Q`` = min(K/8,
    4) rows, one shared-memory vector each, ``8 Q`` rows apart (K 64:
    4g..4g+3 and 32+4g..32+4g+3)."""
    rk = K // ROW_LANES
    q = min(rk, 4)
    return [e // q * (ROW_LANES * q) + g * q + e % q for e in range(rk)]


def rwkv6_thread_cells(plan: ScanPlan, H: int, K: int, block: int,
                       thread: int):
    """``(b, h, column, rows)``: the state cells S[b, h, rows, column]
    that ``thread`` of ``block`` holds, as the kernel decodes its
    indices (walker t < 128: row lane t // 16, column t % 16 of the
    block's 16, so a half-warp holds one row lane's 16 columns; the
    helper threads hold no state: column None, no rows)."""
    cg, bh = block % plan.col_groups, block // plan.col_groups
    if thread >= WALKERS:
        return bh // H, bh % H, None, []
    g, col = divmod(thread, BLOCK_COLS)
    return bh // H, bh % H, cg * BLOCK_COLS + col, rwkv6_lane_rows(K, g)


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


def rwkv6_scan_split_plain(r, k, v, logw, u):
    """The CUDA kernel's algorithm in plain torch (f32), for the tests:
    each block's ``BLOCK_COLS`` columns walk alone with their own state
    columns; per token each row lane's partial ``sum_{k in rows} r[k]
    S[k, v]`` is kept, and at the end of each ``TILE``-token tile the
    8 partials are summed as a pairwise tree and ``bonus_t v_t`` is added,
    where ``bonus_t = sum_k r u k`` is computed once per token.  Same
    outputs as :func:`rwkv6_scan_plain`; nothing on the main path calls
    it."""
    check_operands(r, k, v, logw, u)
    B, H, T, K = r.shape
    plan = rwkv6_scan_plan(B, H, K)
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(logw.float())
    bonus = torch.einsum("bhtk,hk,bhtk->bht", rf, u.float(), kf)
    lanes = [rwkv6_lane_rows(K, g) for g in range(ROW_LANES)]
    y = torch.empty((B, H, T, K), dtype=torch.float32, device=r.device)
    s_out = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    for cg in range(plan.col_groups):
        cols = slice(cg * BLOCK_COLS, (cg + 1) * BLOCK_COLS)
        S = torch.zeros((B, H, K, BLOCK_COLS), dtype=torch.float32,
                        device=r.device)
        for t0 in range(0, T, plan.tile):
            parts = []                      # [token][row lane] -> [B,H,16]
            for t in range(t0, min(t0 + plan.tile, T)):
                parts.append([torch.einsum("bhk,bhkv->bhv", rf[:, :, t, rows],
                                           S[:, :, rows]) for rows in lanes])
                S = w[:, :, t, :, None] * S + \
                    kf[:, :, t, :, None] * vf[:, :, t, None, cols]
            for j, p in enumerate(parts):
                total = ((p[0] + p[1]) + (p[2] + p[3])) + \
                    ((p[4] + p[5]) + (p[6] + p[7]))
                t = t0 + j
                y[:, :, t, cols] = total + bonus[:, :, t, None] * \
                    vf[:, :, t, cols]
        s_out[..., cols] = S
    return y, s_out


def rwkv6_scan_launch_args(r, k, v, logw, u):
    """Every check of a call and its launch arguments, from shapes and
    strides alone: ``(dtype code, (B, H, T, K, col_groups), strides,
    copy width)``.  The copy width is narrowed per call to the pointers'
    alignment (:func:`~repro_torch.kernels._build.pointer_width`)."""
    check_operands(r, k, v, logw, u)
    B, H, T, K = r.shape
    plan = rwkv6_scan_plan(B, H, K)
    y_stride = torch.empty_like(r, dtype=torch.float32).stride()
    streams = [t.stride()[:3] for t in (r, k, v, logw)]
    strides = (ctypes.c_longlong * 16)(
        *(s for st in streams for s in st), *y_stride[:3], u.stride(0))
    size = r.element_size()
    width = copy_width(size, [s for st in streams for s in st],
                       (K * size, BLOCK_COLS * size))
    return DTYPES[r.dtype], (B, H, T, K, plan.col_groups), strides, width


def rwkv6_scan_cuda(r, k, v, logw, u):
    """The same function as one launch of the CUDA kernel.  The full
    checks run on the first call of a signature; later calls allocate,
    take the pointers' alignment and launch on the raw stream."""
    refuse_autograd("rwkv6_scan", r, k, v, logw, u)
    key = ("rwkv6_scan",) + signature(r, k, v, logw, u)
    plan = PLANS.get(key) or remember(
        key, rwkv6_scan_launch_args(r, k, v, logw, u))
    code, dims, strides, width = plan
    B, H, T, K = dims[:4]
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr())
    # y in r's strides: a [B,T,H,K] view stays one, so y.transpose(1, 2)
    # is contiguous for the model.
    y = torch.empty_like(r, dtype=torch.float32)
    s_out = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    status = launch_on(r.device, _lib().rwkv6_scan_launch, code, *ptrs,
                       u.data_ptr(), y.data_ptr(), s_out.data_ptr(), *dims,
                       pointer_width(width, *ptrs), strides)
    if status != 0:
        raise RuntimeError(f"rwkv6_scan launch failed: cudaError {status}")
    LAUNCHES["rwkv6_scan"] += 1
    return y, s_out


def rwkv6_scan(r, k, v, logw, u):
    """r/k/v/logw: [B,H,T,K]; u: [H,K] -> (y [B,H,T,K] f32,
    S_T [B,H,K,K] f32)."""
    if r.device.type == "cpu":
        refuse_autograd("rwkv6_scan", r, k, v, logw, u)
        check_operands(r, k, v, logw, u)
        return rwkv6_scan_plain(r, k, v, logw, u)
    if r.device.type == "cuda":
        return rwkv6_scan_cuda(r, k, v, logw, u)
    raise ValueError(f"no rwkv6_scan kernel for device {r.device}")
