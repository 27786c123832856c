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

The CUDA kernel's decomposition (:func:`mamba_scan_plan`): a block owns
``BLOCK_CHANNELS`` channels of one b, and ``LANES`` lanes split a
channel's N states, ``N / LANES`` each; a decay is ``exp2`` of ``dt``
times A scaled by log2(e), and y sums the lanes' partials, kept in
shared memory, once a tile.  :func:`mamba_scan_split_plain` is that
algorithm in plain torch, for the tests; :func:`mamba_thread_cells`
names the states one thread of the launch owns.
"""

from __future__ import annotations

import ctypes
import functools
import math
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
from repro_torch.kernels.ref import mamba_scan_ref

# Kernel launches since the last reset.  Only the CUDA route adds to it,
# at the launch.
LAUNCHES = {"mamba_scan": 0}

STATE_DIMS = (4, 8, 16)                  # N, a template argument
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The kernel's constants (csrc/mamba_scan.cu: kChannels, kLanes,
# kThreads, kTile).
BLOCK_CHANNELS = 32     # channels a block
LANES = 4               # lanes a channel, N split over them
THREADS = BLOCK_CHANNELS * LANES
TILE = 32               # tokens a tile of the cp.async ring

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
            [c.c_int, c.c_int] + [c.c_void_p] * 7 + [c.c_int] * 7
            + [c.POINTER(c.c_longlong), c.c_void_p])
        lib.mamba_scan_launch.restype = c.c_int
        _LIB = lib
    return _LIB


class ScanPlan(NamedTuple):
    grid: int            # blocks: B * i_blocks
    threads: int         # a block
    i_blocks: int        # blocks over I: ceil(I / BLOCK_CHANNELS)
    states_per_lane: int  # N / LANES
    tile: int


def mamba_scan_plan(B: int, I: int, N: int) -> ScanPlan:
    """The launch plan, from shapes alone."""
    if N not in STATE_DIMS:
        raise ValueError(f"state dim N={N} not in {STATE_DIMS}")
    i_blocks = -(-I // BLOCK_CHANNELS)
    return ScanPlan(B * i_blocks, THREADS, i_blocks, N // LANES, TILE)


def mamba_thread_cells(plan: ScanPlan, I: int, block: int, thread: int):
    """``(b, [(i, states)])``: the states h[b, i, states] that ``thread``
    of ``block`` holds, as the kernel decodes its indices (warp w's lane
    l: channel 8 w + l % 8 of the block's 32, lane l // 8 of the
    channel's four); a channel past I, in the last block, is left out."""
    b, ib = divmod(block, plan.i_blocks)
    warp, lane = divmod(thread, 32)
    i = ib * BLOCK_CHANNELS + warp * 8 + lane % 8
    ns = plan.states_per_lane
    q = lane // 8
    return b, [(i, list(range(q * ns, (q + 1) * ns)))] if i < I else []


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


def mamba_scan_split_plain(xdt, dt, bc, cc, a):
    """The CUDA kernel's algorithm in plain torch (f32), for the tests:
    A scaled by log2(e) once, each decay ``exp2(dt * A')``, and N cut
    over ``LANES`` lane groups of ``N / LANES`` states; each group sums
    ``C[n] h[n]`` over its states in order, and y is ``(p0 + p1) +
    (p2 + p3)``, as the kernel sums them once a tile.  Same outputs as
    :func:`mamba_scan_plain`; nothing on the main path calls it."""
    check_operands(xdt, dt, bc, cc, a)
    B, T, I = xdt.shape
    N = bc.shape[-1]
    ns = mamba_scan_plan(B, I, N).states_per_lane
    xf, df, bf, cf = xdt.float(), dt.float(), bc.float(), cc.float()
    a2 = a.float() * math.log2(math.e)
    h = torch.zeros((B, I, N), dtype=torch.float32, device=xdt.device)
    ys = []
    for t in range(T):
        h = torch.exp2(df[:, t, :, None] * a2) * h + \
            xf[:, t, :, None] * bf[:, t, None, :]
        ch = cf[:, t, None, :] * h
        parts = []
        for q in range(LANES):
            p = ch[..., q * ns]
            for n in range(q * ns + 1, (q + 1) * ns):
                p = p + ch[..., n]
            parts.append(p)
        ys.append((parts[0] + parts[1]) + (parts[2] + parts[3]))
    return torch.stack(ys, dim=1), h


def mamba_scan_launch_args(xdt, dt, bc, cc, a):
    """Every check of a call and its launch arguments, from shapes and
    strides alone: ``(dtype codes, (B, T, I, N, i_blocks), (copy width of
    xdt/dt, of bc/cc), strides)``.  The copy widths are narrowed per call
    to the pointers' alignment."""
    check_operands(xdt, dt, bc, cc, a)
    B, T, I = xdt.shape
    N = bc.shape[-1]
    plan = mamba_scan_plan(B, I, N)
    size = xdt.element_size()
    streams = [t.stride()[:2] for t in (xdt, dt, bc, cc)]
    strides = (ctypes.c_longlong * 11)(
        *(s for st in streams for s in st), T * I, I, a.stride(0))
    widths = (copy_width(size, [*streams[0], *streams[1]],
                         (BLOCK_CHANNELS * size,)),
              copy_width(size, [*streams[2], *streams[3]], (N * size,)))
    return ((DTYPES[xdt.dtype], DTYPES[a.dtype]),
            (B, T, I, N, plan.i_blocks), widths, strides)


def mamba_scan_cuda(xdt, dt, bc, cc, a):
    """The same function as one launch of the CUDA kernel.  The full
    checks run on the first call of a signature; later calls allocate,
    take the pointers' alignment and launch on the raw stream."""
    refuse_autograd("mamba_scan", xdt, dt, bc, cc, a)
    key = ("mamba_scan",) + signature(xdt, dt, bc, cc, a)
    plan = PLANS.get(key) or remember(
        key, mamba_scan_launch_args(xdt, dt, bc, cc, a))
    codes, dims, (wx, wbc), strides = plan
    B, T, I, N = dims[:4]
    px, pd, pb, pc = (xdt.data_ptr(), dt.data_ptr(), bc.data_ptr(),
                      cc.data_ptr())
    y = torch.empty((B, T, I), dtype=torch.float32, device=xdt.device)
    h_out = torch.empty((B, I, N), dtype=torch.float32, device=xdt.device)
    status = launch_on(xdt.device, _lib().mamba_scan_launch, *codes, px, pd,
                       pb, pc, a.data_ptr(), y.data_ptr(), h_out.data_ptr(),
                       *dims, pointer_width(wx, px, pd),
                       pointer_width(wbc, pb, pc), strides)
    if status != 0:
        raise RuntimeError(f"mamba_scan launch failed: cudaError {status}")
    LAUNCHES["mamba_scan"] += 1
    return y, h_out


def mamba_scan(xdt, dt, bc, cc, a):
    """xdt/dt: [B,T,I]; bc/cc: [B,T,N]; a: [I,N] -> (y [B,T,I] f32,
    h_T [B,I,N] f32)."""
    if xdt.device.type == "cpu":
        refuse_autograd("mamba_scan", xdt, dt, bc, cc, a)
        check_operands(xdt, dt, bc, cc, a)
        return mamba_scan_plain(xdt, dt, bc, cc, a)
    if xdt.device.type == "cuda":
        return mamba_scan_cuda(xdt, dt, bc, cc, a)
    raise ValueError(f"no mamba_scan kernel for device {xdt.device}")
