"""Front-tier queue kernels: hand-written CUDA for Hopper, plain PyTorch
beside them.

Counterparts of the two Pallas kernels in
:mod:`repro.kernels.queue_front`, the only kernels on the engine's main
path (one launch each per super-step):

* :func:`window_extract` — the §III-B dynamic-lookahead take rule over
  the refilled sorted front, plus the prefix pop of all four front
  columns.  Plain version: :func:`repro_torch.core.queue.window_prefix_mask`
  followed by the pop of :func:`repro_torch.core.queue.tiered3_queue_pop_prefix`.
  ``bound=(bound_t, bound_seq)``, two 0-d device scalars, is the spill
  policy's and the streamed arrivals' lex fence: only candidates
  strictly lex-before it are valid (JAX's bounded XLA extract).  The
  CUDA route always reads a fence; ``bound=None`` passes ``(inf,
  2**31-1)``, so a closed run makes the same launch and no host read.
* :func:`front_merge` — the counting-merge of the per-batch emit rows
  into the sorted front (``front_cap + R`` wide output; the tail is the
  evicted rows).  Plain version: the merge block of the JAX
  ``_tiered_fill_finish`` XLA path; ``lex=True`` is its ``b_seq`` branch,
  which places each row after the occupied front slots strictly
  lex-before its ``(time, seq)`` key (rows reabsorbed with old seqs).

Each wrapper takes the plain version for tensors on the CPU and the
CUDA kernel (``src/repro_torch/csrc/queue_front.cu``, built at first
use) for tensors on a CUDA device; anything else raises.  Both kernels
are bit-identical to their plain versions.  ``LAUNCHES`` counts kernel
launches per kernel name.

The CUDA wrappers run their full checks once per call signature (each
operand's shape, strides, dtype and device, and the host arguments):
:func:`window_extract_plan` and :func:`front_merge_plan` remember the
launch arguments in the plan cache that every kernel's wrapper shares
(:mod:`repro_torch.kernels._build`).  A later call with the same
signature only allocates its outputs and launches, with the tensors'
pointers passed in one ctypes array; the kernels take any data pointer
(they pick 16-byte copies themselves where the pointers allow), so none
is re-checked.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.queue import (
    I32_MAX,
    INF,
    _arange,
    _f32,
    _small_lex_perm,
    _take,
    shift_left,
    window_prefix_mask,
)
from repro_torch.kernels._build import PLANS, launch_on, remember, signature

# Kernel launches since the last reset, by kernel name.  Only the CUDA
# route adds to them, at the launch.
LAUNCHES = {"window_extract": 0, "front_merge": 0}

MAX_WINDOW = 32      # the kernel runs the take rule in one warp

_ptr = ctypes.c_void_p
_int = ctypes.c_int
_LIB = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels._build import load

        lib = load("queue_front")
        lib.window_extract_launch.argtypes = (
            [_ptr, _int, ctypes.c_float, _int, _int, _int, _ptr])
        lib.window_extract_launch.restype = _int
        lib.front_merge_launch.argtypes = [_ptr, _int, _int, _int, _int,
                                           _ptr]
        lib.front_merge_launch.restype = _int
        _LIB = lib
    return _LIB


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _route(device: torch.device) -> str:
    if device.type == "cpu":
        return "plain"
    if device.type == "cuda":
        return "cuda"
    raise ValueError(f"no queue_front kernel for device {device}")


def _launch_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {status}")


# device -> the open fence (inf, 2**31-1) as two 0-d tensors, made once.
_OPEN_FENCE: dict = {}


def _open_fence(device: torch.device):
    fence = _OPEN_FENCE.get(device)
    if fence is None:
        fence = (torch.full((), INF, dtype=torch.float32, device=device),
                 torch.full((), I32_MAX, dtype=torch.int32, device=device))
        _OPEN_FENCE[device] = fence
    return fence


# ---------------------------------------------------------------------------
# window_extract
# ---------------------------------------------------------------------------

def window_extract_plain(f_times, f_types, f_args, f_seqs, lookaheads,
                         t_cap=None, *, k: int, bound=None):
    """The XLA extract path: take rule over the first ``k`` front
    slots (cut to those strictly lex-before ``bound`` when given), then
    the prefix pop.  Returns ``(ts[k], tys[k], args[k, W], length,
    f_times', f_types', f_args', f_seqs')``."""
    T = lookaheads.shape[0]
    ts_c, tys_c, args_c = f_times[:k], f_types[:k], f_args[:k]
    valid = tys_c >= 0
    if bound is not None:
        b_t, b_s = bound
        valid = valid & ((ts_c < b_t) | ((ts_c == b_t) & (f_seqs[:k] < b_s)))
    la = _take(lookaheads, torch.clamp(tys_c, 0, T - 1))
    wins = torch.where(valid, ts_c + la, INF)
    take = window_prefix_mask(ts_c, wins, valid, t_cap)
    length = torch.sum(take).to(torch.int32)
    ts = torch.where(take, ts_c, 0.0)
    tys = torch.where(take, tys_c, 0)
    args = torch.where(take[:, None], args_c, 0.0)
    return (ts, tys, args, length,
            shift_left(f_times, INF, length, k),
            shift_left(f_types, -1, length, k),
            shift_left(f_args, 0.0, length, k),
            shift_left(f_seqs, I32_MAX, length, k))


def _window_plan(f_times, f_types, f_args, f_seqs, lookaheads, bound_t,
                 bound_seq, t_cap, k):
    """Every check of a ``window_extract`` call, and its launch
    arguments."""
    dev = f_times.device
    F = f_times.shape[0]
    W = f_args.shape[1] if f_args.dim() == 2 else -1
    T = lookaheads.shape[0]
    _check("f_times", f_times, torch.float32, (F,), dev)
    _check("f_types", f_types, torch.int32, (F,), dev)
    _check("f_args", f_args, torch.float32, (F, W), dev)
    _check("f_seqs", f_seqs, torch.int32, (F,), dev)
    _check("lookaheads", lookaheads, torch.float32, (T,), dev)
    _check("bound_t", bound_t, torch.float32, (), dev)
    _check("bound_seq", bound_seq, torch.int32, (), dev)
    if not 1 <= k <= min(F, MAX_WINDOW):
        raise ValueError(f"window width {k} must be in [1, "
                         f"min(front_cap={F}, {MAX_WINDOW})]")
    if T < 1:
        raise ValueError("lookaheads must name at least one type")
    if W < 1:
        raise ValueError("f_args must have at least one column")
    if t_cap is not None and not isinstance(t_cap, (int, float)):
        raise TypeError("t_cap must be a host number or None")
    cap = INF if t_cap is None else _f32(t_cap)
    return dev, (T, cap, F, W, k)


def window_extract_plan(f_times, f_types, f_args, f_seqs, lookaheads,
                        t_cap=None, *, k: int, bound=None):
    """The launch plan of this call signature, built by
    :func:`_window_plan` the first time it is seen."""
    bound_t, bound_seq = (_open_fence(f_times.device) if bound is None
                          else bound)
    key = ("window_extract", k, t_cap) + signature(
        f_times, f_types, f_args, f_seqs, lookaheads, bound_t, bound_seq)
    return PLANS.get(key) or remember(key, _window_plan(
        f_times, f_types, f_args, f_seqs, lookaheads, bound_t, bound_seq,
        t_cap, k))


def window_extract_cuda(f_times, f_types, f_args, f_seqs, lookaheads,
                        t_cap=None, *, k: int, bound=None):
    """The same function as one launch of the CUDA kernel; ``bound=None``
    launches it with the open fence."""
    dev, dims = window_extract_plan(f_times, f_types, f_args, f_seqs,
                                    lookaheads, t_cap, k=k, bound=bound)
    bound_t, bound_seq = _open_fence(dev) if bound is None else bound
    F, W = dims[2], dims[3]
    f32, i32 = torch.float32, torch.int32
    ts = torch.empty(k, dtype=f32, device=dev)
    tys = torch.empty(k, dtype=i32, device=dev)
    args = torch.empty(k, W, dtype=f32, device=dev)
    length = torch.empty((), dtype=i32, device=dev)
    nt = torch.empty(F, dtype=f32, device=dev)
    ny = torch.empty(F, dtype=i32, device=dev)
    na = torch.empty(F, W, dtype=f32, device=dev)
    ns = torch.empty(F, dtype=i32, device=dev)
    ptrs = (ctypes.c_void_p * 15)(
        f_times.data_ptr(), f_types.data_ptr(), f_args.data_ptr(),
        f_seqs.data_ptr(), lookaheads.data_ptr(), bound_t.data_ptr(),
        bound_seq.data_ptr(), ts.data_ptr(),
        tys.data_ptr(), args.data_ptr(), length.data_ptr(), nt.data_ptr(),
        ny.data_ptr(), na.data_ptr(), ns.data_ptr())
    status = launch_on(dev, _lib().window_extract_launch, ptrs, *dims)
    _launch_status("window_extract", status)
    LAUNCHES["window_extract"] += 1
    return ts, tys, args, length, nt, ny, na, ns


def window_extract(f_times, f_types, f_args, f_seqs, lookaheads,
                   t_cap=None, *, k: int, bound=None):
    """Fused take rule + prefix pop over a refilled sorted front tier
    (``t_cap`` caps the window at the run horizon, ``bound`` fences the
    candidates at a lex ``(time, seq)`` key)."""
    if _route(f_times.device) == "plain":
        return window_extract_plain(f_times, f_types, f_args, f_seqs,
                                    lookaheads, t_cap, k=k, bound=bound)
    return window_extract_cuda(f_times, f_types, f_args, f_seqs,
                               lookaheads, t_cap, k=k, bound=bound)


# ---------------------------------------------------------------------------
# front_merge
# ---------------------------------------------------------------------------

def front_merge_plain(f_times, f_types, f_args, f_seqs, front_n,
                      t_r, ty_r, arg_r, seq_r, to_front, *, lex=False):
    """The XLA front-merge block: lex-rank the rows (non-front rows
    last), searchsorted-right into the front capped at ``front_n`` (with
    ``lex``: count the occupied front slots strictly lex-before each
    row), and rebuild the ``F + R`` merged columns by position
    arithmetic."""
    F = f_times.shape[0]
    R = t_r.shape[0]
    FE = F + R
    dev = f_times.device
    tt = torch.where(to_front, t_r, INF)
    perm = _small_lex_perm(tt, torch.where(to_front, seq_r, I32_MAX))
    rt = tt[perm]
    rty, rarg, rseq, rins = ty_r[perm], arg_r[perm], seq_r[perm], to_front[perm]
    if lex:
        occ_f = (_arange(F, dev) < front_n)[None, :]
        lex_lt = (f_times[None, :] < rt[:, None]) | (
            (f_times[None, :] == rt[:, None])
            & (f_seqs[None, :] < rseq[:, None]))
        older = torch.sum(occ_f & lex_lt, dim=1).to(torch.int32)
    else:
        older = torch.minimum(
            torch.searchsorted(f_times, rt, right=True, out_int32=True),
            front_n)
    pos = torch.where(rins, older + _arange(R, dev), FE + R)
    i_idx = _arange(FE, dev)
    ins_before = torch.searchsorted(pos, i_idx, right=False, out_int32=True)
    is_ins = torch.searchsorted(pos, i_idx, right=True,
                                out_int32=True) > ins_before
    src = torch.where(is_ins, FE + torch.clamp(ins_before, 0, R - 1),
                      torch.clamp(i_idx - ins_before, 0, FE - 1))

    def fmerge(col, rcol, fill):
        pad = torch.full((R,) + tuple(col.shape[1:]), fill, dtype=col.dtype,
                         device=dev)
        return _take(torch.cat([col, pad, rcol]), src)

    return (fmerge(f_times, rt, INF), fmerge(f_types, rty, -1),
            fmerge(f_args, rarg, 0.0), fmerge(f_seqs, rseq, I32_MAX))


def _merge_plan(f_times, f_types, f_args, f_seqs, front_n, t_r, ty_r,
                arg_r, seq_r, to_front):
    """Every check of a ``front_merge`` call, and its launch
    arguments."""
    dev = f_times.device
    F, R = f_times.shape[0], t_r.shape[0]
    W = f_args.shape[1] if f_args.dim() == 2 else -1
    _check("f_times", f_times, torch.float32, (F,), dev)
    _check("f_types", f_types, torch.int32, (F,), dev)
    _check("f_args", f_args, torch.float32, (F, W), dev)
    _check("f_seqs", f_seqs, torch.int32, (F,), dev)
    _check("front_n", front_n, torch.int32, (), dev)
    _check("t_r", t_r, torch.float32, (R,), dev)
    _check("ty_r", ty_r, torch.int32, (R,), dev)
    _check("arg_r", arg_r, torch.float32, (R, W), dev)
    _check("seq_r", seq_r, torch.int32, (R,), dev)
    _check("to_front", to_front, torch.bool, (R,), dev)
    if not 1 <= R <= 1024:
        raise ValueError(f"{R} emit rows; the kernel takes 1..1024")
    if W < 1:
        raise ValueError("f_args must have at least one column")
    return dev, (F, R, W)


def front_merge_plan(f_times, f_types, f_args, f_seqs, front_n, t_r, ty_r,
                     arg_r, seq_r, to_front):
    """The launch plan of this call signature, built by
    :func:`_merge_plan` the first time it is seen (``lex`` is a launch
    argument, not part of the plan)."""
    key = ("front_merge",) + signature(f_times, f_types, f_args, f_seqs,
                                       front_n, t_r, ty_r, arg_r, seq_r,
                                       to_front)
    return PLANS.get(key) or remember(key, _merge_plan(
        f_times, f_types, f_args, f_seqs, front_n, t_r, ty_r, arg_r, seq_r,
        to_front))


def front_merge_cuda(f_times, f_types, f_args, f_seqs, front_n,
                     t_r, ty_r, arg_r, seq_r, to_front, *, lex=False):
    """The same function as one launch of the CUDA kernel."""
    dev, dims = front_merge_plan(f_times, f_types, f_args, f_seqs, front_n,
                                 t_r, ty_r, arg_r, seq_r, to_front)
    F, R, W = dims
    outs = (torch.empty(F + R, dtype=torch.float32, device=dev),
            torch.empty(F + R, dtype=torch.int32, device=dev),
            torch.empty(F + R, W, dtype=torch.float32, device=dev),
            torch.empty(F + R, dtype=torch.int32, device=dev))
    ptrs = (ctypes.c_void_p * 14)(
        f_times.data_ptr(), f_types.data_ptr(), f_args.data_ptr(),
        f_seqs.data_ptr(), front_n.data_ptr(), t_r.data_ptr(),
        ty_r.data_ptr(), arg_r.data_ptr(), seq_r.data_ptr(),
        to_front.data_ptr(), *(o.data_ptr() for o in outs))
    status = launch_on(dev, _lib().front_merge_launch, ptrs, *dims,
                       int(lex))
    _launch_status("front_merge", status)
    LAUNCHES["front_merge"] += 1
    return outs


def front_merge(f_times, f_types, f_args, f_seqs, front_n,
                t_r, ty_r, arg_r, seq_r, to_front, *, lex=False):
    """Counting-merge ``R`` emit rows into the sorted front tier.

    Returns the merged ``(times, types, args, seqs)`` columns, ``F + R``
    wide; slots ``[F:]`` are the evicted tail the caller stages.
    ``to_front`` marks the rows bound for the front.  Row seqs must
    exceed every queued seq, unless ``lex`` places the rows by their
    full ``(time, seq)`` keys.
    """
    if _route(f_times.device) == "plain":
        return front_merge_plain(f_times, f_types, f_args, f_seqs, front_n,
                                 t_r, ty_r, arg_r, seq_r, to_front, lex=lex)
    return front_merge_cuda(f_times, f_types, f_args, f_seqs, front_n,
                            t_r, ty_r, arg_r, seq_r, to_front, lex=lex)
