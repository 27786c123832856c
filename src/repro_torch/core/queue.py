"""Pending-event sets on the device (PyTorch port).

Counterparts of the queue families of :mod:`repro.core.queue`
(DESIGN.md §4):

* the **tiered3** queue (§4.4, the default): a small sorted *front* tier
  (the globally earliest events), an unsorted *staging* ring, a pool of
  fixed-size sorted *runs*, and the capacity-sized sorted *main* ring,
  with the invariant ``max(front) <= min(staging ∪ runs ∪ main)`` under
  the lexicographic ``(time, seq)`` key;
* the **two-tier** queue (``TieredDeviceQueue``): front, staging and
  main, the staging ring flushed straight into main;
* the **flat** queue (``DeviceQueue``): one array a column, as a sorted
  prefix (the ``flat`` mode) or in first-free-slot order with serial
  argmin extraction (the ``reference`` mode, the executable spec).

Every operation reproduces the JAX queue bit for bit: same fields, same
values, same ghost and ``dropped`` accounting.

How the JAX control flow maps onto eager PyTorch:

* Every ``lax.cond`` of the tiered3 queue is a
  :func:`repro_torch.core.capture.cond` (or ``if_else``): in the eager
  loop a Python ``if`` on one host read of its predicate
  (:func:`host_read`, counted in ``COUNTS["host_syncs"]``), in the
  engine's captured loop an IF node of the step's CUDA graph.  Each
  rare path counts its firings under its own key (:func:`bump`), so a
  run can show which paths it exercised.  The two-tier queue's conds
  are spelled the same way.
* ``dynamic_slice``/``dynamic_update_slice`` clamp their start the way
  XLA does (:func:`_update_slice`), and every index a gather sees is
  clipped in range, as in the JAX code, so no gather can fault.
* The staging scatters with ``mode="drop"`` write into one scratch slot
  past the end that is then cut off (:func:`_scatter_rows`), so no
  out-of-range index reaches the device.
* Ties break on ``(time, seq, index)`` everywhere: all-pairs ranks where
  JAX uses them, and two stable sorts for ``lax.sort``'s stable
  two-key sort (:func:`_lex_order`).

The tiered queues' per-super-step hot loops, the window extract and
the front merge, go through :mod:`repro_torch.kernels.queue_front`,
which launches the hand-written CUDA kernels for tensors on a CUDA
device and runs their plain PyTorch versions on the CPU.  The flat and
reference modes reach no kernel, in JAX as here: their extraction and
insert are torch operations, and their ``lax.cond`` rounds are selects,
so a flat or reference super-step reads the host only for the engine's
guard and window.

Queue tensors are never updated in place: every operation returns new
tensors, as the JAX functions do (a captured cond writes its body's
results into the queue it was given; see :mod:`repro_torch.core.capture`).
"""

from __future__ import annotations

import heapq
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.capture import (  # noqa: F401  (re-exported)
    COUNTS,
    bump,
    cond,
    host_list,
    host_read,
    if_else,
)
from repro_torch.core.events import ARG_WIDTH, Event

INF = float("inf")
I32_MAX = 2**31 - 1
_I32 = torch.int32



class HostEventQueue:
    """Binary heap of Events keyed by (time, seq): the pending set of
    the host-driven runtimes (the serving control plane)."""

    def __init__(self):
        self._heap: list[tuple[float, int, Event]] = []
        self._seq = 0
        self.push_count = 0
        self.pop_count = 0

    def push(self, time: float, type_id: int, arg: Any = None) -> Event:
        ev = Event(time=float(time), type_id=int(type_id), arg=arg,
                   seq=self._seq)
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        self._seq += 1
        self.push_count += 1
        return ev

    def push_all(self, items) -> None:
        """Push ``(time, type_id, arg)`` items in order, each with the
        seq that one :meth:`push` after another would give it, and
        restore the heap once (O(n), where n pushes are O(n log n)): the
        pop order, by (time, seq), is the same."""
        heap = self._heap
        n0 = len(heap)
        for (time, type_id, arg) in items:
            ev = Event(time=float(time), type_id=int(type_id), arg=arg,
                       seq=self._seq)
            heap.append((ev.time, ev.seq, ev))
            self._seq += 1
        heapq.heapify(heap)
        self.push_count += len(heap) - n0

    def push_event(self, ev: Event) -> None:
        """Re-insert an existing event, PRESERVING its seq (its tie-break
        rank among same-timestamp events)."""
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        self._seq = max(self._seq, ev.seq + 1)
        self.push_count += 1

    def pop(self) -> Event:
        self.pop_count += 1
        return heapq.heappop(self._heap)[2]

    def peek(self) -> Event:
        return self._heap[0][2]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


def to_local(x: torch.Tensor) -> torch.Tensor:
    """This rank's tensor of a ``DTensor`` (its shard's slice, or its
    copy of a replicated value); a plain tensor as it is."""
    return x.to_local() if hasattr(x, "to_local") else x


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated along dim 0 in rank
    order (one counted collective, ``COUNTS["collectives"]``, through
    :func:`bump`, so that a captured step counts it each replay): the
    list form of ``all_gather``, which NCCL and gloo both take for CUDA
    tensors.  Every rank of ``group`` must call it with a tensor of the
    same shape and dtype."""
    import torch.distributed as dist

    bump("collectives")
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# Small helpers shared with the kernels' plain versions
# ---------------------------------------------------------------------------

def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=device)


def _i32(x) -> torch.Tensor:
    return x.to(_I32)


def i32_sat(x: torch.Tensor) -> torch.Tensor:
    """Float to int32 as XLA's convert does: truncate toward zero,
    clamp to ``[-2**31, 2**31 - 1]`` and map NaN to 0.  A bare
    ``.to(torch.int32)`` is undefined out of range (-2**31 on the CPU
    for NaN, ±inf and every value past either end).  The ends are
    compared before the cast: 2**31 is an f32 and lies past the int32
    top, and 2147483520.0 is the largest f32 that fits."""
    hi = x >= 2.0 ** 31
    lo = x < -(2.0 ** 31)
    safe = torch.where(hi | lo | torch.isnan(x), torch.zeros_like(x), x)
    out = safe.to(_I32)
    out = torch.where(hi, torch.full_like(out, I32_MAX), out)
    return torch.where(lo, torch.full_like(out, -2**31), out)


def _take(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(col, idx, axis=0)`` for in-range indices."""
    flat = col.index_select(0, idx.reshape(-1).long())
    return flat.reshape(tuple(idx.shape) + tuple(col.shape[1:]))


def _at(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``col[idx]`` for a 0-d in-range index tensor, without a sync."""
    return col.index_select(0, idx.reshape(1).long()).reshape(
        tuple(col.shape[1:]))


def _update_slice(col: torch.Tensor, block: torch.Tensor,
                  start: torch.Tensor) -> torch.Tensor:
    """``lax.dynamic_update_slice_in_dim(col, block, start, 0)``: XLA
    clamps the start into ``[0, len(col) - len(block)]``."""
    n, p = block.shape[0], col.shape[0]
    start = torch.clamp(start, 0, p - n)
    idx = start + _arange(n, col.device)
    return col.index_copy(0, idx.long(), block)


def _scatter_rows(col: torch.Tensor, dest: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """``col.at[dest].set(vals, mode="drop")`` where every dropped row
    carries ``dest == len(col)``: those rows land in a scratch slot that
    is cut off, so no out-of-range index reaches the device."""
    ext = torch.cat([col, col[:1]])
    ext.index_copy_(0, dest.long(), vals)
    return ext[:-1]


def _small_lex_perm(ts: torch.Tensor, sq: torch.Tensor) -> torch.Tensor:
    """Permutation sorting a tiny vector by ``(ts, sq, index)``
    ascending, from all-pairs ranks (unique in ``[0, m)``)."""
    m = ts.shape[0]
    i = _arange(m, ts.device)
    t_gt = ts[:, None] > ts[None, :]
    t_eq = ts[:, None] == ts[None, :]
    s_gt = sq[:, None] > sq[None, :]
    s_eq = sq[:, None] == sq[None, :]
    before = t_gt | (t_eq & s_gt) | (t_eq & s_eq & (i[:, None] > i[None, :]))
    rank = before.sum(dim=1)
    return torch.empty_like(rank).scatter_(0, rank, i.long())


def _prefix_rank(mask: torch.Tensor) -> torch.Tensor:
    """Rank of each position among the True positions (-1 where False
    counts itself out)."""
    return _i32(torch.cumsum(mask.to(_I32), 0)) - 1


def _lex_order(ts: torch.Tensor, sq: torch.Tensor) -> torch.Tensor:
    """Ascending ``(time, seq, index)`` permutation: the stable two-key
    ``lax.sort`` as two stable sorts (minor key first)."""
    p1 = torch.sort(sq, stable=True).indices
    p2 = torch.sort(ts[p1], stable=True).indices
    return p1[p2]


def _f32(x) -> float:
    """Round a host float to f32, as ``jnp.asarray(x, jnp.float32)``."""
    return float(np.float32(x))


def window_prefix_mask(ts, wins, valid, t_cap=None) -> torch.Tensor:
    """Vectorized §III-B dynamic-lookahead take rule.

    Over candidates sorted by ``(time, seq)``: take event ``i`` iff
    every earlier candidate was taken and ``t_i <= min(t_cap, min over
    j < i of wins_j)``.  An exclusive cummin plus a prefix-AND.
    """
    cap = INF if t_cap is None else _f32(t_cap)
    inf1 = torch.full((1,), INF, dtype=torch.float32, device=ts.device)
    t_max = torch.cat([inf1, torch.cummin(wins, 0).values[:-1]])
    ok = valid & (ts <= torch.clamp(t_max, max=cap))
    return torch.cumsum((~ok).to(_I32), 0) == 0


def shift_left(col: torch.Tensor, fill, length: torch.Tensor,
               k: int) -> torch.Tensor:
    """Pop ``length <= k`` slots off the front of ``col``: pad with
    ``k`` fill slots, then the ``dynamic_slice`` at ``length`` (start
    clamped into ``[0, k]`` as XLA does)."""
    F = col.shape[0]
    pad = torch.full((k,) + tuple(col.shape[1:]), fill, dtype=col.dtype,
                     device=col.device)
    start = torch.clamp(length, 0, k)
    return _take(torch.cat([col, pad]), start + _arange(F, col.device))


def _sentinel_cols(n: int, arg_width: int, device):
    return (
        torch.full((n,), INF, dtype=torch.float32, device=device),
        torch.full((n,), -1, dtype=_I32, device=device),
        torch.zeros((n, arg_width), dtype=torch.float32, device=device),
        torch.full((n,), I32_MAX, dtype=_I32, device=device),
    )


def _ring_unroll(col, fill, head, n, offset=0):
    """Materialize a head-offset ring column's live window at physical
    ``offset``: one gather (roll by ``head - offset``) with the dead
    slots reset to ``fill``."""
    P = col.shape[0]
    i = _arange(P, col.device)
    rolled = _take(col, torch.remainder(i - offset + head, P))
    live = (i >= offset) & (i < offset + n)
    mask = live if col.dim() == 1 else live[:, None]
    return torch.where(mask, rolled, fill)


def _host_sorted_seed(events, capacity: int, arg_width: int, seqs=None):
    """The surviving seed events as columns sorted by ``(time, seq)``,
    plus the logical counters: ``seq`` runs 0..N-1 (or the explicit
    ``seqs``) and events past ``capacity`` are dropped."""
    events = list(events)
    n = len(events)
    if seqs is not None:
        if len(seqs) != n:
            raise ValueError(f"{len(seqs)} explicit seqs for {n} seed events")
        if n > capacity:
            raise ValueError(
                f"explicit-seq seed of {n} events exceeds capacity "
                f"{capacity}: apply the overflow rule before sharding"
            )
    m = min(n, capacity)
    kept = events[:m]
    times = np.asarray([e[0] for e in kept], np.float32).reshape(m)
    types = np.asarray([e[1] for e in kept], np.int32).reshape(m)
    args = np.zeros((m, arg_width), np.float32)
    for i, e in enumerate(kept):
        if e[2] is not None:
            args[i] = np.asarray(e[2], np.float32)
    seq_col = (np.arange(m, dtype=np.int32) if seqs is None
               else np.asarray(seqs, np.int32)[:m])
    order = np.lexsort((seq_col, times))
    return (times[order], types[order], args[order], seq_col[order], n, m)


# ---------------------------------------------------------------------------
# The queue
# ---------------------------------------------------------------------------

class Tiered3DeviceQueue(NamedTuple):
    """Front / staging / run log / main, field for field the JAX
    ``Tiered3DeviceQueue``.  ``m_*`` is physically ``capacity +
    num_runs * stage_cap`` slots; the logical capacity excludes that
    slack.  Scalars are 0-d int32 tensors."""

    f_times: torch.Tensor   # f32[front_cap]
    f_types: torch.Tensor   # i32[front_cap], -1 = empty
    f_args: torch.Tensor    # f32[front_cap, ARG_WIDTH]
    f_seqs: torch.Tensor    # i32[front_cap]
    m_times: torch.Tensor   # f32[capacity + num_runs*stage_cap]
    m_types: torch.Tensor
    m_args: torch.Tensor
    m_seqs: torch.Tensor
    s_times: torch.Tensor   # f32[stage_cap]
    s_types: torch.Tensor
    s_args: torch.Tensor
    s_seqs: torch.Tensor
    r_times: torch.Tensor   # f32[num_runs, stage_cap]
    r_types: torch.Tensor
    r_args: torch.Tensor
    r_seqs: torch.Tensor
    r_off: torch.Tensor     # i32[num_runs], consumed prefix of each run
    r_len: torch.Tensor     # i32[num_runs], written length of each run
    front_n: torch.Tensor
    main_n: torch.Tensor
    m_head: torch.Tensor    # first logical main slot (ring)
    stage_n: torch.Tensor
    size: torch.Tensor      # logical pushes (incl. ghosts)
    next_seq: torch.Tensor
    dropped: torch.Tensor

    # Shapes are read from the trailing axes, so a stacked queue (every
    # field with a leading shard axis, as ``tiered3_stacked_*`` take it)
    # has the same geometry.
    @property
    def main_phys(self) -> int:
        return self.m_times.shape[-1]

    @property
    def capacity(self) -> int:
        return self.main_phys - self.num_runs * self.stage_cap

    @property
    def front_cap(self) -> int:
        return self.f_times.shape[-1]

    @property
    def stage_cap(self) -> int:
        return self.s_times.shape[-1]

    @property
    def num_runs(self) -> int:
        return self.r_times.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.f_times.device


def _field_dtype(name: str):
    """A queue field's dtype, by the JAX queues' naming: times and args
    are f32, the two-tier queue's ``s_evict`` tags bool, the rest int32."""
    if name.endswith(("times", "args")):
        return torch.float32, np.float32
    if name == "s_evict":
        return torch.bool, np.bool_
    return _I32, np.int32


def queue_from_arrays(cls, fields, device):
    """Build a ``cls`` queue (any of the port's queue NamedTuples) from
    numpy arrays keyed by the JAX queue's field names."""
    out = {}
    for name in cls._fields:
        t_dtype, np_dtype = _field_dtype(name)
        arr = np.asarray(fields[name]).astype(np_dtype)
        out[name] = torch.tensor(arr, dtype=t_dtype, device=device)
    return cls(**out)


def queue_to_arrays(q) -> dict:
    """Every field of a queue as a numpy array, keyed by name."""
    return {name: getattr(q, name).cpu().numpy() for name in q._fields}


def tiered3_queue_from_arrays(fields, device) -> Tiered3DeviceQueue:
    """Build a tiered3 queue from numpy arrays keyed by the JAX queue's
    field names (f32 fields stay f32, every other field becomes int32)."""
    return queue_from_arrays(Tiered3DeviceQueue, fields, device)


tiered3_queue_to_arrays = queue_to_arrays


def tiered3_queue_init(capacity: int, *, front_cap: int = 256,
                       stage_cap: int = 256, num_runs: int = 8,
                       arg_width: int = ARG_WIDTH,
                       device="cpu") -> Tiered3DeviceQueue:
    front_cap = min(front_cap, capacity)
    phys = capacity + num_runs * stage_cap
    ft, fy, fa, fs = _sentinel_cols(front_cap, arg_width, device)
    mt, my, ma, ms = _sentinel_cols(phys, arg_width, device)
    st, sy, sa, ss = _sentinel_cols(stage_cap, arg_width, device)
    rt, ry, ra, rs = _sentinel_cols(num_runs * stage_cap, arg_width, device)

    def zero():
        return torch.zeros((), dtype=_I32, device=device)

    return Tiered3DeviceQueue(
        f_times=ft, f_types=fy, f_args=fa, f_seqs=fs,
        m_times=mt, m_types=my, m_args=ma, m_seqs=ms,
        s_times=st, s_types=sy, s_args=sa, s_seqs=ss,
        r_times=rt.reshape(num_runs, stage_cap),
        r_types=ry.reshape(num_runs, stage_cap),
        r_args=ra.reshape(num_runs, stage_cap, arg_width),
        r_seqs=rs.reshape(num_runs, stage_cap),
        r_off=torch.zeros((num_runs,), dtype=_I32, device=device),
        r_len=torch.zeros((num_runs,), dtype=_I32, device=device),
        front_n=zero(), main_n=zero(), m_head=zero(), stage_n=zero(),
        size=zero(), next_seq=zero(), dropped=zero(),
    )


def tiered3_queue_from_host(events, capacity: int, *, front_cap: int = 256,
                            stage_cap: int = 256, num_runs: int = 8,
                            arg_width: int = ARG_WIDTH, seqs=None,
                            device="cpu") -> Tiered3DeviceQueue:
    """Host-built seed queue, one copy to ``device``: the earliest
    ``front_cap`` events seed the front, the rest the main ring at head
    0; runs and staging start empty."""
    times, types, args, seq_col, n, m = _host_sorted_seed(
        events, capacity, arg_width, seqs)
    if seqs is None:
        counters = dict(size=n, next_seq=n, dropped=n - m)
    else:
        counters = dict(size=m, next_seq=int(seq_col.max()) + 1 if m else 0,
                        dropped=0)
    return _queue_from_sorted(times, types, args, seq_col, capacity,
                              front_cap, stage_cap, num_runs, counters,
                              device)


def tiered3_queue_from_columns(times, types, args, seqs, capacity: int, *,
                               front_cap: int = 256, stage_cap: int = 256,
                               num_runs: int = 8,
                               device="cpu") -> Tiered3DeviceQueue:
    """:func:`tiered3_queue_from_host` with explicit seqs, from numpy
    columns (``f32[m]``, ``i32[m]``, ``f32[m, W]``, ``i32[m]``, ``m <=
    capacity``) instead of a list of events."""
    m = int(np.asarray(times).shape[0])
    if m > capacity:
        raise ValueError(
            f"explicit-seq seed of {m} events exceeds capacity {capacity}")
    times = np.asarray(times, np.float32)
    seqs = np.asarray(seqs, np.int32)
    order = np.lexsort((seqs, times))
    counters = dict(size=m, next_seq=int(seqs.max()) + 1 if m else 0,
                    dropped=0)
    return _queue_from_sorted(
        times[order], np.asarray(types, np.int32)[order],
        np.asarray(args, np.float32)[order], seqs[order], capacity,
        front_cap, stage_cap, num_runs, counters, device)


def _queue_from_sorted(times, types, args, seq_col, capacity, front_cap,
                       stage_cap, num_runs, counters, device):
    front_cap = min(front_cap, capacity)
    phys = capacity + num_runs * stage_cap
    arg_width = args.shape[1]
    m = times.shape[0]
    nf = min(m, front_cap)
    nm = m - nf

    def column(n_slots, fill, dtype, src):
        col = np.full((n_slots,) + src.shape[1:], fill, dtype)
        col[:src.shape[0]] = src
        return col

    fields = dict(
        f_times=column(front_cap, np.inf, np.float32, times[:nf]),
        f_types=column(front_cap, -1, np.int32, types[:nf]),
        f_args=column(front_cap, 0, np.float32, args[:nf]),
        f_seqs=column(front_cap, I32_MAX, np.int32, seq_col[:nf]),
        m_times=column(phys, np.inf, np.float32, times[nf:]),
        m_types=column(phys, -1, np.int32, types[nf:]),
        m_args=column(phys, 0, np.float32, args[nf:]),
        m_seqs=column(phys, I32_MAX, np.int32, seq_col[nf:]),
        s_times=np.full((stage_cap,), np.inf, np.float32),
        s_types=np.full((stage_cap,), -1, np.int32),
        s_args=np.zeros((stage_cap, arg_width), np.float32),
        s_seqs=np.full((stage_cap,), I32_MAX, np.int32),
        r_times=np.full((num_runs, stage_cap), np.inf, np.float32),
        r_types=np.full((num_runs, stage_cap), -1, np.int32),
        r_args=np.zeros((num_runs, stage_cap, arg_width), np.float32),
        r_seqs=np.full((num_runs, stage_cap), I32_MAX, np.int32),
        r_off=np.zeros((num_runs,), np.int32),
        r_len=np.zeros((num_runs,), np.int32),
        front_n=nf, main_n=nm, m_head=0, stage_n=0, **counters,
    )
    return tiered3_queue_from_arrays(fields, device)


# ---------------------------------------------------------------------------
# Summaries
# ---------------------------------------------------------------------------
# Each summary reduces over the trailing (slot) axes only, so it takes a
# single queue (0-d results) or a stacked one (``[N]`` results) alike:
# the stacked forms below are these functions, as JAX's are its per-shard
# ops under ``vmap``.

def _gather_last(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``col[..., idx]`` with one in-range index per leading position
    (``idx`` has ``col``'s leading shape), without a sync."""
    return col.gather(-1, idx.long()[..., None])[..., 0]


def _run_mins(q: Tiered3DeviceQueue) -> torch.Tensor:
    """Head time of each run's live remainder (``inf`` when consumed)."""
    head = _gather_last(q.r_times, torch.clamp(q.r_off, 0, q.stage_cap - 1))
    return torch.where(q.r_len > q.r_off, head, INF)


def tiered3_queue_has_pending(q: Tiered3DeviceQueue) -> torch.Tensor:
    """True while any tier holds a real event (a 0-d bool tensor)."""
    return ((q.front_n > 0) | (q.stage_n > 0) | (q.main_n > 0)
            | torch.any(q.r_len > q.r_off, dim=-1))


def tiered3_queue_occupancy(q: Tiered3DeviceQueue) -> torch.Tensor:
    """Number of real pending events across all four tiers."""
    return q.front_n + q.stage_n + q.main_n + _i32(
        torch.sum(q.r_len - q.r_off, dim=-1))


def _main_head(q: Tiered3DeviceQueue, col: torch.Tensor, fill):
    """``col`` at the main ring's head slot, ``fill`` when main is empty."""
    head = _gather_last(col, torch.clamp(q.m_head, 0, q.main_phys - 1))
    return torch.where(q.main_n > 0, head, fill)


def tiered3_queue_next_time(q: Tiered3DeviceQueue) -> torch.Tensor:
    """Earliest pending timestamp (``inf`` when empty)."""
    rest = torch.minimum(
        torch.minimum(q.s_times.amin(-1), _run_mins(q).amin(-1)),
        _main_head(q, q.m_times, INF))
    return torch.where(q.front_n > 0, q.f_times[..., 0], rest)


def _tiered3_boundary(q: Tiered3DeviceQueue) -> torch.Tensor:
    """Earliest time outside the front tier: staging, run heads and the
    main ring head (read at the ring offset)."""
    return torch.minimum(
        torch.minimum(_main_head(q, q.m_times, INF), q.s_times.amin(-1)),
        _run_mins(q).amin(-1))


def _lex_min_pair(t1, s1, t2, s2):
    """Lexicographic min of two ``(time, seq)`` keys."""
    t = torch.minimum(t1, t2)
    s = torch.minimum(torch.where(t1 == t, s1, I32_MAX),
                      torch.where(t2 == t, s2, I32_MAX))
    return t, s


def _tiered3_boundary_key(q: Tiered3DeviceQueue):
    """Lexicographic ``(time, seq)`` form of :func:`_tiered3_boundary`."""
    s_t = q.s_times.amin(-1)
    s_s = torch.where((q.s_times == s_t[..., None]) & (q.s_types >= 0),
                      q.s_seqs, I32_MAX).amin(-1)
    r_heads_t = _run_mins(q)
    r_heads_s = torch.where(
        q.r_len > q.r_off,
        _gather_last(q.r_seqs, torch.clamp(q.r_off, 0, q.stage_cap - 1)),
        I32_MAX)
    r_t = r_heads_t.amin(-1)
    r_s = torch.where(r_heads_t == r_t[..., None], r_heads_s,
                      I32_MAX).amin(-1)
    t, s = _lex_min_pair(s_t, s_s, r_t, r_s)
    return _lex_min_pair(t, s, _main_head(q, q.m_times, INF),
                         _main_head(q, q.m_seqs, I32_MAX))


def tiered3_queue_next_key(q: Tiered3DeviceQueue):
    """Full ``(time, seq)`` key of the earliest pending event —
    ``(inf, I32_MAX)`` when empty."""
    b_t, b_s = _tiered3_boundary_key(q)
    t = torch.where(q.front_n > 0, q.f_times[..., 0], b_t)
    s = torch.where(q.front_n > 0, q.f_seqs[..., 0], b_s)
    return t, s


# ---------------------------------------------------------------------------
# Rare paths: run-pool merge, ring rotate, staging flush, refills
# ---------------------------------------------------------------------------

def _merge_runs_into_main(q: Tiered3DeviceQueue) -> Tiered3DeviceQueue:
    """Drain the whole run pool into the main ring: one tail append
    when the sorted block follows the main tail and fits the slack,
    else the rotate-and-merge compaction."""
    R, S, P = q.num_runs, q.stage_cap, q.main_phys
    RL = R * S
    dev = q.device
    k_idx = _arange(S, dev)[None, :]
    live = (k_idx >= q.r_off[:, None]) & (k_idx < q.r_len[:, None])
    bt = torch.where(live, q.r_times, INF).reshape(RL)
    by = torch.where(live, q.r_types, -1).reshape(RL)
    ba = torch.where(live[:, :, None], q.r_args, 0.0).reshape(
        RL, q.r_args.shape[2])
    bs = torch.where(live, q.r_seqs, I32_MAX).reshape(RL)
    order = _lex_order(bt, bs)
    bt, by, ba, bs = bt[order], by[order], ba[order], bs[order]
    run_live = _i32(torch.sum(live))

    head = torch.where(q.main_n > 0, q.m_head, 0)
    tail = head + q.main_n
    m_last = _at(q.m_times, torch.clamp(tail - 1, 0, P - 1))
    can_append = ((q.main_n == 0) | (bt[0] > m_last)) & (tail + RL <= P)

    def append(q):
        bump("merge_append")
        return q._replace(
            m_times=_update_slice(q.m_times, bt, tail),
            m_types=_update_slice(q.m_types, by, tail),
            m_args=_update_slice(q.m_args, ba, tail),
            m_seqs=_update_slice(q.m_seqs, bs, tail),
            m_head=head,
        )

    def compact(q):
        bump("merge_compact")
        ct = torch.cat([_ring_unroll(q.m_times, INF, q.m_head, q.main_n), bt])
        cy = torch.cat([_ring_unroll(q.m_types, -1, q.m_head, q.main_n), by])
        ca = torch.cat([_ring_unroll(q.m_args, 0.0, q.m_head, q.main_n), ba])
        cs = torch.cat(
            [_ring_unroll(q.m_seqs, I32_MAX, q.m_head, q.main_n), bs])
        # Real elements <= logical capacity <= P, so truncating the
        # sorted concat to P drops only sentinels.
        perm = _lex_order(ct, cs)[:P]
        return q._replace(
            m_times=ct[perm], m_types=cy[perm], m_args=ca[perm],
            m_seqs=cs[perm], m_head=torch.zeros_like(q.m_head),
        )

    q = if_else(can_append, append, compact, q)
    return q._replace(
        main_n=q.main_n + run_live,
        r_off=torch.zeros_like(q.r_off),
        r_len=torch.zeros_like(q.r_len),
    )


def _rotate_main(q: Tiered3DeviceQueue) -> Tiered3DeviceQueue:
    """Re-center the sorted main ring at a margin of dead slots (one
    gather per column, no sort)."""
    bump("rotate")
    P, S = q.main_phys, q.stage_cap
    margin = torch.clamp(torch.clamp(P - q.main_n - S, min=0),
                         max=max(2 * S, P // 4))
    return q._replace(
        m_times=_ring_unroll(q.m_times, INF, q.m_head, q.main_n, margin),
        m_types=_ring_unroll(q.m_types, -1, q.m_head, q.main_n, margin),
        m_args=_ring_unroll(q.m_args, 0.0, q.m_head, q.main_n, margin),
        m_seqs=_ring_unroll(q.m_seqs, I32_MAX, q.m_head, q.main_n, margin),
        m_head=margin,
    )


def _flush_stage_to_run(q: Tiered3DeviceQueue) -> Tiered3DeviceQueue:
    """Drain the staging ring, splitting the sorted block three ways:
    the suffix after the main tail is appended to the ring's slack, the
    prefix inside the main head window is counting-merged into the ring
    head, and the middle becomes one new sorted run."""
    bump("flush")
    S, P = q.stage_cap, q.main_phys
    dev = q.device
    K = max(min(S, 32), S // 4)
    KS = K + S
    perm = _small_lex_perm(q.s_times, q.s_seqs)
    st, sty, sarg, sseq = (q.s_times[perm], q.s_types[perm],
                           q.s_args[perm], q.s_seqs[perm])
    sval = sty >= 0
    s_total = q.stage_n
    j_idx = _arange(S, dev)

    def sub_block(offset, count):
        """Sorted sub-range [offset, offset+count) of the staged block
        as its own S-wide block (sentinels past ``count``)."""
        idx = torch.clamp(offset + j_idx, 0, S - 1).long()
        live = j_idx < count
        return (torch.where(live, st[idx], INF),
                torch.where(live, sty[idx], -1),
                torch.where(live[:, None], sarg[idx], 0.0),
                torch.where(live, sseq[idx], I32_MAX))

    # --- suffix: strictly after the main tail -> slack append ---------
    head0 = torch.where(q.main_n > 0, q.m_head, 0)
    m_last = _at(q.m_times, torch.clamp(head0 + q.main_n - 1, 0, P - 1))
    after_tail = sval & ((q.main_n == 0) | (st > m_last))
    n_suf = _i32(torch.sum(after_tail))

    def suffix_append(q):
        bump("suffix_append")
        q = cond(torch.where(q.main_n > 0, q.m_head, 0) + q.main_n + S > P,
                 _rotate_main, q)
        head1 = torch.where(q.main_n > 0, q.m_head, 0)
        tail1 = head1 + q.main_n
        bt, by, ba, bs = sub_block(s_total - n_suf, n_suf)
        return q._replace(
            m_times=_update_slice(q.m_times, bt, tail1),
            m_types=_update_slice(q.m_types, by, tail1),
            m_args=_update_slice(q.m_args, ba, tail1),
            m_seqs=_update_slice(q.m_seqs, bs, tail1),
            m_head=head1,
            main_n=q.main_n + n_suf,
        )

    q = cond(n_suf > 0, suffix_append, q)

    # --- prefix: strictly inside the head window -> bounded merge -----
    suf_lo = s_total - n_suf
    n_pre = torch.zeros((), dtype=_I32, device=dev)
    head = torch.where(q.main_n > 0, q.m_head, 0)
    if KS <= P:
        ks_idx = _arange(KS, dev)
        ext_idx = torch.clamp(head + ks_idx, 0, P - 1)
        ext_live = ks_idx < q.main_n
        wt = torch.where(ext_live, _take(q.m_times, ext_idx), INF)
        ws = torch.where(ext_live, _take(q.m_seqs, ext_idx), I32_MAX)
        wy = torch.where(ext_live, _take(q.m_types, ext_idx), -1)
        wa = torch.where(ext_live[:, None], _take(q.m_args, ext_idx), 0.0)
        n_pre_want = _i32(torch.sum(sval & (j_idx < suf_lo) & (st < wt[K])))
        q = cond((n_pre_want > 0)
                 & ((head < n_pre_want) | (head - n_pre_want + KS > P)),
                 _rotate_main, q)
        head = torch.where(q.main_n > 0, q.m_head, 0)
        n_pre = torch.where(
            (head >= n_pre_want) & (head - n_pre_want + KS <= P),
            n_pre_want, 0)

        def head_merge(q):
            bump("head_merge")
            is_pre = j_idx < n_pre
            bt = torch.where(is_pre, st, INF)
            bs = torch.where(is_pre, sseq, I32_MAX)
            w_lt_b = (wt[None, :] < bt[:, None]) | (
                (wt[None, :] == bt[:, None]) & (ws[None, :] < bs[:, None]))
            pos_b = torch.where(is_pre, j_idx + _i32(w_lt_b.sum(dim=1)),
                                KS + S)
            ins_before = torch.searchsorted(pos_b, ks_idx, right=True,
                                            out_int32=True)
            is_ins = ins_before > torch.searchsorted(
                pos_b, ks_idx, right=False, out_int32=True)
            src = torch.where(is_ins,
                              KS + torch.clamp(ins_before - 1, 0, S - 1),
                              torch.clamp(ks_idx - ins_before, 0, KS - 1))
            start = head - n_pre

            def merge_put(col, wcol, bcol):
                merged = _take(torch.cat([wcol, bcol]), src)
                return _update_slice(col, merged, start)

            return q._replace(
                m_times=merge_put(q.m_times, wt, st),
                m_types=merge_put(q.m_types, wy, sty),
                m_args=merge_put(q.m_args, wa, sarg),
                m_seqs=merge_put(q.m_seqs, ws, sseq),
                m_head=start,
                main_n=q.main_n + n_pre,
            )

        q = cond(n_pre > 0, head_merge, q)

    # --- middle: whatever neither leg could place -> one sorted run ---
    n_mid = s_total - n_suf - n_pre

    def to_run(q):
        bump("to_run")
        q = cond(torch.all(q.r_len > q.r_off), _merge_runs_into_main, q)
        slot = _i32(q.r_off >= q.r_len).argmax().reshape(1)
        bt, by, ba, bs = sub_block(n_pre, n_mid)
        return q._replace(
            r_times=q.r_times.index_copy(0, slot, bt[None]),
            r_types=q.r_types.index_copy(0, slot, by[None]),
            r_args=q.r_args.index_copy(0, slot, ba[None]),
            r_seqs=q.r_seqs.index_copy(0, slot, bs[None]),
            r_off=q.r_off.index_copy(0, slot, torch.zeros_like(q.r_off[:1])),
            r_len=q.r_len.index_copy(0, slot, n_mid.reshape(1)),
        )

    q = cond(n_mid > 0, to_run, q)

    et, ey, ea, es = _sentinel_cols(S, q.s_args.shape[1], dev)
    return q._replace(s_times=et, s_types=ey, s_args=ea, s_seqs=es,
                      stage_n=torch.zeros_like(q.stage_n))


def _runs_intersect_refill(q: Tiered3DeviceQueue) -> torch.Tensor:
    """True iff some run holds an element the next main-only refill
    would need (strict time compare; a tie takes the k-way merge)."""
    take = torch.minimum(q.front_cap - q.front_n, q.main_n)
    last_idx = torch.clamp(q.m_head + take - 1, 0, q.main_phys - 1)
    last_t = _at(q.m_times, last_idx)
    return torch.min(_run_mins(q)) <= torch.where(take > 0, last_t, INF)


def _refill_front3(q: Tiered3DeviceQueue, w: int) -> Tiered3DeviceQueue:
    """Front refill: flush staging first, then the main-only gather or
    the bounded k-way merge with its take capped at ``w``."""
    q = cond(q.stage_n > 0, _flush_stage_to_run, q)
    return if_else(_runs_intersect_refill(q),
                   lambda q: _refill_kway(q, w), _refill_main_only, q)


def _refill_main_only(q: Tiered3DeviceQueue) -> Tiered3DeviceQueue:
    """Refill from the main ring head alone (no run intersects)."""
    bump("refill_main_only")
    F, P = q.front_cap, q.m_times.shape[0]
    take = torch.minimum(F - q.front_n, q.main_n)
    i_idx = _arange(F, q.device)
    from_front = i_idx < q.front_n
    f_idx = torch.clamp(i_idx, 0, F - 1)
    m_idx = torch.clamp(q.m_head + i_idx - q.front_n, 0, P - 1)
    fill_ok = i_idx < q.front_n + take

    def refill(fcol, mcol, fill):
        # The JAX gather over concat([front, main]) as two gathers.
        sel = from_front if fcol.dim() == 1 else from_front[:, None]
        ok = fill_ok if fcol.dim() == 1 else fill_ok[:, None]
        out = torch.where(sel, _take(fcol, f_idx), _take(mcol, m_idx))
        return torch.where(ok, out, fill)

    main_n = q.main_n - take
    return q._replace(
        f_times=refill(q.f_times, q.m_times, INF),
        f_types=refill(q.f_types, q.m_types, -1),
        f_args=refill(q.f_args, q.m_args, 0.0),
        f_seqs=refill(q.f_seqs, q.m_seqs, I32_MAX),
        front_n=q.front_n + take,
        main_n=main_n,
        m_head=torch.where(main_n > 0, q.m_head + take, 0),
    )


def _refill_kway(q: Tiered3DeviceQueue, w: int | None = None
                 ) -> Tiered3DeviceQueue:
    """Refill against a live run pool: the bounded k-way merge over the
    first ``w`` live elements of every run plus the main head window,
    lex-ranked all-pairs; each source advances its head offset by the
    number taken."""
    bump("refill_kway")
    F, R, S, P = q.front_cap, q.num_runs, q.stage_cap, q.main_phys
    dev = q.device
    W = F if w is None else min(w, F)
    N = (R + 1) * W
    A = q.r_args.shape[2]
    w_idx = _arange(W, dev)

    widx = q.r_off[:, None] + w_idx[None, :]
    rvalid = widx < q.r_len[:, None]
    wc = torch.clamp(widx, 0, S - 1).long()
    ct_r = torch.where(rvalid, q.r_times.gather(1, wc), INF)
    cy_r = q.r_types.gather(1, wc)
    ca_r = q.r_args.gather(1, wc[:, :, None].expand(R, W, A))
    cs_r = torch.where(rvalid, q.r_seqs.gather(1, wc), I32_MAX)

    midx = torch.clamp(q.m_head + w_idx, 0, P - 1)
    mvalid = w_idx < q.main_n
    ct_m = torch.where(mvalid, _take(q.m_times, midx), INF)
    cy_m = _take(q.m_types, midx)
    ca_m = _take(q.m_args, midx)
    cs_m = torch.where(mvalid, _take(q.m_seqs, midx), I32_MAX)

    ct = torch.cat([ct_r.reshape(R * W), ct_m])
    cy = torch.cat([cy_r.reshape(R * W), cy_m])
    ca = torch.cat([ca_r.reshape(R * W, A), ca_m])
    cs = torch.cat([cs_r.reshape(R * W), cs_m])
    src = torch.cat([
        _arange(R, dev)[:, None].expand(R, W).reshape(R * W),
        torch.full((W,), R, dtype=_I32, device=dev),
    ])
    valid = torch.cat([rvalid.reshape(R * W), mvalid])

    order = _small_lex_perm(ct, cs)
    ct, cy, ca, cs = ct[order], cy[order], ca[order], cs[order]
    src, valid = src[order], valid[order]

    need = torch.clamp(F - q.front_n, max=W)
    take = (_arange(N, dev) < need) & valid
    taken = _i32(torch.sum(take))
    # Untaken candidates count into bin R + 1 (always in range).  A
    # scatter-add, where bincount would read its largest bin to the host.
    counts = torch.zeros(R + 2, dtype=_I32, device=dev).scatter_add_(
        0, torch.where(take, src, R + 1).long(), torch.ones_like(src))

    main_taken = counts[R]
    main_n = q.main_n - main_taken
    i_idx = _arange(F, dev)
    srcF = torch.where(i_idx < q.front_n, i_idx,
                       F + torch.clamp(i_idx - q.front_n, 0, N - 1))
    fill_ok = i_idx < q.front_n + taken

    def refill(fcol, ccol, fill):
        out = _take(torch.cat([fcol, ccol]), srcF)
        mask = fill_ok if out.dim() == 1 else fill_ok[:, None]
        return torch.where(mask, out, fill)

    return q._replace(
        f_times=refill(q.f_times, ct, INF),
        f_types=refill(q.f_types, cy, -1),
        f_args=refill(q.f_args, ca, 0.0),
        f_seqs=refill(q.f_seqs, cs, I32_MAX),
        front_n=q.front_n + taken,
        r_off=q.r_off + counts[:R],
        main_n=main_n,
        m_head=torch.where(main_n > 0, q.m_head + main_taken, 0),
    )


# ---------------------------------------------------------------------------
# Per-super-step operations
# ---------------------------------------------------------------------------

def tiered3_queue_refill_flag(q: Tiered3DeviceQueue, k: int) -> torch.Tensor:
    """True iff a ``k``-wide peek must refill the front first: it holds
    fewer than ``k`` events and another tier holds some (a 0-d bool
    tensor, the predicate of JAX's refill ``lax.cond``)."""
    return (q.front_n < k) & (
        (q.stage_n > 0) | (q.main_n > 0)
        | torch.any(q.r_len > q.r_off, dim=-1))


def tiered3_queue_peek_front(q: Tiered3DeviceQueue, k: int, refill=None):
    """Refill the front if it holds fewer than ``k`` events and any
    other tier has some, then return the first ``k`` front slots
    without popping: ``(q', ts, tys, args, seqs)``.  ``refill``, a host
    bool, is the caller's reading of :func:`tiered3_queue_refill_flag`
    (the sharded engine reads every shard's flag in one host read);
    ``None`` reads it here."""
    if k > q.front_cap:
        raise ValueError(
            f"peek width {k} exceeds front tier capacity {q.front_cap}")
    w = min(q.front_cap, 4 * k)
    if refill is None:
        q = cond(tiered3_queue_refill_flag(q, k),
                 lambda q: _refill_front3(q, w), q)
    elif refill:
        q = _refill_front3(q, w)
    return q, q.f_times[:k], q.f_types[:k], q.f_args[:k], q.f_seqs[:k]


def tiered3_queue_pop_prefix(q: Tiered3DeviceQueue, length, k: int
                             ) -> Tiered3DeviceQueue:
    """Pop the first ``length`` (<= ``k``) front events."""
    return q._replace(
        f_times=shift_left(q.f_times, INF, length, k),
        f_types=shift_left(q.f_types, -1, length, k),
        f_args=shift_left(q.f_args, 0.0, length, k),
        f_seqs=shift_left(q.f_seqs, I32_MAX, length, k),
        front_n=q.front_n - length,
        size=q.size - length,
    )


def tiered3_queue_extract(q: Tiered3DeviceQueue, max_len: int, lookaheads,
                          t_cap=None, bound=None):
    """Window extraction from the front tier (paper Fig 2): the bounded
    refill, then the take rule and prefix pop in one
    :func:`repro_torch.kernels.queue_front.window_extract` call.

    ``bound`` optionally caps the candidate set at a lexicographic
    ``(time, seq)`` key, two 0-d tensors on the queue's device: only
    events strictly lex-before it are eligible.  This is the spill
    policy's and the streamed arrivals' ordering fence; the eligible set
    is a lex prefix of the sorted candidates, so the take rule sees the
    queue simply ending earlier.

    Returns ``(q', ts, tys, args, length)`` with ``length`` a 0-d int32
    tensor.
    """
    if max_len > q.front_cap:
        raise ValueError(
            f"max_len {max_len} exceeds front tier capacity {q.front_cap}")
    from repro_torch.kernels.queue_front import window_extract

    q, *_ = tiered3_queue_peek_front(q, max_len)
    ts, tys, args, length, nt, ny, na, ns = window_extract(
        q.f_times, q.f_types, q.f_args, q.f_seqs, lookaheads, t_cap,
        k=max_len, bound=bound)
    q = q._replace(f_times=nt, f_types=ny, f_args=na, f_seqs=ns,
                   front_n=q.front_n - length, size=q.size - length)
    return q, ts, tys, args, length


def _default_fill_accounting(q: Tiered3DeviceQueue, rows):
    """Valid row ``r`` gets ``seq = next_seq + vrank(r)`` and survives
    iff ``size + vrank(r) < capacity`` (``size`` counts ghosts)."""
    ty_r = i32_sat(rows[:, 1])
    valid = ty_r >= 0
    vrank = _prefix_rank(valid)
    num_valid = _i32(torch.sum(valid))
    insert = valid & (q.size + vrank < q.capacity)
    num_insert = _i32(torch.sum(insert))
    seq_r = q.next_seq + vrank
    counters = dict(
        size=q.size + num_valid,
        next_seq=q.next_seq + num_valid,
        dropped=q.dropped + (num_valid - num_insert),
    )
    return seq_r, insert, counters


def _tiered_fill_finish(q, rows, b_time, seq_r, insert, counters,
                        b_seq=None):
    """Shared tail of the two-tier and tiered3 fills (the queues share
    their ``f_*``/``s_*`` fields; the two-tier ``s_evict`` tags are
    updated iff the queue carries them).  Partition the emit block
    against the tier boundary,
    counting-merge the near rows into the front
    (:func:`repro_torch.kernels.queue_front.front_merge`, ``front_cap +
    R`` wide: the tail is evicted to staging), append the rest to
    staging, and install the caller's counters.  Row seqs must exceed
    every queued seq, unless ``b_seq`` is given: then the boundary
    partition and the front placement compare full ``(time, seq)`` keys
    (the merge's ``lex`` mode), which is what lets rows with older seqs
    (reabsorbed spills, stream arrivals) land at their exact rank."""
    from repro_torch.kernels.queue_front import front_merge

    R = rows.shape[0]
    F = q.front_cap
    t_r = rows[:, 0].contiguous()
    ty_r = i32_sat(rows[:, 1])
    arg_r = rows[:, 2:].contiguous()
    r_idx = _arange(R, q.device)
    if b_seq is None:
        to_front = insert & (t_r < b_time)
    else:
        to_front = insert & ((t_r < b_time)
                             | ((t_r == b_time) & (seq_r < b_seq)))
    to_stage = insert & ~to_front

    merged_t, merged_y, merged_a, merged_s = front_merge(
        q.f_times, q.f_types, q.f_args, q.f_seqs, q.front_n,
        t_r, ty_r, arg_r, seq_r, to_front, lex=b_seq is not None)

    n_front = _i32(torch.sum(to_front))
    occ_after = q.front_n + n_front
    evict_cnt = torch.clamp(occ_after - F, min=0)
    front_n_new = torch.clamp(occ_after, max=F)

    # --- staging appends: evicted front tail, then direct rows --------
    SC = q.stage_cap
    e_valid = merged_y[F:] >= 0
    dest_e = torch.where(e_valid, q.stage_n + r_idx, SC)
    srank = _prefix_rank(to_stage)
    dest_s = torch.where(to_stage, q.stage_n + evict_cnt + srank, SC)
    n_stage = _i32(torch.sum(to_stage))

    def stage_put(col, evals, svals):
        return _scatter_rows(_scatter_rows(col, dest_e, evals), dest_s,
                             svals)

    extra = {}
    if hasattr(q, "s_evict"):
        # The two-tier queue tags each staged row: evicted from the
        # front (True) or a direct row (False).
        extra["s_evict"] = stage_put(
            q.s_evict, torch.ones_like(e_valid), torch.zeros_like(to_stage))
    return q._replace(
        f_times=merged_t[:F], f_types=merged_y[:F],
        f_args=merged_a[:F], f_seqs=merged_s[:F],
        s_times=stage_put(q.s_times, merged_t[F:], t_r),
        s_types=stage_put(q.s_types, merged_y[F:], ty_r),
        s_args=stage_put(q.s_args, merged_a[F:], arg_r),
        s_seqs=stage_put(q.s_seqs, merged_s[F:], seq_r),
        front_n=front_n_new,
        stage_n=q.stage_n + evict_cnt + n_stage,
        **counters,
        **extra,
    )


def preflush_flag(q, R: int) -> torch.Tensor:
    """True iff ``R`` staging appends could overflow the staging ring (a
    0-d bool tensor, the predicate of JAX's pre-fill flush ``cond``)."""
    if R > q.stage_cap:
        raise ValueError(
            f"emit block of {R} rows exceeds stage_cap {q.stage_cap}")
    return q.stage_n + R > q.stage_cap


def _tiered3_preflush(q: Tiered3DeviceQueue, R: int,
                      flush=None) -> Tiered3DeviceQueue:
    """Make room for up to ``R`` staging appends before a fill.
    ``flush``, a host bool, is the caller's reading of
    :func:`preflush_flag`; ``None`` reads it here."""
    flag = preflush_flag(q, R)
    if flush is None:
        return cond(flag, _flush_stage_to_run, q)
    if flush:
        q = _flush_stage_to_run(q)
    return q


def tiered3_queue_fill_rows(q: Tiered3DeviceQueue, rows
                            ) -> Tiered3DeviceQueue:
    """Per-batch emit insert touching only the front and staging tiers.
    Row layout ``(time, type, arg...)``; ``type < 0`` rows are skipped."""
    rows = rows.to(torch.float32)
    q = _tiered3_preflush(q, rows.shape[0])
    seq_r, insert, counters = _default_fill_accounting(q, rows)
    return _tiered_fill_finish(q, rows, _tiered3_boundary(q), seq_r,
                               insert, counters)


def tiered3_queue_fill_rows_tagged(q: Tiered3DeviceQueue, rows, seqs,
                                   insert, *, flush=None
                                   ) -> Tiered3DeviceQueue:
    """Emit insert with seqs and survival decided by the caller (the
    sharded engine's global counter); rows outside ``insert`` are
    ignored entirely.  ``flush`` is the pre-flush decision when the
    caller has read it (:func:`_tiered3_preflush`)."""
    rows = rows.to(torch.float32)
    seqs = seqs.to(_I32)
    q = _tiered3_preflush(q, rows.shape[0], flush)
    insert = insert & (rows[:, 1] >= 0)
    n_ins = _i32(torch.sum(insert))
    counters = dict(
        size=q.size + n_ins,
        next_seq=torch.maximum(
            q.next_seq, torch.max(torch.where(insert, seqs + 1, 0))),
        dropped=q.dropped,
    )
    return _tiered_fill_finish(q, rows, _tiered3_boundary(q), seqs, insert,
                               counters)


def tiered3_queue_absorb_rows(q: Tiered3DeviceQueue, rows, seqs,
                              insert=None) -> Tiered3DeviceQueue:
    """Absorb out-of-band rows carrying externally assigned seqs: the
    spill policy's reabsorbed rows and streamed arrival blocks.

    The rows' seqs may be older than queued ones, so the boundary
    partition and the front placement compare full ``(time, seq)`` keys
    (the ``b_seq`` mode of :func:`_tiered_fill_finish`).  Counters
    follow the tagged fill: ``size`` is the real occupancy, ``dropped``
    is untouched and ``next_seq`` is maxed past every absorbed seq; the
    caller guarantees the inserted rows fit.  ``insert`` optionally
    masks rows (ANDed with ``type >= 0``).  Rows are absorbed in chunks
    of ``stage_cap``, each after its own pre-flush check.
    """
    rows = rows.to(torch.float32)
    seqs = seqs.to(_I32)
    S = q.stage_cap
    for start in range(0, int(rows.shape[0]), S):
        chunk = rows[start:start + S]
        chunk_seqs = seqs[start:start + S]
        COUNTS["absorb_chunks"] += 1
        q = _tiered3_preflush(q, int(chunk.shape[0]))
        insert_c = chunk[:, 1] >= 0
        if insert is not None:
            insert_c = insert_c & insert[start:start + S]
        n_ins = _i32(torch.sum(insert_c))
        counters = dict(
            size=q.size + n_ins,
            next_seq=torch.maximum(
                q.next_seq,
                torch.max(torch.where(insert_c, chunk_seqs + 1, 0))),
            dropped=q.dropped,
        )
        b_t, b_s = _tiered3_boundary_key(q)
        q = _tiered_fill_finish(q, chunk, b_t, chunk_seqs, insert_c,
                                counters, b_seq=b_s)
    return q


# ---------------------------------------------------------------------------
# Stacked-axis variants (the layout of JAX's devices placement)
# ---------------------------------------------------------------------------
# A stacked queue is a Tiered3DeviceQueue whose every field carries a
# leading shard axis of size N (``repro_torch.core.sharded.
# StackedShardedQueue.q``).  JAX lifts its per-shard ops over that axis
# with ``vmap``; the port's ops read the host on their rare paths
# (``COUNTS``), which ``torch.vmap`` cannot lift.  The summaries reduce
# over the trailing axes only, so they are the per-shard ops themselves;
# the pop is one batched gather over the stack, the peek reads every
# shard's refill flag in one host read, and the fill and the absorb run
# the per-shard op on each shard and restack every field.  Each result
# is bit-identical to the per-shard op mapped over the shards.

def _stacked_shard(q: Tiered3DeviceQueue, i: int) -> Tiered3DeviceQueue:
    return q._make(x[i] for x in q)


def _restack(parts) -> Tiered3DeviceQueue:
    """The stacked queue of the per-shard queues ``parts``: every field
    stacked along a new leading shard axis."""
    return parts[0]._make(torch.stack(xs) for xs in zip(*parts))


# Per-shard pending flags ``bool[N]``, real occupancy ``i32[N]``,
# earliest timestamp ``f32[N]`` and ``(time, seq)`` key.
tiered3_stacked_has_pending = tiered3_queue_has_pending
tiered3_stacked_occupancy = tiered3_queue_occupancy
tiered3_stacked_next_time = tiered3_queue_next_time
tiered3_stacked_next_key = tiered3_queue_next_key


def tiered3_stacked_peek_front(q: Tiered3DeviceQueue, k: int, refill=None):
    """:func:`tiered3_queue_peek_front` over the shard axis: returns
    ``(q', ts[N,k], tys[N,k], args[N,k,W], seqs[N,k])``.  ``refill``, a
    host list of N bools, is the caller's reading of the shards' refill
    flags; ``None`` reads all N here in one host read.  Only the flagged
    shards refill."""
    if k > q.front_cap:
        raise ValueError(
            f"peek width {k} exceeds front tier capacity {q.front_cap}")
    if refill is None:
        refill = host_list(tiered3_queue_refill_flag(q, k))
    if any(refill):
        w = min(q.front_cap, 4 * k)
        q = _restack([
            _refill_front3(_stacked_shard(q, i), w) if r
            else _stacked_shard(q, i) for i, r in enumerate(refill)])
    return (q, q.f_times[:, :k], q.f_types[:, :k], q.f_args[:, :k],
            q.f_seqs[:, :k])


def tiered3_stacked_pop_prefix(q: Tiered3DeviceQueue, lengths, k: int
                               ) -> Tiered3DeviceQueue:
    """:func:`tiered3_queue_pop_prefix` over the shard axis: shard ``i``
    pops its first ``lengths[i]`` (<= ``k``) front events, as one gather
    a column (each shard's slice starts at its clamped length)."""
    lengths = torch.as_tensor(lengths, dtype=_I32, device=q.device)
    N, F = q.f_times.shape
    idx = (torch.clamp(lengths, 0, k)[:, None]
           + _arange(F, q.device)[None, :]).long()

    def shift(col, fill):
        pad = torch.full((N, k) + tuple(col.shape[2:]), fill,
                         dtype=col.dtype, device=col.device)
        i = idx.reshape((N, F) + (1,) * (col.dim() - 2)).expand(
            (N, F) + tuple(col.shape[2:]))
        return torch.cat([col, pad], dim=1).gather(1, i)

    return q._replace(
        f_times=shift(q.f_times, INF), f_types=shift(q.f_types, -1),
        f_args=shift(q.f_args, 0.0), f_seqs=shift(q.f_seqs, I32_MAX),
        front_n=q.front_n - lengths, size=q.size - lengths)


def tiered3_stacked_fill_rows_tagged(q: Tiered3DeviceQueue, rows, seqs,
                                     insert, *, flush=None
                                     ) -> Tiered3DeviceQueue:
    """:func:`tiered3_queue_fill_rows_tagged` over the shard axis: the
    R-row exchange block ``rows``/``seqs`` is shared, the ``insert``
    mask is per shard (``bool[N, R]``: row r lands in shard i iff
    ``insert[i, r]``).  ``flush``, a host list of N bools, is the
    caller's reading of the shards' pre-flush flags; ``None`` reads all
    N here in one host read.  One ``front_merge`` launch a shard."""
    if flush is None:
        flush = host_list(preflush_flag(q, rows.shape[0]))
    return _restack([
        tiered3_queue_fill_rows_tagged(_stacked_shard(q, i), rows, seqs,
                                       insert[i], flush=f)
        for i, f in enumerate(flush)])


def tiered3_stacked_absorb_rows(q: Tiered3DeviceQueue, rows, seqs,
                                insert) -> Tiered3DeviceQueue:
    """:func:`tiered3_queue_absorb_rows` over the shard axis (streamed
    arrivals at segment boundaries): shared ``rows``/``seqs``, a
    per-shard ``insert`` mask of shape ``(N, rows)``."""
    return _restack([
        tiered3_queue_absorb_rows(_stacked_shard(q, i), rows, seqs,
                                  insert=insert[i])
        for i in range(q.f_times.shape[0])])


class FlatQueue(NamedTuple):
    """A pending set as one ``(time, seq)``-sorted array per column (the
    JAX ``DeviceQueue`` layout): ``capacity`` slots, the occupied ones
    first, then the sentinels; numpy arrays and host ints."""

    times: np.ndarray
    types: np.ndarray
    args: np.ndarray
    seqs: np.ndarray
    size: int
    next_seq: int
    dropped: int


def tiered3_queue_to_flat(q: Tiered3DeviceQueue) -> FlatQueue:
    """Canonical flat view of a tiered3 queue, on the host: every live
    event of every tier, sorted by ``(time, seq)``."""
    a = tiered3_queue_to_arrays(q)
    head, main_n = int(a["m_head"]), int(a["main_n"])
    cols = ("times", "types", "args", "seqs")
    parts = [tuple(a[f"{pre}_{c}"] for c in cols) for pre in ("f", "s")]
    parts.append(tuple(a[f"m_{c}"][head:head + main_n] for c in cols))
    for i in range(q.num_runs):
        lo, hi = a["r_off"][i], a["r_len"][i]
        parts.append(tuple(a[f"r_{c}"][i, lo:hi] for c in cols))
    return _flat_view(q.capacity, q.f_args.shape[1], parts, a)


# ---------------------------------------------------------------------------
# The flat queue (the ``flat`` and ``reference`` modes)
# ---------------------------------------------------------------------------

class DeviceQueue(NamedTuple):
    """One array per column, field for field the JAX ``DeviceQueue``:
    ``types == -1`` marks a free slot, ``seq`` is the insertion counter
    that breaks time ties, ``dropped`` counts events lost to capacity
    overflow.  The ``flat`` mode keeps the occupied slots as a
    ``(time, seq)``-sorted prefix; the ``reference`` mode places rows in
    the first free slots, unsorted.  Scalars are 0-d int32 tensors."""

    times: torch.Tensor   # f32[capacity]
    types: torch.Tensor   # i32[capacity], -1 = empty
    args: torch.Tensor    # f32[capacity, ARG_WIDTH]
    seqs: torch.Tensor    # i32[capacity]
    size: torch.Tensor    # logical pushes (incl. ghosts)
    next_seq: torch.Tensor
    dropped: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.times.shape[0]

    @property
    def device(self) -> torch.device:
        return self.times.device


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=_I32, device=device)


def device_queue_init(capacity: int, arg_width: int = ARG_WIDTH,
                      device="cpu") -> DeviceQueue:
    t, y, a, s = _sentinel_cols(capacity, arg_width, device)
    return DeviceQueue(times=t, types=y, args=a, seqs=s, size=_zero(device),
                       next_seq=_zero(device), dropped=_zero(device))


def device_queue_from_host(events, capacity: int,
                           arg_width: int = ARG_WIDTH,
                           device="cpu") -> DeviceQueue:
    """Host-built seed queue, one copy to ``device``: the canonical
    layout (the occupied slots a ``(time, seq)``-sorted prefix), seq
    ``i`` for event ``i``, events past ``capacity`` dropped with
    ``size``/``next_seq`` still advancing."""
    st, sy, sa, ss, n, m = _host_sorted_seed(events, capacity, arg_width)
    fields = dict(
        times=np.full((capacity,), np.inf, np.float32),
        types=np.full((capacity,), -1, np.int32),
        args=np.zeros((capacity, arg_width), np.float32),
        seqs=np.full((capacity,), I32_MAX, np.int32),
        size=n, next_seq=n, dropped=n - m)
    for name, col in zip(("times", "types", "args", "seqs"),
                         (st, sy, sa, ss)):
        fields[name][:m] = col
    return queue_from_arrays(DeviceQueue, fields, device)


def device_queue_push(q: DeviceQueue, time, type_id, arg) -> DeviceQueue:
    """Insert one event into the first free slot; a full queue drops it
    (``dropped`` counts it, ``size``/``next_seq`` still advance).  The
    JAX ``lax.cond`` is a select: no host read."""
    dev = q.device
    slot = torch.argmin((q.types >= 0).to(_I32)).reshape(1)
    room = q.size < q.capacity
    time = torch.as_tensor(time, dtype=torch.float32, device=dev)
    type_id = torch.as_tensor(type_id, dtype=_I32, device=dev)
    arg = torch.as_tensor(arg, dtype=torch.float32, device=dev)

    def put(col, val):
        old = col.index_select(0, slot)
        return col.index_copy(0, slot, torch.where(room, val, old[0])[None])

    return q._replace(
        times=put(q.times, time), types=put(q.types, type_id),
        args=put(q.args, arg), seqs=put(q.seqs, q.next_seq),
        size=q.size + 1, next_seq=q.next_seq + 1,
        dropped=q.dropped + (~room).to(_I32))


def device_queue_push_rows_serial(q: DeviceQueue, rows) -> DeviceQueue:
    """One :func:`device_queue_push` per valid row (``type < 0`` rows
    are skipped): the executable specification of
    :func:`device_queue_push_rows`, slot placement included."""
    rows = rows.to(torch.float32)
    for i in range(rows.shape[0]):
        ty = i32_sat(rows[i, 1])
        pushed = device_queue_push(q, rows[i, 0], ty, rows[i, 2:])
        q = DeviceQueue(*(torch.where(ty >= 0, new, old)
                          for new, old in zip(pushed, q)))
    return q


def device_queue_push_rows(q: DeviceQueue, rows) -> DeviceQueue:
    """The reference bulk insert as one scatter a column, bit-identical
    to :func:`device_queue_push_rows_serial` including slot placement:
    the row of insert-rank ``r`` lands in the ``r``-th free slot.  Valid
    row ``j`` gets ``seq = next_seq + vrank(j)`` and survives iff ``size
    + vrank(j) < capacity`` (``size`` counts ghosts).  Every destination
    is unique; dropped rows go to the scratch slot past the end."""
    rows = rows.to(torch.float32)
    C = q.capacity
    dev = q.device
    t_r = rows[:, 0].contiguous()
    ty_r = i32_sat(rows[:, 1])
    arg_r = rows[:, 2:].contiguous()
    valid = ty_r >= 0
    vrank = _prefix_rank(valid)
    num_valid = _i32(torch.sum(valid))
    insert = valid & (q.size + vrank < C)
    num_insert = _i32(torch.sum(insert))
    seq_r = q.next_seq + vrank

    # k-th free slot: rank the free slots, invert the ranks by scatter.
    free = q.types < 0
    slot_of_rank = _scatter_rows(
        torch.full((C,), C, dtype=_I32, device=dev),
        torch.where(free, _prefix_rank(free), C), _arange(C, dev))
    irank = _prefix_rank(insert)
    dest = torch.where(insert, _take(slot_of_rank, torch.clamp(irank, 0, C - 1)),
                       C)
    return q._replace(
        times=_scatter_rows(q.times, dest, t_r),
        types=_scatter_rows(q.types, dest, ty_r),
        args=_scatter_rows(q.args, dest, arg_r),
        seqs=_scatter_rows(q.seqs, dest, seq_r),
        size=q.size + num_valid,
        next_seq=q.next_seq + num_valid,
        dropped=q.dropped + (num_valid - num_insert))


def _min_key_slot(q: DeviceQueue):
    """Slot of the occupied lex-min ``(time, seq)`` key, and that time:
    the time minimum, then the first slot of the seq minimum among its
    slots (``argmin`` returns the first index)."""
    occupied = q.types >= 0
    times = torch.where(occupied, q.times, INF)
    tmin = torch.min(times)
    seqs = torch.where(occupied & (times == tmin), q.seqs, I32_MAX)
    return _i32(torch.argmin(seqs)), tmin


def device_queue_peek(q: DeviceQueue):
    """``(time, type, slot)`` of the earliest event; type -1 when
    empty."""
    slot, tmin = _min_key_slot(q)
    empty = q.size <= 0
    t = torch.where(empty, INF, tmin)
    ty = torch.where(empty, -1, _at(q.types, slot))
    return t, ty, slot


def device_queue_pop(q: DeviceQueue):
    """Remove and return the earliest event: ``(q', time, type, arg)``;
    an empty queue returns type -1 and stays as it is."""
    t, ty, slot = device_queue_peek(q)
    arg = _at(q.args, slot)
    take = ty >= 0
    return _pop_slot(q, slot, take), t, ty, arg


def _pop_slot(q: DeviceQueue, slot, take) -> DeviceQueue:
    """Free ``slot`` where ``take`` (a 0-d bool), as a select."""
    idx = slot.reshape(1).long()

    def clear(col, fill):
        old = col.index_select(0, idx)
        return col.index_copy(0, idx, torch.where(take, fill, old))

    return q._replace(times=clear(q.times, INF), types=clear(q.types, -1),
                      seqs=clear(q.seqs, I32_MAX),
                      size=q.size - take.to(_I32))


def device_queue_next_time(q: DeviceQueue) -> torch.Tensor:
    """Earliest pending time under the canonical layout: the head
    slot (the ``inf`` sentinel when empty)."""
    return q.times[0]


def device_queue_next_time_ref(q: DeviceQueue) -> torch.Tensor:
    """Earliest pending time in any layout (O(capacity))."""
    return torch.min(torch.where(q.types >= 0, q.times, INF))


def device_queue_occupancy(q: DeviceQueue) -> torch.Tensor:
    """Number of occupied slots (``size`` also counts ghosts)."""
    return _i32(torch.sum(q.types >= 0))


def device_queue_extract_ref(q: DeviceQueue, max_len: int, lookaheads,
                             t_cap=None):
    """The reference window extraction: ``max_len`` serial peek/pop
    rounds (paper Fig 2 one event at a time), each an O(capacity)
    masked argmin.  JAX's ``lax.cond`` rounds are selects here, so the
    extraction makes no host read.  Returns ``(q', ts, tys, args,
    length)``, zero-padded past ``length``."""
    dev = q.device
    T = lookaheads.shape[0]
    t_max = torch.full((), INF if t_cap is None else _f32(t_cap),
                       dtype=torch.float32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    length = _zero(dev)
    ts, tys, args = [], [], []
    for _ in range(max_len):
        t, ty, slot = device_queue_peek(q)
        take = (~done) & (ty >= 0) & (t <= t_max)
        arg = _at(q.args, slot)
        q = _pop_slot(q, slot, take)
        ts.append(torch.where(take, t, 0.0))
        tys.append(torch.where(take, ty, 0))
        args.append(torch.where(take, arg, 0.0))
        la = _at(lookaheads, torch.clamp(ty, 0, T - 1))
        t_max = torch.where(take, torch.minimum(t_max, t + la), t_max)
        length = length + take.to(_I32)
        done = done | ~take
    return (q, torch.stack(ts), _i32(torch.stack(tys)), torch.stack(args),
            length)


def device_queue_extract(q: DeviceQueue, max_len: int, lookaheads,
                         t_cap=None):
    """Single-pass window extraction over the canonical layout: the
    first ``max_len`` slots are the candidates, the take rule is
    :func:`window_prefix_mask`, and every column shifts left by the
    window's length (O(capacity) a column).  Bit-identical to
    :func:`device_queue_extract_ref`.  Returns ``(q', ts, tys, args,
    length)``."""
    if max_len > q.capacity:
        raise ValueError(
            f"max_len {max_len} exceeds queue capacity {q.capacity}")
    k = max_len
    T = lookaheads.shape[0]
    ts_c, tys_c = q.times[:k], q.types[:k]
    valid = tys_c >= 0
    la = _take(lookaheads, torch.clamp(tys_c, 0, T - 1))
    wins = torch.where(valid, ts_c + la, INF)
    take = window_prefix_mask(ts_c, wins, valid, t_cap)
    length = _i32(torch.sum(take))
    ts = torch.where(take, ts_c, 0.0)
    tys = torch.where(take, tys_c, 0)
    args = torch.where(take[:, None], q.args[:k], 0.0)
    q = q._replace(
        times=shift_left(q.times, INF, length, k),
        types=shift_left(q.types, -1, length, k),
        args=shift_left(q.args, 0.0, length, k),
        seqs=shift_left(q.seqs, I32_MAX, length, k),
        size=q.size - length)
    return q, ts, tys, args, length


def device_queue_fill_rows(q: DeviceQueue, rows) -> DeviceQueue:
    """Bulk emit insert into the canonical layout: the seq and overflow
    rule of :func:`device_queue_push_rows`, then one counting-merge of
    the surviving rows, ordered by ``(time, arrival)``, into the sorted
    columns (row seqs exceed every queued seq, so a row's place is
    searchsorted-right on time, capped at the occupancy)."""
    rows = rows.to(torch.float32)
    R = rows.shape[0]
    C = q.capacity
    dev = q.device
    t_r = rows[:, 0]
    ty_r = i32_sat(rows[:, 1])
    arg_r = rows[:, 2:]
    r_idx = _arange(R, dev)
    valid = ty_r >= 0
    vrank = _prefix_rank(valid)
    num_valid = _i32(torch.sum(valid))
    insert = valid & (q.size + vrank < C)
    num_insert = _i32(torch.sum(insert))
    seq_r = q.next_seq + vrank

    tt = torch.where(insert, t_r, INF)
    perm = _small_lex_perm(tt, torch.where(insert, r_idx, I32_MAX))
    rt, rty, rarg, rseq, rins = (tt[perm], ty_r[perm], arg_r[perm],
                                 seq_r[perm], insert[perm])
    occupancy = device_queue_occupancy(q)
    older = torch.minimum(
        torch.searchsorted(q.times, rt.contiguous(), right=True,
                           out_int32=True), occupancy)
    # Ascending over the sorted rows (C past the inserted ones).
    pos = torch.where(rins, older + r_idx, C)
    i_idx = _arange(C, dev)
    ins_before = torch.searchsorted(pos, i_idx, right=False, out_int32=True)
    is_ins = torch.searchsorted(pos, i_idx, right=True,
                                out_int32=True) > ins_before
    src = torch.where(is_ins, C + torch.clamp(ins_before, 0, R - 1),
                      torch.clamp(i_idx - ins_before, 0, C - 1))

    def merge(col, rcol):
        return _take(torch.cat([col, rcol]), src)

    return q._replace(
        times=merge(q.times, rt), types=merge(q.types, rty),
        args=merge(q.args, rarg), seqs=merge(q.seqs, rseq),
        size=q.size + num_valid, next_seq=q.next_seq + num_valid,
        dropped=q.dropped + (num_valid - num_insert))


def device_queue_to_flat(q: DeviceQueue) -> FlatQueue:
    """Canonical flat view of a flat or reference queue, on the host:
    the occupied slots sorted by ``(time, seq)``."""
    a = queue_to_arrays(q)
    return _flat_view(q.capacity, a["args"].shape[1],
                      [(a["times"], a["types"], a["args"], a["seqs"])], a)


def _flat_view(C, arg_width, parts, counters) -> FlatQueue:
    """The live rows of ``parts`` (column tuples), lex-sorted into a
    ``C``-slot :class:`FlatQueue` with ``counters``' size, next_seq and
    dropped."""
    times, types, args, seqs = (np.concatenate([p[c] for p in parts])
                                for c in range(4))
    occ = types >= 0
    order = np.lexsort((seqs[occ], times[occ]))
    n = int(occ.sum())
    if n > C:
        raise ValueError(
            f"tier occupancy {n} exceeds the logical capacity {C}")
    out_t = np.full((C,), np.inf, np.float32)
    out_y = np.full((C,), -1, np.int32)
    out_a = np.zeros((C, arg_width), np.float32)
    out_s = np.full((C,), I32_MAX, np.int32)
    out_t[:n] = times[occ][order]
    out_y[:n] = types[occ][order]
    out_a[:n] = args[occ][order]
    out_s[:n] = seqs[occ][order]
    return FlatQueue(times=out_t, types=out_y, args=out_a, seqs=out_s,
                     size=int(counters["size"]),
                     next_seq=int(counters["next_seq"]),
                     dropped=int(counters["dropped"]))


# ---------------------------------------------------------------------------
# The two-tier queue: front / staging / main (the ``tiered`` mode)
# ---------------------------------------------------------------------------

class TieredDeviceQueue(NamedTuple):
    """Front / staging / main, field for field the JAX
    ``TieredDeviceQueue``: a sorted front of the earliest events, an
    unsorted staging ring whose ``s_evict`` tags mark the rows evicted
    from the front, and the capacity-sized sorted main ring (live slots
    ``[m_head, m_head + main_n)``; the rest are stale, not cleared).
    Invariant: ``max(front) <= min(staging ∪ main)`` under the lex
    ``(time, seq)`` key."""

    f_times: torch.Tensor   # f32[front_cap]
    f_types: torch.Tensor
    f_args: torch.Tensor
    f_seqs: torch.Tensor
    m_times: torch.Tensor   # f32[capacity]
    m_types: torch.Tensor
    m_args: torch.Tensor
    m_seqs: torch.Tensor
    s_times: torch.Tensor   # f32[stage_cap]
    s_types: torch.Tensor
    s_args: torch.Tensor
    s_seqs: torch.Tensor
    s_evict: torch.Tensor   # bool[stage_cap], True = evicted from front
    front_n: torch.Tensor
    main_n: torch.Tensor
    m_head: torch.Tensor
    stage_n: torch.Tensor
    size: torch.Tensor
    next_seq: torch.Tensor
    dropped: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.m_times.shape[0]

    @property
    def front_cap(self) -> int:
        return self.f_times.shape[0]

    @property
    def stage_cap(self) -> int:
        return self.s_times.shape[0]

    @property
    def device(self) -> torch.device:
        return self.f_times.device


def tiered_queue_init(capacity: int, *, front_cap: int = 256,
                      stage_cap: int = 256, arg_width: int = ARG_WIDTH,
                      device="cpu") -> TieredDeviceQueue:
    front_cap = min(front_cap, capacity)
    ft, fy, fa, fs = _sentinel_cols(front_cap, arg_width, device)
    mt, my, ma, ms = _sentinel_cols(capacity, arg_width, device)
    st, sy, sa, ss = _sentinel_cols(stage_cap, arg_width, device)
    return TieredDeviceQueue(
        f_times=ft, f_types=fy, f_args=fa, f_seqs=fs,
        m_times=mt, m_types=my, m_args=ma, m_seqs=ms,
        s_times=st, s_types=sy, s_args=sa, s_seqs=ss,
        s_evict=torch.zeros((stage_cap,), dtype=torch.bool, device=device),
        front_n=_zero(device), main_n=_zero(device), m_head=_zero(device),
        stage_n=_zero(device), size=_zero(device), next_seq=_zero(device),
        dropped=_zero(device))


def tiered_queue_from_host(events, capacity: int, *, front_cap: int = 256,
                           stage_cap: int = 256, arg_width: int = ARG_WIDTH,
                           device="cpu") -> TieredDeviceQueue:
    """Host-built seed queue, one copy to ``device``: the earliest
    ``front_cap`` events seed the front, the rest the main ring at head
    0; the semantics of N serial pushes (seq ``i``, events past
    ``capacity`` dropped with ``size``/``next_seq`` advancing)."""
    front_cap = min(front_cap, capacity)
    times, types, args, seqs, n, m = _host_sorted_seed(events, capacity,
                                                       arg_width)
    nf = min(m, front_cap)

    def column(n_slots, fill, dtype, src):
        col = np.full((n_slots,) + src.shape[1:], fill, dtype)
        col[:src.shape[0]] = src
        return col

    fields = dict(
        f_times=column(front_cap, np.inf, np.float32, times[:nf]),
        f_types=column(front_cap, -1, np.int32, types[:nf]),
        f_args=column(front_cap, 0, np.float32, args[:nf]),
        f_seqs=column(front_cap, I32_MAX, np.int32, seqs[:nf]),
        m_times=column(capacity, np.inf, np.float32, times[nf:]),
        m_types=column(capacity, -1, np.int32, types[nf:]),
        m_args=column(capacity, 0, np.float32, args[nf:]),
        m_seqs=column(capacity, I32_MAX, np.int32, seqs[nf:]),
        s_times=np.full((stage_cap,), np.inf, np.float32),
        s_types=np.full((stage_cap,), -1, np.int32),
        s_args=np.zeros((stage_cap, arg_width), np.float32),
        s_seqs=np.full((stage_cap,), I32_MAX, np.int32),
        s_evict=np.zeros((stage_cap,), bool),
        front_n=nf, main_n=m - nf, m_head=0, stage_n=0,
        size=n, next_seq=n, dropped=n - m)
    return queue_from_arrays(TieredDeviceQueue, fields, device)


def tiered_queue_has_pending(q: TieredDeviceQueue) -> torch.Tensor:
    """True while any tier holds a real event (``size`` counts ghosts)."""
    return (q.front_n > 0) | (q.stage_n > 0) | (q.main_n > 0)


def tiered_queue_occupancy(q: TieredDeviceQueue) -> torch.Tensor:
    """Number of real pending events across the three tiers."""
    return q.front_n + q.stage_n + q.main_n


def _tiered_main_head_time(q: TieredDeviceQueue) -> torch.Tensor:
    head = _at(q.m_times, torch.clamp(q.m_head, 0, q.capacity - 1))
    return torch.where(q.main_n > 0, head, INF)


def tiered_queue_next_time(q: TieredDeviceQueue) -> torch.Tensor:
    """Earliest pending time: the front head, or with a drained front
    the earlier of staging's minimum and the main head."""
    rest = torch.minimum(torch.min(q.s_times), _tiered_main_head_time(q))
    return torch.where(q.front_n > 0, q.f_times[0], rest)


def _flush_stage(q: TieredDeviceQueue) -> TieredDeviceQueue:
    """Merge the staging ring into the main ring: a tail append when the
    sorted block follows the main tail and fits before the ring's end,
    else the O(capacity) counting-merge of the unrolled ring.  A staged
    row's place among equal-time main rows follows its ``s_evict`` tag:
    an evicted row precedes them (searchsorted-left), a direct row
    follows them (right)."""
    bump("flush")
    S, C = q.stage_cap, q.capacity
    dev = q.device
    perm = _small_lex_perm(q.s_times, q.s_seqs)
    st, sty, sarg, sseq, sev = (q.s_times[perm], q.s_types[perm],
                                q.s_args[perm], q.s_seqs[perm],
                                q.s_evict[perm])
    sval = sty >= 0
    head = torch.where(q.main_n > 0, q.m_head, 0)
    tail = head + q.main_n
    m_last = _at(q.m_times, torch.clamp(tail - 1, 0, C - 1))
    can_append = (((q.main_n == 0) | (st[0] > m_last))
                  & (tail + S <= C))

    def append(q):
        bump("flush_append")
        return q._replace(
            m_times=_update_slice(q.m_times, st, tail),
            m_types=_update_slice(q.m_types, sty, tail),
            m_args=_update_slice(q.m_args, sarg, tail),
            m_seqs=_update_slice(q.m_seqs, sseq, tail),
            m_head=head)

    def merge_all(q):
        bump("flush_merge")
        mt = _ring_unroll(q.m_times, INF, q.m_head, q.main_n)
        my = _ring_unroll(q.m_types, -1, q.m_head, q.main_n)
        ma = _ring_unroll(q.m_args, 0.0, q.m_head, q.main_n)
        ms = _ring_unroll(q.m_seqs, I32_MAX, q.m_head, q.main_n)
        older = torch.where(
            sev, torch.searchsorted(mt, st, right=False, out_int32=True),
            torch.searchsorted(mt, st, right=True, out_int32=True))
        older = torch.minimum(older, q.main_n)
        pos = torch.where(sval, older + _arange(S, dev), C)
        # Insert counts per output slot (a scatter-add histogram; the
        # rows past the end count into a scratch slot), then the
        # exclusive prefix sum places every main row.
        counts = torch.zeros((C + 1,), dtype=_I32, device=dev).index_add_(
            0, pos.long(), torch.ones_like(pos))[:C]
        ins_before = _i32(torch.cumsum(counts, 0)) - counts
        i_idx = _arange(C, dev)
        src = torch.where(counts > 0, C + torch.clamp(ins_before, 0, S - 1),
                          torch.clamp(i_idx - ins_before, 0, C - 1))

        def merge(col, scol):
            return _take(torch.cat([col, scol]), src)

        return q._replace(m_times=merge(mt, st), m_types=merge(my, sty),
                          m_args=merge(ma, sarg), m_seqs=merge(ms, sseq),
                          m_head=torch.zeros_like(q.m_head))

    # A ring smaller than the staging block never appends.
    q = if_else(can_append, append, merge_all, q) if S <= C else merge_all(q)
    et, ey, ea, es = _sentinel_cols(S, q.s_args.shape[1], dev)
    return q._replace(s_times=et, s_types=ey, s_args=ea, s_seqs=es,
                      s_evict=torch.zeros_like(q.s_evict),
                      main_n=q.main_n + q.stage_n,
                      stage_n=torch.zeros_like(q.stage_n))


def _refill_front(q: TieredDeviceQueue) -> TieredDeviceQueue:
    """Flush staging (staged keys may precede the main head), then
    append the main head to the front's occupied prefix."""
    q = cond(q.stage_n > 0, _flush_stage, q)
    return _refill_main_only(q)


def tiered_queue_extract(q: TieredDeviceQueue, max_len: int, lookaheads,
                         t_cap=None):
    """Window extraction from the front tier: the refill when the front
    holds fewer than ``max_len`` events and another tier has some, then
    the take rule and prefix pop in one
    :func:`repro_torch.kernels.queue_front.window_extract` call (the
    same rule over the same front columns as tiered3's).  Returns
    ``(q', ts, tys, args, length)``."""
    if max_len > q.front_cap:
        raise ValueError(
            f"max_len {max_len} exceeds front tier capacity {q.front_cap}")
    from repro_torch.kernels.queue_front import window_extract

    need_refill = (q.front_n < max_len) & ((q.stage_n > 0) | (q.main_n > 0))
    q = cond(need_refill, _refill_front, q)
    ts, tys, args, length, nt, ny, na, ns = window_extract(
        q.f_times, q.f_types, q.f_args, q.f_seqs, lookaheads, t_cap,
        k=max_len)
    q = q._replace(f_times=nt, f_types=ny, f_args=na, f_seqs=ns,
                   front_n=q.front_n - length, size=q.size - length)
    return q, ts, tys, args, length


def tiered_queue_fill_rows(q: TieredDeviceQueue, rows) -> TieredDeviceQueue:
    """Per-batch emit insert touching only the front and staging tiers
    (the front merge is the ``front_merge`` kernel); a staging ring that
    could overflow is flushed into main first.  Row layout ``(time,
    type, arg...)``; ``type < 0`` rows are skipped."""
    rows = rows.to(torch.float32)
    q = cond(preflush_flag(q, rows.shape[0]), _flush_stage, q)
    seq_r, insert, counters = _default_fill_accounting(q, rows)
    b_time = torch.minimum(_tiered_main_head_time(q), torch.min(q.s_times))
    return _tiered_fill_finish(q, rows, b_time, seq_r, insert, counters)


def tiered_queue_to_flat(q: TieredDeviceQueue) -> FlatQueue:
    """Canonical flat view of a two-tier queue, on the host: every live
    event of the three tiers, sorted by ``(time, seq)``."""
    a = queue_to_arrays(q)
    head, main_n = int(a["m_head"]), int(a["main_n"])
    cols = ("times", "types", "args", "seqs")
    parts = [tuple(a[f"f_{c}"] for c in cols),
             tuple(a[f"m_{c}"][head:head + main_n] for c in cols),
             tuple(a[f"s_{c}"] for c in cols)]
    return _flat_view(q.capacity, a["f_args"].shape[1], parts, a)
