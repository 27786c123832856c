"""Sharded device engine: lookahead-synchronized multi-queue execution
(PyTorch port, ``placement="serial"``).

Counterpart of :mod:`repro.core.sharded`.  PARSIR-style conservative
PDES (PAPERS.md) partitions the pending set across ``shards`` per-shard
tiered3 queues; each super-step synchronizes the shards under the
§III-B window, and the run is bit-identical to one tiered3 queue: final
state, the executed ``(time, seq)`` sequence, ``batches``, ``dropped``,
``final_time`` and the residual pending set.  A super-step:

1. **peek** — each shard's ``max_batch_len`` earliest events
   (:func:`~repro_torch.core.queue.tiered3_queue_peek_front`, after the
   bounded refill);
2. **merge** — the ``shards × max_batch_len`` heads lex-ordered by their
   global ``(time, seq)`` keys (all-pairs ranks), and the take rule
   (:func:`~repro_torch.core.queue.window_prefix_mask`) over the first
   ``max_batch_len``: every event among the globally earliest
   ``max_batch_len`` is among its own shard's, so this is exactly the
   single queue's window;
3. **pop** — the take set is a prefix of the merged order, so each
   shard pops a prefix of its own candidates;
4. **dispatch** — the parent's dispatch, verbatim;
5. **exchange** — emitted rows draw seqs from the one global counter and
   the global overflow rule decides the ghosts, both before routing;
   each shard then inserts the rows routed to it with
   :func:`~repro_torch.core.queue.tiered3_queue_fill_rows_tagged`
   (one ``front_merge`` launch a shard).

Host reads.  JAX decides each shard's refill and pre-fill flush with a
``lax.cond``; read naively that is two reads a shard a super-step.  Here
each decision is split into a flag and an apply: the N refill flags are
stacked and read in one host read, and so are the N pre-flush flags;
then only the flagged shards are refilled or flushed, exactly the shards
JAX's conds would take.  A common super-step therefore reads the host
four times at every shard count, as the single queue does: the guard,
the refill flags, the window, the pre-flush flags.

Routing: ``shard_fn(tys, args) -> int tensor`` maps each emitted row to a
shard; the default is ``abs(int32(arg[0]))``, the entity index of
entity-parallel types and the conventional routing slot of emitting ones
(PHOLD's destination LP).  Any routing is correct; results are reduced
with a floor mod, so no row is lost to an out-of-range shard.

The stacked layout (:class:`StackedShardedQueue`: every leaf of the
per-shard queue with a leading shard axis, the global counters scalars)
is ported as data: :func:`stack_sharded_queue`, the
``tiered3_stacked_*`` helpers of :mod:`repro_torch.core.queue`,
:func:`~repro_torch.core.validate.stacked_sharded_fault_bits`, and the
engine's occupancy, fault word and absorb, which take either layout.
``placement="devices"`` (one shard a device, JAX's ``shard_map``), the
only loop that runs on the stacked layout, needs more than one GPU and
is not ported (ROADMAP D1): :func:`place_stacked_queue` and a run on a
stacked queue raise.  Neither is ``overflow="spill"``, which JAX's
sharded engine refuses too.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import validate as _validate
from repro_torch.core.engine import DeviceEngine
from repro_torch.core.events import ARG_WIDTH
from repro_torch.core.queue import (
    FlatQueue,
    I32_MAX,
    INF,
    Tiered3DeviceQueue,
    _flat_view,
    _prefix_rank,
    _restack,
    _small_lex_perm,
    _stacked_shard,
    _take,
    host_list,
    host_read,
    i32_sat,
    preflush_flag,
    tiered3_queue_absorb_rows,
    tiered3_queue_fill_rows_tagged,
    tiered3_queue_from_columns,
    tiered3_queue_has_pending,
    tiered3_queue_next_key,
    tiered3_queue_next_time,
    tiered3_queue_occupancy,
    tiered3_queue_peek_front,
    tiered3_queue_pop_prefix,
    tiered3_queue_refill_flag,
    tiered3_queue_to_flat,
    window_prefix_mask,
)

__all__ = [
    "ShardedDeviceEngine",
    "ShardedQueue",
    "StackedShardedQueue",
    "place_stacked_queue",
    "sharded_queue_to_flat",
    "stack_sharded_queue",
]

_D1 = ("one shard a device, which needs more than one GPU, is not ported "
       "to repro_torch (ROADMAP D1)")


class ShardedQueue(NamedTuple):
    """N per-shard tiered3 queues plus the GLOBAL counters, field for
    field the JAX ``ShardedQueue``: ``size`` counts logical pushes
    including ghosts, ``next_seq`` is the one seq counter every shard
    draws from, ``dropped`` the global ghost count; each shard's own
    ``size`` is its real occupancy and its ``dropped`` stays 0.  The
    logical capacity is the single queue's, and every shard can hold all
    of it, so routing skew never drops an event the single queue
    keeps."""

    shards: tuple
    size: torch.Tensor
    next_seq: torch.Tensor
    dropped: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.shards[0].capacity


def sharded_queue_to_flat(sq: ShardedQueue) -> FlatQueue:
    """Canonical flat view of a sharded queue, on the host: every
    shard's live events sorted by the global ``(time, seq)`` key, with
    the GLOBAL counters, comparable with a single queue's view."""
    parts = []
    for q in sq.shards:
        flat = tiered3_queue_to_flat(q)
        parts.append((flat.times, flat.types, flat.args, flat.seqs))
    return _flat_view(sq.capacity, parts[0][2].shape[1], parts,
                      dict(size=int(sq.size), next_seq=int(sq.next_seq),
                           dropped=int(sq.dropped)))


class StackedShardedQueue(NamedTuple):
    """The sharded pending set in the devices placement's layout: the N
    per-shard tiered3 queues stacked along a leading shard axis (every
    field of ``q`` has shape ``(N, ...)``), the global counters of
    :class:`ShardedQueue` kept as scalars.  ``shards``/``shard(i)``
    give per-shard views, so every consumer written against
    :class:`ShardedQueue` (``sharded_queue_to_flat``, the full audit)
    takes either layout."""

    q: Tiered3DeviceQueue
    size: torch.Tensor
    next_seq: torch.Tensor
    dropped: torch.Tensor

    @property
    def num_shards(self) -> int:
        return int(self.q.f_times.shape[0])

    @property
    def capacity(self) -> int:
        return self.q.capacity

    @property
    def shards(self) -> tuple:
        return tuple(self.shard(i) for i in range(self.num_shards))

    def shard(self, i: int) -> Tiered3DeviceQueue:
        return _stacked_shard(self.q, i)


def stack_sharded_queue(sq: ShardedQueue) -> StackedShardedQueue:
    """Stack a tuple-of-shards queue along a new leading shard axis."""
    return StackedShardedQueue(q=_restack(sq.shards), size=sq.size,
                               next_seq=sq.next_seq, dropped=sq.dropped)


def place_stacked_queue(stq: StackedShardedQueue, mesh=None):
    """JAX places a stacked queue on a ``"shards"`` device mesh, one
    shard slice a device; that needs more than one GPU."""
    raise NotImplementedError(f"place_stacked_queue: {_D1}")


@dataclasses.dataclass
class ShardedDeviceEngine(DeviceEngine):
    """Multi-queue device engine, bit-identical to the single tiered3
    queue.  Preferred entry point: ``SimProgram.build(backend="device",
    shards=N)``.  Every :class:`DeviceEngine` knob applies per shard
    (each shard is a full ``capacity`` tiered3 queue of the same
    geometry); ``queue_mode`` stays ``"tiered3"``."""

    shards: int = 2
    shard_fn: Callable | None = None
    placement: str = "serial"

    def __post_init__(self):
        if self.queue_mode != "tiered3":
            raise ValueError(
                f"ShardedDeviceEngine requires queue_mode='tiered3' "
                f"(got {self.queue_mode!r}): the per-shard pending sets "
                "are tiered3 queues")
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.overflow == "spill":
            raise ValueError(
                "overflow='spill' is not supported on the sharded engine "
                "yet: the spill fence is a single-queue lex bound "
                "(use overflow='drop' or 'error')")
        if self.placement not in ("serial", "devices"):
            raise ValueError(
                f"placement must be 'serial' or 'devices', "
                f"got {self.placement!r}")
        if self.placement == "devices":
            raise NotImplementedError(
                f"placement='devices': {_D1}; use placement='serial'")
        super().__post_init__()

    @classmethod
    def from_program(cls, program, *, shards: int = 2,
                     shard_fn: Callable | None = None,
                     placement: str = "serial", device=None,
                     queue_mode: str = "tiered3",
                     capacity: int | None = None,
                     front_cap: int | None = None,
                     stage_cap: int | None = None,
                     num_runs: int | None = None,
                     dispatch_mode: str = "switch",
                     hot_words=None,
                     validate: str = "off",
                     overflow: str = "drop") -> "ShardedDeviceEngine":
        """The sharded device backend of a frozen SimProgram."""
        cfg = program.config
        return cls(
            program.device_registry(),
            max_batch_len=cfg.max_batch_len,
            capacity=cfg.capacity if capacity is None else capacity,
            max_emit=cfg.max_emit, queue_mode=queue_mode,
            front_cap=front_cap, stage_cap=stage_cap, num_runs=num_runs,
            dispatch_mode=dispatch_mode, hot_words=hot_words,
            validate=validate, overflow=overflow, device=device,
            entity_handlers=program.device_entity_handlers() or None,
            shards=shards, shard_fn=shard_fn, placement=placement,
        )

    # -- routing ------------------------------------------------------------
    def _shard_of(self, tys, args) -> torch.Tensor:
        """Destination shard per row, always in ``[0, shards)``."""
        if self.shard_fn is not None:
            dest = torch.as_tensor(self.shard_fn(tys, args)).to(torch.int32)
        else:
            dest = torch.abs(i32_sat(args[:, 0]))
        return torch.remainder(dest, self.shards).to(torch.int32)

    # -- queue construction -------------------------------------------------
    def initial_queue(self, events) -> ShardedQueue:
        """Partition the seed under the GLOBAL seq and overflow rules:
        event ``i`` keeps seq ``i`` and is a ghost iff ``i >=
        capacity``; THEN the survivors are routed, so the seed equals
        the single queue's whatever the partition."""
        events = list(events)
        n = len(events)
        C = self.capacity
        m = min(n, C)
        times = np.asarray([float(e[0]) for e in events[:m]],
                           np.float32).reshape(m)
        types = np.asarray([e[1] for e in events[:m]], np.int32).reshape(m)
        args = np.zeros((m, ARG_WIDTH), np.float32)
        for i, e in enumerate(events[:m]):
            if e[2] is not None:
                args[i] = np.asarray(e[2], np.float32)
        dest = self._shard_of(torch.from_numpy(types),
                              torch.from_numpy(args)).numpy()
        shard_qs = []
        for s in range(self.shards):
            mine = np.flatnonzero(dest == s).astype(np.int32)
            shard_qs.append(tiered3_queue_from_columns(
                times[mine], types[mine], args[mine], mine, C,
                front_cap=self.front_cap, stage_cap=self.stage_cap,
                num_runs=self.num_runs, device=self.device))

        def scalar(v):
            return torch.tensor(v, dtype=torch.int32, device=self.device)

        return ShardedQueue(shards=tuple(shard_qs), size=scalar(n),
                            next_seq=scalar(n), dropped=scalar(n - m))

    # -- run accounting -----------------------------------------------------
    def queue_occupancy(self, queue) -> torch.Tensor:
        """Real pending events summed across the shards."""
        occ = [tiered3_queue_occupancy(q) for q in queue.shards]
        return torch.sum(torch.stack(occ)).to(torch.int32)

    def _cheap_fault_bits(self, queue) -> torch.Tensor:
        return _validate.sharded_fault_bits(queue)

    def absorb_rows(self, sq, rows, seqs, insert=None):
        """Absorb stream-arrival rows where ``insert`` is set: route them
        like an exchange, absorb each shard's under the full lex key,
        and advance the GLOBAL counters (``size`` by the inserted
        count, ``dropped`` untouched).  The caller guarantees the rows
        fit globally."""
        rows = rows.to(torch.float32)
        seqs = seqs.to(torch.int32)
        valid = rows[:, 1] >= 0
        insert = valid if insert is None else insert & valid
        dest = self._shard_of(i32_sat(rows[:, 1]), rows[:, 2:])
        n_ins = torch.sum(insert).to(torch.int32)
        next_seq = torch.maximum(
            sq.next_seq, torch.max(torch.where(insert, seqs + 1, 0)))
        shard_qs = tuple(
            tiered3_queue_absorb_rows(q, rows, seqs, insert=insert & (dest == i))
            for i, q in enumerate(sq.shards))
        out = ShardedQueue(shards=shard_qs, size=sq.size + n_ins,
                           next_seq=next_seq, dropped=sq.dropped)
        return (stack_sharded_queue(out)
                if isinstance(sq, StackedShardedQueue) else out)

    # -- the loop -----------------------------------------------------------
    def _super_steps(self, state, sq, stats, max_batches, t_end, fenced):
        if isinstance(sq, StackedShardedQueue):
            # JAX runs a stacked queue only under its devices placement.
            raise NotImplementedError(
                f"a run on a StackedShardedQueue: {_D1}; run the "
                "tuple-of-shards ShardedQueue")
        k = self.max_batch_len
        N = self.shards
        T = len(self.registry)
        validate_on = self.validate != "off"
        csrc = torch.repeat_interleave(
            torch.arange(N, dtype=torch.int32, device=self.device), k)
        while stats["batches"] < max_batches:
            qs = list(sq.shards)
            ok = (torch.any(torch.stack(
                [tiered3_queue_has_pending(q) for q in qs]))
                & (torch.min(torch.stack(
                    [tiered3_queue_next_time(q) for q in qs])) <= t_end))
            next_key = None
            if fenced:
                keys = [tiered3_queue_next_key(q) for q in qs]
                kt = torch.stack([t for t, _ in keys])
                ks = torch.stack([s for _, s in keys])
                nk_t = torch.min(kt)
                next_key = (nk_t, torch.min(torch.where(kt == nk_t, ks,
                                                        I32_MAX)))
            if not host_read(self._guard(ok, sq, stats, fenced, next_key)):
                break

            # 1. peek: every shard's refill decision in one read.
            refill = host_list(torch.stack(
                [tiered3_queue_refill_flag(q, k) for q in qs]))
            peeked = [tiered3_queue_peek_front(q, k, refill=r)
                      for q, r in zip(qs, refill)]
            qs = [p[0] for p in peeked]
            cts, ctys, cargs, cseqs = (torch.cat([p[j] for p in peeked])
                                       for j in range(1, 5))

            # 2. merge the N·k heads; the exact global window.
            order = _small_lex_perm(cts, cseqs)[:k]
            ts_c, tys_c, args_c, src_c = (cts[order], ctys[order],
                                          cargs[order], csrc[order])
            valid = tys_c >= 0
            if fenced:
                # Candidates at or past the fence form a suffix of the
                # merged order: the take rule sees the queue end early.
                seqs_c = cseqs[order]
                valid = valid & ((ts_c < stats["bound_t"]) | (
                    (ts_c == stats["bound_t"])
                    & (seqs_c < stats["bound_seq"])))
            la = _take(self._lookaheads, torch.clamp(tys_c, 0, T - 1))
            wins = torch.where(valid, ts_c + la, INF)
            take = window_prefix_mask(ts_c, wins, valid, t_end)
            length = torch.sum(take).to(torch.int32)
            ts = torch.where(take, ts_c, 0.0)
            tys = torch.where(take, tys_c, 0)
            args = torch.where(take[:, None], args_c, 0.0)
            window = host_list(torch.cat([tys, length.reshape(1)]))
            n = window[-1]
            code = self.codec.encode(window[:n]) if n else 0

            # 3. pop each shard's taken prefix.
            qs = [tiered3_queue_pop_prefix(
                      q, torch.sum(take & (src_c == i)).to(torch.int32), k)
                  for i, q in enumerate(qs)]

            # 4. dispatch: the parent's path.
            state, emits = self._dispatch_window(state, ts, args, window[:k],
                                                 n, code)

            # 5. global seq and overflow accounting (the insert-time size
            # is post-extract, as in the single queue).
            ty_r = i32_sat(emits[:, 1])
            valid_r = ty_r >= 0
            vrank = _prefix_rank(valid_r)
            num_valid = torch.sum(valid_r).to(torch.int32)
            size_mid = sq.size - length
            insert = valid_r & (size_mid + vrank < self.capacity)
            num_insert = torch.sum(insert).to(torch.int32)
            seq_r = sq.next_seq + vrank

            # 6. exchange: every shard's pre-flush decision in one read,
            # then each shard inserts the rows routed to it.
            dest = self._shard_of(ty_r, emits[:, 2:])
            flush = host_list(torch.stack(
                [preflush_flag(q, emits.shape[0]) for q in qs]))
            qs = [tiered3_queue_fill_rows_tagged(
                      q, emits, seq_r, insert & (dest == i), flush=f)
                  for i, (q, f) in enumerate(zip(qs, flush))]
            prev_time = stats["time"]
            sq = ShardedQueue(
                shards=tuple(qs), size=size_mid + num_valid,
                next_seq=sq.next_seq + num_valid,
                dropped=sq.dropped + (num_valid - num_insert))
            self._account(stats, ts, emits, n, code, prev_time,
                          self._cheap_fault_bits(sq) if validate_on
                          else None)
        return state, sq
