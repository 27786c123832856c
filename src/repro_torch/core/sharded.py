"""Sharded device engine: lookahead-synchronized multi-queue execution
(PyTorch port), under ``placement="serial"`` and ``"devices"``, with the
eager or the captured loop.

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
``overflow="spill"`` is refused, as JAX's sharded engine refuses it.

``placement="devices"`` (JAX's ``shard_map`` over a 1-D ``"shards"``
mesh, DESIGN.md §12) runs one process a shard over
``torch.distributed``: the caller starts ``shards`` ranks in one default
process group (NCCL on several cards, gloo on the CPU or for several
ranks on one card) and every rank builds the same engine and runs the
same program.  :func:`place_stacked_queue` places the stacked queue as
``DTensor`` leaves, ``Shard(0)`` on the mesh, so each rank holds its own
shard's slice only, and the global counters ``Replicate()``.  Each rank
runs the serial super-step on its own squeezed :class:`~repro_torch.
core.queue.Tiered3DeviceQueue`:

* its own peek (its own refill flag read), then ONE ``all_gather`` of
  the k-row head slabs (``ts``, ``tys``, ``args`` and ``seqs`` packed
  into one int32 slab, so the gather is bit-exact), shard-major, which
  reproduces the serial path's concatenation;
* the merge, the window, the dispatch, the global seq and ghost rule
  and the stats REPLICATED: every rank computes them from the same
  gathered slabs, so they agree bit for bit without another collective;
* its own pop of ``take & (src == my)`` and its own fill of
  ``insert & (dest == my)`` (its own pre-flush flag read);
* ONE more ``all_gather`` of the guard summaries (pending, next time,
  and under the admission fence the head key), from which every rank
  decides the next guard alike: a rank that left the loop alone would
  deadlock the others.  Under ``validate``, one more gather of the
  fault words and occupancies.

So a common super-step reads the host four times a rank, as the serial
path does, and makes two collectives (three validated), counted in
``COUNTS["collectives"]``.  A failed collective is not caught.  The
state is replicated: every rank holds the whole model state.

``loop="captured"`` (:mod:`repro_torch.core.capture`) runs either
placement as the single queue's captured loop does: one super-step
captured as a CUDA graph and replayed ``chunk`` times a host read.

* Serial: JAX's ``while_loop`` body, unrolled per shard, every choice
  on the device.  Each shard's refill and pre-flush are conditional
  nodes of their own (``refill=None``, ``flush=None``, where the eager
  loop reads the N flags in one host read); the merged window is
  encoded and dispatched on the device
  (:meth:`ShardedDeviceEngine._merged_step` with ``on_device``); the
  guard is JAX's ``cond`` over the shards.
* Devices: JAX's ``while_loop`` inside its ``shard_map``.  The carry
  holds the rank's squeezed shard, the replicated counters and the
  gathered guard values (JAX's ``(local_q, g, aux)``).  A replay is the
  peek under ``when(active)``, the heads' gather, the merged step, pop
  and fill under ``when(active)``, the fault words' gather when
  validating, the guards' gather and the new ``active``: every
  collective at the graph's top level, outside every conditional node,
  so every rank replays the same gathers.  A replay past the end gathers
  unchanged buffers that nothing reads; the gathers count each replay
  (2, 3 validated), as many as the eager loop's when a run ends on a
  chunk's end.  On a CUDA device the group must be NCCL's
  (:func:`check_captured_backend`): gloo stages a CUDA collective
  through the host, which a graph cannot capture.  On the CPU the
  step's CPU form runs over any backend.

Segmented runs (checkpoints, streamed arrivals) keep their boundary work
eager (``absorb_rows``, ``place_queue`` on resume, the new fence) and
write its results into the one graph's carry.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import validate as _validate
from repro_torch.core.capture import capturing, cond, write_back
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
    all_gather_rows,
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
    tiered3_stacked_absorb_rows,
    to_local,
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


def sharded_queue_to_flat(sq) -> FlatQueue:
    """Canonical flat view of a sharded queue, on the host: every
    shard's live events sorted by the global ``(time, seq)`` key, with
    the GLOBAL counters, comparable with a single queue's view.  A
    placed queue is gathered first (:meth:`StackedShardedQueue.gathered`),
    a collective: every rank of its mesh calls this."""
    if isinstance(sq, StackedShardedQueue):
        sq = sq.gathered()
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
    takes either layout.

    Placed (:func:`place_stacked_queue`), the leaves are ``DTensor``s:
    each rank holds its own shard's slice of ``q`` and a copy of each
    counter.  Then :meth:`gathered`, ``shards`` and ``shard(i)`` gather
    every rank's slice, a collective that every rank must call."""

    q: Tiered3DeviceQueue
    size: torch.Tensor
    next_seq: torch.Tensor
    dropped: torch.Tensor

    @property
    def placed(self) -> bool:
        return hasattr(self.q.f_times, "device_mesh")

    @property
    def num_shards(self) -> int:
        return int(self.q.f_times.shape[0])

    @property
    def capacity(self) -> int:
        return self.q.capacity

    @property
    def shards(self) -> tuple:
        q = self.gathered().q
        return tuple(_stacked_shard(q, i) for i in range(self.num_shards))

    def shard(self, i: int) -> Tiered3DeviceQueue:
        return _stacked_shard(self.gathered().q, i)

    def gathered(self) -> "StackedShardedQueue":
        """The whole stacked queue on this rank, as plain tensors: every
        leaf of a placed queue gathered from the ranks (one collective a
        leaf, every rank must call it), the counters this rank's copies;
        an unplaced queue as it is."""
        if not self.placed:
            return self
        group = self.q.f_times.device_mesh.get_group("shards")
        return StackedShardedQueue(
            q=self.q._make(all_gather_rows(x.to_local(), group)
                           for x in self.q),
            size=to_local(self.size), next_seq=to_local(self.next_seq),
            dropped=to_local(self.dropped))


def stack_sharded_queue(sq: ShardedQueue) -> StackedShardedQueue:
    """Stack a tuple-of-shards queue along a new leading shard axis."""
    return StackedShardedQueue(q=_restack(sq.shards), size=sq.size,
                               next_seq=sq.next_seq, dropped=sq.dropped)


def _place_local(q: Tiered3DeviceQueue, size, next_seq, dropped,
                 mesh) -> StackedShardedQueue:
    """The placed queue of which this rank holds the squeezed shard
    ``q`` and the global counters' values: no communication."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def rep(c):
        return DTensor.from_local(to_local(c), mesh, [Replicate()],
                                  run_check=False)

    return StackedShardedQueue(
        q=q._make(DTensor.from_local(x[None], mesh, [Shard(0)],
                                     run_check=False) for x in q),
        size=rep(size), next_seq=rep(next_seq), dropped=rep(dropped))


def place_stacked_queue(stq: StackedShardedQueue,
                        mesh) -> StackedShardedQueue:
    """Place a stacked queue on the ``"shards"`` mesh: every leaf of
    ``q`` a ``DTensor`` sharded along the shard axis (``Shard(0)``, JAX's
    ``P("shards")``), so each rank keeps its own shard's slice only, on
    the device of ``stq``'s leaves; the global counters replicated
    (``Replicate()``, JAX's ``P()``).  Every rank calls it with the same
    whole queue.  Also the re-placement hook after a checkpoint restore,
    whose leaves are whole; a placed queue is returned as it is."""
    if stq.placed:
        return stq
    if stq.num_shards != mesh.size():
        raise ValueError(f"a stacked queue of {stq.num_shards} shards on a "
                         f"mesh of {mesh.size()} ranks")
    my = mesh.get_local_rank("shards")
    # clone: the other shards' slices are freed with the whole leaves
    return _place_local(stq.q._make(x[my].clone() for x in stq.q),
                        stq.size, stq.next_seq, stq.dropped, mesh)


class _Counters(NamedTuple):
    """The global counters on a rank, as plain tensors (the loop's view
    of a placed queue's replicated counters)."""

    size: torch.Tensor
    next_seq: torch.Tensor
    dropped: torch.Tensor


@dataclasses.dataclass
class ShardedDeviceEngine(DeviceEngine):
    """Multi-queue device engine, bit-identical to the single tiered3
    queue.  Preferred entry point: ``SimProgram.build(backend="device",
    shards=N)``.  Every :class:`DeviceEngine` knob applies per shard
    (each shard is a full ``capacity`` tiered3 queue of the same
    geometry); ``queue_mode`` stays ``"tiered3"``.

    ``placement="devices"`` needs a default process group of exactly
    ``shards`` ranks (:func:`repro_torch.launch.mesh.make_shard_mesh`);
    every rank builds the engine and calls each of its methods alike.
    ``device=None`` is then the rank's card
    (:func:`~repro_torch.launch.mesh.shard_device`).  ``loop="captured"``
    runs under either placement (module docstring); on a card the
    devices placement's group must be NCCL's."""

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
        self._mesh = None
        if self.placement == "devices":
            from repro_torch.launch.mesh import make_shard_mesh, shard_device

            self._mesh = make_shard_mesh(self.shards, device=self.device)
            self.device = shard_device(self.device)
            self._rank = self._mesh.get_local_rank("shards")
            self._group = self._mesh.get_group("shards")
            if self.loop == "captured":
                import torch.distributed as dist

                check_captured_backend(self.device,
                                       dist.get_backend(self._group))
                # NCCL's watchdog thread queries its events while the
                # step is captured: only this thread's calls are held
                # to the capture's rules.
                self.capture_mode = "thread_local"
        super().__post_init__()
        # Each head's shard, shard-major (made here: repeat_interleave
        # is refused inside a captured step).
        self._csrc = torch.repeat_interleave(
            torch.arange(self.shards, dtype=torch.int32, device=self.device),
            self.max_batch_len)

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
                     overflow: str = "drop",
                     loop: str = "eager") -> "ShardedDeviceEngine":
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
            loop=loop,
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
    def initial_queue(self, events):
        """Partition the seed under the GLOBAL seq and overflow rules:
        event ``i`` keeps seq ``i`` and is a ghost iff ``i >=
        capacity``; THEN the survivors are routed, so the seed equals
        the single queue's whatever the partition.  Under
        ``placement="devices"`` each rank builds its own shard only and
        returns the placed :class:`StackedShardedQueue`."""
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

        def shard_queue(s):
            mine = np.flatnonzero(dest == s).astype(np.int32)
            return tiered3_queue_from_columns(
                times[mine], types[mine], args[mine], mine, C,
                front_cap=self.front_cap, stage_cap=self.stage_cap,
                num_runs=self.num_runs, device=self.device)

        def scalar(v):
            return torch.tensor(v, dtype=torch.int32, device=self.device)

        if self._mesh is not None:
            return _place_local(shard_queue(self._rank), scalar(n),
                                scalar(n), scalar(n - m), self._mesh)
        return ShardedQueue(
            shards=tuple(shard_queue(s) for s in range(self.shards)),
            size=scalar(n), next_seq=scalar(n), dropped=scalar(n - m))

    def place_queue(self, queue):
        """Re-place a queue on this engine's mesh (a restored
        checkpoint's leaves are whole, on the rank's device); any other
        queue as it is."""
        if self._mesh is not None and isinstance(queue, StackedShardedQueue):
            return place_stacked_queue(queue, self._mesh)
        return queue

    # -- run accounting -----------------------------------------------------
    def _shard_summary(self, queue, fn) -> torch.Tensor:
        """``fn`` of every shard's queue, stacked in shard order: a
        placed queue's from one gather of each rank's own."""
        if isinstance(queue, StackedShardedQueue):
            vals = fn(queue.q._make(to_local(x) for x in queue.q))
            if queue.placed:
                vals = all_gather_rows(vals, self._group)
            return vals
        return torch.stack([fn(q) for q in queue.shards])

    def queue_occupancy(self, queue) -> torch.Tensor:
        """Real pending events summed across the shards (a placed
        queue's from one gather: every rank calls it)."""
        return torch.sum(self._shard_summary(
            queue, tiered3_queue_occupancy)).to(torch.int32)

    def queue_next_time(self, queue) -> torch.Tensor:
        """The earliest pending timestamp across the shards (a placed
        queue's from one gather)."""
        return torch.min(self._shard_summary(queue, tiered3_queue_next_time))

    def _cheap_fault_bits(self, queue) -> torch.Tensor:
        if isinstance(queue, StackedShardedQueue):
            return _validate.stacked_sharded_fault_bits(queue)
        return _validate.sharded_fault_bits(queue)

    def absorb_rows(self, sq, rows, seqs, insert=None):
        """Absorb stream-arrival rows where ``insert`` is set: route them
        like an exchange, absorb each shard's under the full lex key,
        and advance the GLOBAL counters (``size`` by the inserted
        count, ``dropped`` untouched).  On a placed queue each rank
        absorbs the rows routed to it into its own shard.  The caller
        guarantees the rows fit globally."""
        rows = rows.to(torch.float32)
        seqs = seqs.to(torch.int32)
        valid = rows[:, 1] >= 0
        insert = valid if insert is None else insert & valid
        dest = self._shard_of(i32_sat(rows[:, 1]), rows[:, 2:])
        size = to_local(sq.size) + torch.sum(insert).to(torch.int32)
        next_seq = torch.maximum(to_local(sq.next_seq),
                                 torch.max(torch.where(insert, seqs + 1, 0)))
        dropped = to_local(sq.dropped)
        if not isinstance(sq, StackedShardedQueue):
            return ShardedQueue(
                shards=tuple(tiered3_queue_absorb_rows(
                    q, rows, seqs, insert=insert & (dest == i))
                    for i, q in enumerate(sq.shards)),
                size=size, next_seq=next_seq, dropped=dropped)
        if sq.placed:
            q = tiered3_queue_absorb_rows(
                _squeeze(sq.q), rows, seqs,
                insert=insert & (dest == self._rank))
            return _place_local(q, size, next_seq, dropped, self._mesh)
        shard_ids = torch.arange(sq.num_shards, dtype=torch.int32,
                                 device=dest.device)
        return StackedShardedQueue(
            q=tiered3_stacked_absorb_rows(
                sq.q, rows, seqs,
                insert[None, :] & (dest[None, :] == shard_ids[:, None])),
            size=size, next_seq=next_seq, dropped=dropped)

    # -- the loops ----------------------------------------------------------
    def _merged_step(self, state, heads, csrc, g, stats, t_end, fenced, *,
                     on_device=False):
        """The global part of a super-step, alike under both placements:
        the merge of the shards' ``N·k`` heads (``heads``: times, types,
        args and seqs, shard-major; ``csrc`` their shards) and the exact
        global window, the dispatch, and the global seq and overflow
        accounting against the counters ``g``.  The eager loop reads the
        window to the host once and dispatches there; ``on_device`` (the
        captured step) encodes and dispatches on the device
        (:meth:`_dispatch_window_device`).  Returns ``(state, emits, ts,
        n, code, popped, routed, seq_r, g')``: ``n`` the window's length
        (a host int, or a device scalar ``on_device``), ``popped`` the
        shard of each taken candidate (else -1), ``routed`` the
        destination of each inserted row (else -1), ``g'`` the counters
        after the super-step."""
        k = self.max_batch_len
        T = len(self.registry)
        cts, ctys, cargs, cseqs = heads
        # 2. merge the N·k heads; the exact global window.
        order = _small_lex_perm(cts, cseqs)[:k]
        ts_c, tys_c, args_c, src_c = (cts[order], ctys[order],
                                      cargs[order], csrc[order])
        valid = tys_c >= 0
        if fenced:
            # Candidates at or past the fence form a suffix of the merged
            # order: the take rule sees the queue end early.
            seqs_c = cseqs[order]
            valid = valid & ((ts_c < stats["bound_t"]) | (
                (ts_c == stats["bound_t"]) & (seqs_c < stats["bound_seq"])))
        la = _take(self._lookaheads, torch.clamp(tys_c, 0, T - 1))
        wins = torch.where(valid, ts_c + la, INF)
        take = window_prefix_mask(ts_c, wins, valid, t_end)
        length = torch.sum(take).to(torch.int32)
        ts = torch.where(take, ts_c, 0.0)
        tys = torch.where(take, tys_c, 0)
        args = torch.where(take[:, None], args_c, 0.0)

        # 4. dispatch: the parent's path.
        if on_device:
            n = length
            code = self._code_device(tys, length)
            state, emits = self._dispatch_window_device(state, ts, tys, args,
                                                        length, code)
        else:
            window = host_list(torch.cat([tys, length.reshape(1)]))
            n = window[-1]
            code = self.codec.encode(window[:n]) if n else 0
            state, emits = self._dispatch_window(state, ts, args, window[:k],
                                                 n, code)

        # 5. global seq and overflow accounting (the insert-time size is
        # post-extract, as in the single queue), then the routing.
        ty_r = i32_sat(emits[:, 1])
        valid_r = ty_r >= 0
        vrank = _prefix_rank(valid_r)
        num_valid = torch.sum(valid_r).to(torch.int32)
        size_mid = g.size - length
        insert = valid_r & (size_mid + vrank < self.capacity)
        num_insert = torch.sum(insert).to(torch.int32)
        dest = self._shard_of(ty_r, emits[:, 2:])
        return (state, emits, ts, n, code, torch.where(take, src_c, -1),
                torch.where(insert, dest, -1), g.next_seq + vrank,
                _Counters(size_mid + num_valid, g.next_seq + num_valid,
                          g.dropped + (num_valid - num_insert)))

    def _serial_guard(self, qs, fenced):
        """The serial loop's guard terms over the shards ``qs``:
        ``(pending, next_time, next_key)``, the key (the global head
        ``(time, seq)``) only when ``fenced``."""
        pending = torch.any(torch.stack(
            [tiered3_queue_has_pending(q) for q in qs]))
        next_t = torch.min(torch.stack(
            [tiered3_queue_next_time(q) for q in qs]))
        next_key = None
        if fenced:
            keys = [tiered3_queue_next_key(q) for q in qs]
            kt = torch.stack([t for t, _ in keys])
            ks = torch.stack([s for _, s in keys])
            nk_t = torch.min(kt)
            next_key = (nk_t, torch.min(torch.where(kt == nk_t, ks,
                                                    I32_MAX)))
        return pending, next_t, next_key

    def _super_steps(self, state, sq, stats, max_batches, t_end, fenced):
        if self._mesh is not None:
            return self._super_steps_devices(state, sq, stats, max_batches,
                                             t_end, fenced)
        _refuse_stacked(sq)
        k = self.max_batch_len
        validate_on = self.validate != "off"
        while stats["batches"] < max_batches:
            qs = list(sq.shards)
            pending, next_t, next_key = self._serial_guard(qs, fenced)
            ok = pending & (next_t <= t_end)
            if not host_read(self._guard(ok, sq, stats, fenced, next_key)):
                break

            # 1. peek: every shard's refill decision in one read.
            refill = host_list(torch.stack(
                [tiered3_queue_refill_flag(q, k) for q in qs]))
            peeked = [tiered3_queue_peek_front(q, k, refill=r)
                      for q, r in zip(qs, refill)]
            qs = [p[0] for p in peeked]
            heads = tuple(torch.cat([p[j] for p in peeked])
                          for j in range(1, 5))
            prev_time = stats["time"]
            (state, emits, ts, n, code, popped, routed, seq_r,
             g) = self._merged_step(state, heads, self._csrc, sq, stats,
                                    t_end, fenced)

            # 3. pop each shard's taken prefix.
            qs = [tiered3_queue_pop_prefix(
                      q, torch.sum(popped == i).to(torch.int32), k)
                  for i, q in enumerate(qs)]

            # 6. exchange: every shard's pre-flush decision in one read,
            # then each shard inserts the rows routed to it.
            flush = host_list(torch.stack(
                [preflush_flag(q, emits.shape[0]) for q in qs]))
            qs = [tiered3_queue_fill_rows_tagged(
                      q, emits, seq_r, routed == i, flush=f)
                  for i, (q, f) in enumerate(zip(qs, flush))]
            sq = ShardedQueue(tuple(qs), *g)
            self._account(stats, ts, emits, n, code, prev_time,
                          self._cheap_fault_bits(sq) if validate_on
                          else None)
        return state, sq

    # -- the captured loop --------------------------------------------------
    def _carry_queue(self, queue, stats):
        """Serial: the tuple-of-shards queue.  Devices (JAX's
        ``shard_map`` carry ``(local_q, g, aux)``): this rank's squeezed
        shard ``q``, the replicated counters ``g`` and the guard values
        ``aux`` of one gather."""
        if self._mesh is None:
            _refuse_stacked(queue)
            return queue
        stq = self.place_queue(queue)
        q = _squeeze(stq.q)
        return {"q": q,
                "g": _Counters(to_local(stq.size), to_local(stq.next_seq),
                               to_local(stq.dropped)),
                "aux": self._gather_guards(q, "bound_t" in stats)}

    def _queue_of_carry(self, queue):
        if self._mesh is None:
            return queue
        return _place_local(queue["q"], *queue["g"], self._mesh)

    def _active(self, queue, stats, max_batches, t_end):
        """JAX's ``cond`` on the device: the serial loop's guard over
        the shards, or the devices placement's over the gathered
        ``aux`` (replicated, so every rank leaves on the same read)."""
        fenced = "bound_t" in stats
        if self._mesh is None:
            pending, next_t, next_key = self._serial_guard(queue.shards,
                                                           fenced)
            counters = queue
        else:
            aux = queue["aux"]
            pending, next_t, next_key = (aux["pending"], aux["next_t"],
                                         aux.get("key"))
            counters = queue["g"]
        ok = (pending & (next_t <= t_end)
              & (stats["batches"] < max_batches))
        return self._guard(ok, counters, stats, fenced, next_key)

    def _step_body(self, carry, t_end):
        if self._mesh is not None:
            return self._rank_step(carry, t_end, torch.ones(
                (), dtype=torch.bool, device=self.device))
        # JAX's unrolled per-shard body: each shard's refill and
        # pre-flush are conditional nodes of their own (refill=None,
        # flush=None).
        k = self.max_batch_len
        state, sq = carry["state"], carry["queue"]
        stats = dict(carry["stats"])
        fenced = "bound_t" in stats
        peeked = [tiered3_queue_peek_front(q, k) for q in sq.shards]
        qs = [p[0] for p in peeked]
        heads = tuple(torch.cat([p[j] for p in peeked]) for j in range(1, 5))
        prev_time = stats["time"]
        (state, emits, ts, length, code, popped, routed, seq_r,
         g) = self._merged_step(state, heads, self._csrc, sq, stats, t_end,
                                fenced, on_device=True)
        qs = [tiered3_queue_pop_prefix(
                  q, torch.sum(popped == i).to(torch.int32), k)
              for i, q in enumerate(qs)]
        qs = [tiered3_queue_fill_rows_tagged(q, emits, seq_r, routed == i)
              for i, q in enumerate(qs)]
        sq = ShardedQueue(tuple(qs), *g)
        self._account_device(stats, ts, emits, length, code, prev_time,
                             self._cheap_fault_bits(sq)
                             if self.validate != "off" else None)
        return {"state": state, "queue": sq, "stats": stats,
                "active": self._active(sq, stats, carry["max_batches"],
                                       t_end),
                "max_batches": carry["max_batches"]}

    def _step_captured(self, carry, t_end):
        if self._mesh is None:
            return super()._step_captured(carry, t_end)
        return self._rank_step(carry, t_end, carry["active"])

    def _rank_step(self, carry, t_end, active):
        """One captured super-step of this rank (JAX's ``_run_devices``
        body), every collective at the graph's top level, outside every
        conditional node: the peek under ``when(active)``, the heads'
        gather, the merged step, pop and fill under ``when(active)``,
        the fault words' gather when validating, the guards' gather and
        the new ``active``.  ``active`` is replicated, so every rank
        replays the same gathers; past the end they gather unchanged
        buffers that nothing reads, and the step is an exact no-op."""
        k = self.max_batch_len
        my = self._rank
        fenced = "bound_t" in carry["stats"]
        cq = carry["queue"]
        q = cond(active, lambda q: tiered3_queue_peek_front(q, k)[0],
                 cq["q"])
        heads = self._gather_heads(q.f_times[:k], q.f_types[:k],
                                   q.f_args[:k], q.f_seqs[:k])

        def body(c):
            q, g = c["queue"]["q"], c["queue"]["g"]
            stats = dict(c["stats"])
            prev_time = stats["time"]
            (state, emits, ts, length, code, popped, routed, seq_r,
             g) = self._merged_step(c["state"], heads, self._csrc, g, stats,
                                    t_end, fenced, on_device=True)
            q = tiered3_queue_pop_prefix(
                q, torch.sum(popped == my).to(torch.int32), k)
            q = tiered3_queue_fill_rows_tagged(q, emits, seq_r, routed == my)
            # The clock bit here; the queue's bits after the gather.
            self._account_device(
                stats, ts, emits, length, code, prev_time,
                torch.zeros((), dtype=torch.int32, device=ts.device)
                if self.validate != "off" else None)
            return dict(c, state=state, stats=stats,
                        queue=dict(c["queue"], q=q, g=g))

        c = cond(active, body, dict(carry, queue=dict(cq, q=q)))
        q, g = c["queue"]["q"], c["queue"]["g"]
        stats = dict(c["stats"])
        if self.validate != "off":
            bits = _validate.rank_fault_bits([q], g.size, g.dropped,
                                             self._group)
            stats["fault_word"] = torch.where(
                active, stats["fault_word"] | bits, stats["fault_word"])
        queue = dict(c["queue"], aux=self._gather_guards(q, fenced))
        out = dict(c, queue=queue, stats=stats,
                   active=active & self._active(queue, stats,
                                                carry["max_batches"], t_end))
        if capturing():
            write_back(carry, out)
            return carry
        return out

    # -- the loop, placement="devices" --------------------------------------
    def _gather_guards(self, q, fenced) -> dict:
        """The replicated guard values from ONE gather of every rank's
        summary (pending, next time, under the fence the head key),
        packed bit for bit into int32."""
        cols = [tiered3_queue_has_pending(q).to(torch.int32),
                tiered3_queue_next_time(q).reshape(1).view(torch.int32)[0]]
        if fenced:
            kt, ks = tiered3_queue_next_key(q)
            cols += [kt.reshape(1).view(torch.int32)[0], ks.to(torch.int32)]
        rows = all_gather_rows(torch.stack(cols)[None], self._group)
        out = {"pending": torch.any(rows[:, 0] != 0),
               "next_t": torch.min(rows[:, 1].contiguous().view(
                   torch.float32))}
        if fenced:
            kt = rows[:, 2].contiguous().view(torch.float32)
            nk_t = torch.min(kt)
            out["key"] = (nk_t, torch.min(torch.where(kt == nk_t, rows[:, 3],
                                                      I32_MAX)))
        return out

    def _gather_heads(self, ts, tys, args, seqs):
        """Every rank's k-row head slab in shard-major order (the serial
        path's concatenation) from ONE gather of an int32 slab
        ``[ts | tys | seqs | args]``, bit for bit."""
        slab = torch.cat([ts.view(torch.int32)[:, None], tys[:, None],
                          seqs[:, None], args.view(torch.int32)], dim=1)
        rows = all_gather_rows(slab, self._group)
        return (rows[:, 0].contiguous().view(torch.float32), rows[:, 1],
                rows[:, 3:].contiguous().view(torch.float32),
                rows[:, 2].contiguous())

    def _super_steps_devices(self, state, stq, stats, max_batches, t_end,
                             fenced):
        """The serial super-step, each rank on its own shard (module
        docstring): the peek, pop and fill on the rank's squeezed queue,
        everything global replicated from two gathers a super-step.
        Every rank leaves the loop on the same replicated guard."""
        k = self.max_batch_len
        my = self._rank
        validate_on = self.validate != "off"
        stq = self.place_queue(stq)
        q = _squeeze(stq.q)
        g = _Counters(to_local(stq.size), to_local(stq.next_seq),
                      to_local(stq.dropped))
        aux = self._gather_guards(q, fenced)
        while stats["batches"] < max_batches:
            ok = aux["pending"] & (aux["next_t"] <= t_end)
            if not host_read(self._guard(ok, g, stats, fenced,
                                         aux.get("key"))):
                break

            # 1. my peek, then every rank's head slab.
            q, *heads = tiered3_queue_peek_front(
                q, k, refill=host_read(tiered3_queue_refill_flag(q, k)))
            prev_time = stats["time"]
            (state, emits, ts, n, code, popped, routed, seq_r,
             g) = self._merged_step(state, self._gather_heads(*heads),
                                    self._csrc, g, stats, t_end, fenced)

            # 3. pop my taken prefix; 6. fill the rows routed to me, after
            # my pre-flush read.
            q = tiered3_queue_pop_prefix(
                q, torch.sum(popped == my).to(torch.int32), k)
            q = tiered3_queue_fill_rows_tagged(
                q, emits, seq_r, routed == my,
                flush=host_read(preflush_flag(q, emits.shape[0])))
            self._account(stats, ts, emits, n, code, prev_time,
                          _validate.rank_fault_bits([q], g.size, g.dropped,
                                                    self._group)
                          if validate_on else None)
            aux = self._gather_guards(q, fenced)
        return state, _place_local(q, *g, self._mesh)


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def check_captured_backend(device, backend: str) -> None:
    """``loop="captured"`` under ``placement="devices"`` on a CUDA
    device needs an NCCL group: gloo (or any other backend) stages a
    CUDA collective through the host, which a CUDA graph cannot
    capture.  Raises :class:`ValueError` naming ``backend``; on the CPU
    any backend runs the captured loop's CPU form."""
    if _on_card(device) and backend != "nccl":
        raise ValueError(
            "loop='captured' with placement='devices' on a CUDA device "
            f"needs an NCCL process group, got backend {backend!r}: it "
            "stages CUDA collectives through the host, and a CUDA graph "
            "cannot capture that (build with loop='eager', or run the "
            "ranks over NCCL, one card a rank)")


def _refuse_stacked(queue) -> None:
    if isinstance(queue, StackedShardedQueue):
        # JAX runs a stacked queue only under its devices placement.
        raise ValueError(
            "a StackedShardedQueue runs under placement='devices'; "
            "run the tuple-of-shards ShardedQueue on this engine")


def _squeeze(q: Tiered3DeviceQueue) -> Tiered3DeviceQueue:
    """This rank's shard of a placed stacked queue, leading extent
    squeezed: a plain per-shard queue."""
    return q._make(x.to_local()[0] for x in q)
