"""Host-to-device arrival feeding: the double-buffered :class:`StreamFeeder`
(PyTorch port).

The feeder sits between an :class:`~repro_torch.stream.source.ArrivalSource`
and the segment loop of :meth:`repro_torch.core.program.CompiledSim.run`.
A daemon thread pulls blocks from the source, validates them, assigns
seqs from the run's reserved range, and stages each block for the
device: on a CUDA device it fills a pinned host buffer and copies it
with ``non_blocking=True`` on a side stream, recording a CUDA event;
on the CPU it hands the block over as a tensor.  A depth-2 queue holds
the staged blocks, so while the engine runs a segment the next block's
generation and copy overlap with it.  ``prefetch=False`` stages in line.

Stream discipline on the card:

* a pinned buffer is refilled only after the event of its previous
  copy has completed (the thread waits on it), so a copy never reads a
  buffer being overwritten;
* :meth:`StreamFeeder.device_block` makes the consumer's current stream
  wait on the block's event before the absorb reads it, and records the
  device tensors on that stream for the caching allocator.

Determinism: the feeder never decides anything.  Which rows are
admitted, shed or spilled is chosen by the segment loop from the
cursor, the horizon and the queue's occupancy; prefetching only changes
when a block's bytes reach the device, never what they hold.

Seq discipline: the run reserves seqs ``seq0 .. seq0 + len(source)``
upfront by advancing the queue's ``next_seq`` before the first batch,
and the feeder labels row ``j`` with seq ``seq0 + j``, so an arrival
takes exactly the ``(time, seq)`` rank it would have had as the
``j``-th pre-seeded event.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
import warnings

import numpy as np
import torch

from repro_torch.stream.source import EMIT_WIDTH, ArrivalSource

_I32_MAX = 2**31 - 1

#: blocks staged ahead of the consumer: the active block + one standby
_DEPTH = 2
#: pinned staging buffers on a CUDA device: the staged blocks and the one
#: being made
_PINNED = _DEPTH + 1


class StreamFeeder:
    """Cursor-tracking, optionally prefetching view over an arrival source.

    The consumer (the segment loop) sees a flat row stream addressed by
    a global ``cursor`` (row index into the source), block by block:

    - :meth:`next_key` — the ``(time, seq)`` key of the next unconsumed
      arrival, or ``(inf, 2**31-1)`` when exhausted: the admission
      fence;
    - :meth:`admissible` — how many rows of the active block have
      ``time <= t_end``;
    - :meth:`device_block` / :meth:`host_slice` — the staged device
      tensors (for the masked absorb) or a host copy of the next ``k``
      rows (for the spill pool);
    - :meth:`advance` — commit the consumption of ``k`` rows.
    """

    def __init__(self, source: ArrivalSource, seq0: int, *, start: int = 0,
                 prefetch: bool = True, to_device: bool = True,
                 device="cpu"):
        self.source = source
        self.seq0 = int(seq0)
        self.n = len(source)
        if not 0 <= start <= self.n:
            raise ValueError(f"start cursor {start} outside [0, {self.n}]")
        self.cursor = int(start)
        self.prefetch = bool(prefetch)
        self.to_device = bool(to_device)
        self.device = torch.device(device)
        self._cuda = self.to_device and self.device.type == "cuda"
        self._copy_stream = (torch.cuda.Stream(device=self.device)
                             if self._cuda else None)
        self._pinned: list = []      # [(rows, seqs, event or None)]
        self._slot = 0
        self._cur = None  # active block: c0, rows, n [, dev_rows, ...]
        self._off = 0  # rows of the active block already consumed
        self._prod_last_t = -np.inf  # producer-side monotonicity watermark
        self._err = None
        self._stop = threading.Event()
        self._thread = None
        source.seek(self.cursor)
        self._gen = source.blocks()
        self._c0_next = self.cursor  # producer-side index of next block
        if self.prefetch:
            self._q = _queue.Queue(maxsize=_DEPTH)
            self._thread = threading.Thread(
                target=self._pump, name="repro-torch-stream-feeder",
                daemon=True)
            self._thread.start()

    # -- producer side ----------------------------------------------------

    def _stage(self, rows: np.ndarray, seqs: np.ndarray):
        """Device copies of one block: through the next pinned buffer and
        the side stream on a CUDA device; returns ``(rows, seqs,
        event)``."""
        if not self._cuda:
            return torch.from_numpy(rows.copy()), torch.from_numpy(seqs), None
        if len(self._pinned) < _PINNED:
            self._pinned.append((
                torch.empty(rows.shape, dtype=torch.float32, pin_memory=True),
                torch.empty(seqs.shape, dtype=torch.int32, pin_memory=True),
                None))
        h_rows, h_seqs, last = self._pinned[self._slot]
        if last is not None:
            last.synchronize()  # the buffer's previous copy has completed
        h_rows.copy_(torch.from_numpy(rows))
        h_seqs.copy_(torch.from_numpy(seqs))
        with torch.cuda.stream(self._copy_stream):
            d_rows = h_rows.to(self.device, non_blocking=True)
            d_seqs = h_seqs.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        self._pinned[self._slot] = (h_rows, h_seqs, event)
        self._slot = (self._slot + 1) % _PINNED
        return d_rows, d_seqs, event

    def _make_block(self, c0: int, rows: np.ndarray) -> dict:
        rows = np.asarray(rows, np.float32)
        if rows.ndim != 2 or rows.shape[1] != EMIT_WIDTH:
            raise ValueError(
                f"arrival block must be (block, {EMIT_WIDTH}), "
                f"got {rows.shape}")
        n = min(rows.shape[0], self.n - c0)
        if n and not np.all(rows[:n, 1] >= 0):
            raise ValueError(
                "padding (type < 0) row inside the real prefix of an "
                "arrival block — only the tail may be padding")
        if np.any(rows[n:, 1] >= 0):
            raise ValueError(
                f"arrival source produced more than its advertised "
                f"len()={self.n} real rows")
        if n:
            t = rows[:n, 0]
            if t[0] < self._prod_last_t or np.any(np.diff(t) < 0):
                raise ValueError(
                    "arrival times must be nondecreasing within and "
                    "across blocks")
            self._prod_last_t = float(t[n - 1])
        blk = {"c0": int(c0), "rows": rows, "n": int(n)}
        if self.to_device:
            seqs = (self.seq0 + c0
                    + np.arange(rows.shape[0])).astype(np.int32)
            (blk["dev_rows"], blk["dev_seqs"],
             blk["ready"]) = self._stage(np.ascontiguousarray(rows), seqs)
        return blk

    def _next_block_sync(self):
        rows = next(self._gen, None)
        if rows is None:
            return None
        blk = self._make_block(self._c0_next, rows)
        self._c0_next += rows.shape[0]
        return blk

    def _pump(self):
        try:
            while not self._stop.is_set():
                blk = self._next_block_sync()
                while not self._stop.is_set():
                    try:
                        self._q.put(blk, timeout=0.1)
                        break
                    except _queue.Full:
                        continue
                if blk is None:
                    return
        except BaseException as e:  # noqa: BLE001 -- surfaced to consumer
            self._err = e
            while not self._stop.is_set():
                try:
                    self._q.put(None, timeout=0.1)
                    return
                except _queue.Full:
                    continue

    # -- consumer side ----------------------------------------------------

    def _ensure(self):
        """The active block, fetching until it covers ``cursor``."""
        while self._cur is None or self._off >= self._cur["n"]:
            if self.cursor >= self.n:
                return None
            blk = self._q.get() if self.prefetch else self._next_block_sync()
            if blk is None:
                if self._err is not None:
                    err, self._err = self._err, None
                    raise err
                raise ValueError(
                    f"arrival source exhausted at row "
                    f"{self._cur['c0'] + self._cur['n'] if self._cur else 0}"
                    f" but advertised len()={self.n}")
            self._cur = blk
            self._off = self.cursor - blk["c0"]
            if not 0 <= self._off <= blk["rows"].shape[0]:
                raise ValueError(
                    f"arrival block at row {blk['c0']} does not cover "
                    f"cursor {self.cursor}")
        return self._cur

    def has_pending(self) -> bool:
        return self.cursor < self.n

    def next_key(self):
        """``(time, seq)`` key of the next arrival: the admission fence."""
        blk = self._ensure()
        if blk is None:
            return (float("inf"), _I32_MAX)
        return (float(blk["rows"][self._off, 0]), self.seq0 + self.cursor)

    def next_time(self) -> float:
        return self.next_key()[0]

    def admissible(self, t_end: float) -> int:
        """Rows of the active block at or under the horizon."""
        blk = self._ensure()
        if blk is None:
            return 0
        t = blk["rows"][self._off:blk["n"], 0]
        return int(np.searchsorted(t, np.float32(t_end), side="right"))

    def device_block(self):
        """``(dev_rows, dev_seqs, offset)`` of the active block, ready to
        read on the current stream.  The consumer absorbs rows
        ``[offset, offset + k)`` and then calls ``advance(k)``."""
        blk = self._ensure()
        if blk is None or not self.to_device:
            raise RuntimeError("no device-staged arrival block available")
        if blk["ready"] is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(blk["ready"])
            blk["dev_rows"].record_stream(stream)
            blk["dev_seqs"].record_stream(stream)
            blk["ready"] = None
        return blk["dev_rows"], blk["dev_seqs"], self._off

    def host_slice(self, k: int):
        """Host copy of the next ``k`` rows and their seqs (spill pool)."""
        blk = self._ensure()
        if blk is None or k > blk["n"] - self._off:
            raise RuntimeError(f"host_slice({k}) exceeds the active block")
        rows = np.array(blk["rows"][self._off:self._off + k], np.float32)
        seqs = (self.seq0 + self.cursor + np.arange(k)).astype(np.int32)
        return rows, seqs

    def advance(self, k: int) -> None:
        """Commit the consumption (admitted, spilled or shed) of ``k``
        rows."""
        k = int(k)
        if k < 0 or (k > 0 and (self._cur is None
                                or self._off + k > self._cur["n"])):
            raise ValueError(f"advance({k}) outside the active block")
        self.cursor += k
        self._off += k

    def close(self, timeout: float = 5.0) -> None:
        """Stop the pump thread: set the stop event, then alternate short
        joins with queue drains (a producer blocked on ``put`` is freed
        by the drain) until it exits or ``timeout`` elapses; a thread
        still alive then is reported as a ``ResourceWarning``."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is None:
            return
        deadline = time.monotonic() + timeout
        while t.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except _queue.Empty:
                pass
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            t.join(timeout=min(0.05, remaining))
        if t.is_alive():
            warnings.warn(
                f"StreamFeeder pump thread {t.name!r} did not exit "
                f"within {timeout:.1f}s (arrival source blocked?); "
                f"the daemon thread outlives this feeder",
                ResourceWarning, stacklevel=2)

    def __enter__(self) -> "StreamFeeder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
