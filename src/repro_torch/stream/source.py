"""Arrival sources: deterministic host-side generators of arrival blocks
(PyTorch port).

The port's copy of :mod:`repro.stream.source`: the same generators draw
the same numpy streams, so for one seed every block is byte-identical
to the JAX package's, and the trace files are the same bytes.

An :class:`ArrivalSource` yields fixed-size blocks of arrival rows in
the portable emit-row layout (``(time, type, arg0..arg3)``, float32,
width ``EMIT_WIDTH``) with **host-assigned arrival times**.  Rows with
``type < 0`` are padding; real rows must carry nondecreasing times
within and across blocks — the feeder enforces this at consume time.

All sources are seeded and fully deterministic: iterating ``blocks()``
twice, or regenerating after :meth:`ArrivalSource.seek`, reproduces the
identical rows bit-for-bit.  Determinism is what lets checkpoint/resume
store only a row *cursor* instead of buffered arrival data, and what
makes the closed-vs-open equivalence tests meaningful.

Synthetic generators:

- :class:`PoissonSource` — homogeneous Poisson arrivals (exp gaps).
- :class:`BurstySource` — on/off modulated Poisson (bursts of
  ``burst_len`` closely spaced arrivals separated by idle gaps).
- :class:`DiurnalSource` — sinusoidally rate-modulated arrivals
  (a "time-of-day" curve).

All three support ``grid=`` quantization: arrival times snap to
multiples of a grid step while staying strictly increasing, which keeps
float32 arithmetic exact when a scenario's event times live on the same
grid (the serving admission scenario uses a 0.25 grid).

Bounded-memory traces: :class:`TraceWriter` streams blocks to disk,
:class:`TraceReader` replays them block-at-a-time via ``np.fromfile``
with an explicit offset — memory use is one block regardless of trace
length.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Iterator, Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.events import ARG_WIDTH

EMIT_WIDTH = 2 + ARG_WIDTH

#: default rows per arrival block (one host→device transfer + absorb)
DEFAULT_BLOCK = 256


def _pad_block(rows: np.ndarray, block_size: int) -> np.ndarray:
    """Pad a partial block to ``block_size`` rows with type=-1 rows."""
    n = rows.shape[0]
    if n == block_size:
        return rows
    out = np.zeros((block_size, EMIT_WIDTH), np.float32)
    out[:, 1] = -1.0
    out[:n] = rows
    return out


@runtime_checkable
class ArrivalSource(Protocol):
    """Protocol for arrival streams consumed by ``run(arrivals=...)``.

    ``blocks()`` returns a *fresh* iterator over fixed-size float32
    blocks of shape ``(block_size, EMIT_WIDTH)``; rows with ``type < 0``
    are padding (only the final block may be partial).  ``len(source)``
    is the total number of real arrival rows.  ``seek(cursor)`` makes
    the next ``blocks()`` iterator start at row ``cursor`` (block-
    aligned padding applies from there) — used by checkpoint resume.
    """

    block_size: int

    def __len__(self) -> int: ...

    def blocks(self) -> Iterator[np.ndarray]: ...

    def seek(self, cursor: int) -> None: ...


class _SyntheticSource:
    """Shared machinery for seeded synthetic generators.

    Subclasses implement ``_gaps(rng, idx0, m, carry)`` drawing the
    inter-arrival gaps for rows ``idx0..idx0+m`` from a single
    sequential RNG stream; the base class turns gaps into nondecreasing
    float32 times (optionally grid-quantized), fills args, and chunks
    into fixed blocks.  Generation is block-at-a-time — memory use is
    O(block_size) regardless of ``n``, so a million-row trace streams
    straight to disk.  ``seek`` regenerates from row 0 and discards —
    O(cursor) work, but always in block-sized vectorized numpy.
    Chunking is identical on every iteration (full blocks from row 0),
    so the generated rows are bit-reproducible regardless of how the
    RNG's draws are consumed.
    """

    def __init__(
        self,
        n: int,
        seed: int = 0,
        t0: float = 0.0,
        type_id: int = 0,
        block_size: int = DEFAULT_BLOCK,
        grid: Optional[float] = None,
        arg_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ):
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        if block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        if grid is not None and grid <= 0:
            raise ValueError(f"grid must be positive, got {grid}")
        self.n = int(n)
        self.seed = int(seed)
        self.t0 = float(t0)
        self.type_id = int(type_id)
        self.block_size = int(block_size)
        self.grid = None if grid is None else float(grid)
        self.arg_fn = arg_fn
        self._cursor = 0

    def __len__(self) -> int:
        return self.n

    def seek(self, cursor: int) -> None:
        if not 0 <= cursor <= self.n:
            raise ValueError(f"cursor {cursor} outside [0, {self.n}]")
        self._cursor = int(cursor)

    def _init_carry(self):
        return None

    def _gaps(self, rng: np.random.Generator, idx0: int, m: int, carry):
        """Return ``(gaps, carry)`` for global rows ``idx0..idx0+m``."""
        raise NotImplementedError

    def _iter_rows(self) -> Iterator[np.ndarray]:
        """Yield real rows in block-sized chunks, starting at row 0.

        Times accumulate in float64 across chunks (cast to float32 per
        row), or on an exact int64 grid index when ``grid`` is set:
        each gap quantizes to >= 1 grid step, so grid times are
        float32-exact multiples and strictly increasing.
        """
        rng = np.random.default_rng(self.seed)
        carry = self._init_carry()
        idx_acc = np.int64(0)
        t_acc = float(self.t0)
        bs = self.block_size
        produced = 0
        while produced < self.n:
            m = min(bs, self.n - produced)
            gaps, carry = self._gaps(rng, produced, m, carry)
            gaps = np.asarray(gaps, np.float64)
            if self.grid is not None:
                steps = np.maximum(1, np.rint(gaps / self.grid).astype(np.int64))
                idx = idx_acc + np.cumsum(steps)
                idx_acc = idx[-1]
                t = np.float32(self.t0) + (idx * self.grid).astype(np.float32)
            else:
                acc = t_acc + np.cumsum(gaps)
                t_acc = float(acc[-1])
                t = acc.astype(np.float32)
            rows = np.zeros((m, EMIT_WIDTH), np.float32)
            rows[:, 0] = t
            rows[:, 1] = np.float32(self.type_id)
            gidx = produced + np.arange(m, dtype=np.int64)
            if self.arg_fn is not None:
                args = np.asarray(self.arg_fn(gidx), np.float32)
                if args.shape != (m, ARG_WIDTH):
                    raise ValueError(
                        f"arg_fn must return shape ({m}, {ARG_WIDTH}), "
                        f"got {args.shape}"
                    )
                rows[:, 2:] = args
            else:
                rows[:, 2] = gidx.astype(np.float32)
            yield rows
            produced += m

    def blocks(self) -> Iterator[np.ndarray]:
        bs = self.block_size
        skip = self._cursor
        buf = np.zeros((0, EMIT_WIDTH), np.float32)
        for chunk in self._iter_rows():
            if skip >= chunk.shape[0]:
                skip -= chunk.shape[0]
                continue
            if skip:
                chunk = chunk[skip:]
                skip = 0
            buf = chunk if buf.shape[0] == 0 else np.concatenate([buf, chunk])
            while buf.shape[0] >= bs:
                yield np.ascontiguousarray(buf[:bs])
                buf = buf[bs:]
        if buf.shape[0]:
            yield _pad_block(np.ascontiguousarray(buf), bs)


class PoissonSource(_SyntheticSource):
    """Homogeneous Poisson arrivals at ``rate`` events per unit time."""

    def __init__(self, rate: float, n: int, **kw):
        if rate <= 0:
            raise ValueError(f"rate must be positive, got {rate}")
        super().__init__(n, **kw)
        self.rate = float(rate)

    def _gaps(self, rng, idx0, m, carry):
        return rng.exponential(1.0 / self.rate, m), carry


class BurstySource(_SyntheticSource):
    """On/off Poisson: bursts of ``burst_len`` arrivals at ``burst_rate``
    separated by idle gaps at ``idle_rate`` — the adversarial pattern for
    queue occupancy (a whole burst can land inside one lookahead window).
    """

    def __init__(
        self,
        burst_rate: float,
        idle_rate: float,
        burst_len: int,
        n: int,
        **kw,
    ):
        if burst_rate <= 0 or idle_rate <= 0:
            raise ValueError("burst_rate and idle_rate must be positive")
        if burst_len <= 0:
            raise ValueError(f"burst_len must be positive, got {burst_len}")
        super().__init__(n, **kw)
        self.burst_rate = float(burst_rate)
        self.idle_rate = float(idle_rate)
        self.burst_len = int(burst_len)

    def _gaps(self, rng, idx0, m, carry):
        u = rng.exponential(1.0, m)
        idx = idx0 + np.arange(m)
        first_of_burst = (idx % self.burst_len) == 0
        mean = np.where(first_of_burst, 1.0 / self.idle_rate, 1.0 / self.burst_rate)
        return u * mean, carry


class DiurnalSource(_SyntheticSource):
    """Sinusoidally rate-modulated arrivals: the instantaneous rate is
    ``base_rate * (1 + amplitude * sin(2*pi*t/period))`` evaluated at the
    previous arrival (a deterministic rate-modulated stream, not an
    exact nonhomogeneous-Poisson thinning — good enough for a synthetic
    load curve and exactly reproducible).
    """

    def __init__(
        self,
        base_rate: float,
        n: int,
        amplitude: float = 0.5,
        period: float = 64.0,
        **kw,
    ):
        if base_rate <= 0:
            raise ValueError(f"base_rate must be positive, got {base_rate}")
        if not 0 <= amplitude < 1:
            raise ValueError(f"amplitude must be in [0, 1), got {amplitude}")
        if period <= 0:
            raise ValueError(f"period must be positive, got {period}")
        super().__init__(n, **kw)
        self.base_rate = float(base_rate)
        self.amplitude = float(amplitude)
        self.period = float(period)

    def _init_carry(self):
        return float(self.t0)

    def _gaps(self, rng, idx0, m, carry):
        u = rng.exponential(1.0, m)
        gaps = np.empty(m, np.float64)
        t = carry
        two_pi = 2.0 * np.pi
        for i in range(m):
            rate = self.base_rate * (
                1.0 + self.amplitude * np.sin(two_pi * t / self.period)
            )
            gaps[i] = u[i] / rate
            t += gaps[i]
        return gaps, t


# ---------------------------------------------------------------------------
# On-disk traces
# ---------------------------------------------------------------------------

_MAGIC = b"REPRO-TRACE-V1\n"
_HEADER_BYTES = 256


class TraceWriter:
    """Streams arrival blocks to disk in bounded memory.

    File layout: a fixed 256-byte header (magic + JSON metadata, padded
    with spaces) followed by raw little-endian float32 rows.  The row
    count in the header is finalized on :meth:`close`, so a writer can
    stream an unknown-length source.  Use as a context manager.
    """

    def __init__(self, path: str, meta: Optional[dict] = None):
        self.path = str(path)
        self.meta = dict(meta or {})
        self._rows = 0
        self._fh = open(self.path, "wb")
        self._write_header()

    def _write_header(self) -> None:
        payload = dict(self.meta)
        payload["rows"] = self._rows
        payload["width"] = EMIT_WIDTH
        body = _MAGIC + json.dumps(payload, sort_keys=True).encode()
        if len(body) >= _HEADER_BYTES:
            raise ValueError("trace metadata too large for header")
        self._fh.write(body.ljust(_HEADER_BYTES, b" "))

    def write_block(self, rows: np.ndarray) -> int:
        """Append the real (type >= 0) rows of a block; returns count."""
        rows = np.asarray(rows, np.float32)
        if rows.ndim != 2 or rows.shape[1] != EMIT_WIDTH:
            raise ValueError(f"expected (*, {EMIT_WIDTH}) rows, got {rows.shape}")
        real = rows[rows[:, 1] >= 0]
        self._fh.write(np.ascontiguousarray(real, "<f4").tobytes())
        self._rows += real.shape[0]
        return real.shape[0]

    def close(self) -> None:
        if self._fh is None:
            return
        self._fh.seek(0)
        self._write_header()
        self._fh.close()
        self._fh = None

    def __enter__(self) -> "TraceWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class TraceReader:
    """Bounded-memory block reader for :class:`TraceWriter` files.

    Reads one block at a time via ``np.fromfile`` at an explicit byte
    offset — a million-row trace costs one block of host memory.
    Implements the :class:`ArrivalSource` protocol.
    """

    def __init__(self, path: str, block_size: int = DEFAULT_BLOCK):
        if block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self.path = str(path)
        self.block_size = int(block_size)
        self._cursor = 0
        with open(self.path, "rb") as fh:
            head = fh.read(_HEADER_BYTES)
        if not head.startswith(_MAGIC):
            raise ValueError(f"{path}: not a repro trace file")
        self.meta = json.loads(head[len(_MAGIC) :].decode())
        if self.meta.get("width") != EMIT_WIDTH:
            raise ValueError(
                f"{path}: row width {self.meta.get('width')} != {EMIT_WIDTH}"
            )
        self.n = int(self.meta["rows"])
        size = os.path.getsize(self.path) - _HEADER_BYTES
        if size < self.n * EMIT_WIDTH * 4:
            raise ValueError(f"{path}: truncated trace ({size} data bytes)")

    def __len__(self) -> int:
        return self.n

    def seek(self, cursor: int) -> None:
        if not 0 <= cursor <= self.n:
            raise ValueError(f"cursor {cursor} outside [0, {self.n}]")
        self._cursor = int(cursor)

    def blocks(self) -> Iterator[np.ndarray]:
        bs = self.block_size
        pos = self._cursor
        with open(self.path, "rb") as fh:
            while pos < self.n:
                take = min(bs, self.n - pos)
                fh.seek(_HEADER_BYTES + pos * EMIT_WIDTH * 4)
                flat = np.fromfile(fh, "<f4", take * EMIT_WIDTH)
                rows = flat.astype(np.float32).reshape(take, EMIT_WIDTH)
                yield _pad_block(rows, bs)
                pos += take


def source_events(source: ArrivalSource) -> list:
    """Materialize a source as ``(time, type, args)`` seed tuples.

    This is the closed-system reference path: pre-seed the entire trace
    into the initial queue and run to quiescence.  Tests compare this
    against streaming the same source.  Loads the whole trace — use
    only for traces that fit in host memory.
    """
    out = []
    source.seek(0)
    for block in source.blocks():
        for row in block:
            if row[1] < 0:
                continue
            out.append(
                (float(row[0]), int(row[1]), tuple(float(a) for a in row[2:]))
            )
    return out
