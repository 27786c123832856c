"""Streamed arrivals in ``repro_torch`` against ``repro``.

* Sources: the Poisson, bursty and diurnal generators give blocks
  byte-identical to JAX's for one seed (grid and free times, after a
  seek), and trace files are the same bytes, written and read either
  way.
* The feeder: keys, cursor and seqs, host slices, producer-side checks.
* Runs, on the open admission scenario (arrival times on the 0.25
  grid): a streamed run equals the same trace pre-seeded and equals
  JAX's streamed run with ``assert_run_parity`` (state, events, batches,
  dropped, final_time, emitted, pending, word_counts, final queue:
  exact) and the same ``ingested`` and ``shed``; an interrupted streamed
  run resumes bit-identically; a small-capacity ``overflow="spill"``
  stream equals the closed large run and JAX's small spill stream;
  arrivals past ``until`` stay unconsumed; the ``backpressure`` modes
  shed, raise, stall into ``FAULT_INGEST`` or wait for capacity.
"""

import sys

import numpy as np
import pytest
import torch

from repro.core.program import Config as JConfig
from repro.serving import scenarios as jsc
from repro import stream as jstream
from repro_torch import stream as tstream
from repro_torch.api import Config as TConfig
from repro_torch.api import EngineFaultError, SimProgram
from repro_torch.core.validate import FAULT_INGEST
from repro_torch.serving import scenarios as tsc
from repro_torch.stream import PoissonSource, StreamFeeder, source_events
from repro_torch.testing.faults import SimulatedCrash, tiny_phold

from test_torch_engine import assert_run_parity

N_REQ = 40


def _sources(pkg):
    return {
        "poisson": lambda n, **kw: pkg.PoissonSource(2.0, n, **kw),
        "bursty": lambda n, **kw: pkg.BurstySource(8.0, 0.5, 5, n, **kw),
        "diurnal": lambda n, **kw: pkg.DiurnalSource(2.0, n, period=16.0,
                                                     **kw),
    }


@pytest.mark.parametrize("kind", ["poisson", "bursty", "diurnal"])
@pytest.mark.parametrize("grid", [None, 0.25])
def test_source_blocks_byte_identical_to_jax(kind, grid):
    for cursor in (0, 13):
        js = _sources(jstream)[kind](45, seed=5, block_size=8, grid=grid,
                                     t0=1.0)
        ts = _sources(tstream)[kind](45, seed=5, block_size=8, grid=grid,
                                     t0=1.0)
        js.seek(cursor)
        ts.seek(cursor)
        jb, tb = list(js.blocks()), list(ts.blocks())
        assert len(jb) == len(tb)
        for a, b in zip(jb, tb):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert source_events(ts) == jstream.source_events(js)


def test_trace_files_byte_identical_both_ways(tmp_path):
    src = tstream.BurstySource(8.0, 0.5, 5, 37, seed=2, block_size=8)
    jpath, tpath = tmp_path / "j.trace", tmp_path / "t.trace"
    with jstream.TraceWriter(str(jpath), meta={"seed": 2}) as w:
        for b in src.blocks():
            w.write_block(b)
    with tstream.TraceWriter(str(tpath), meta={"seed": 2}) as w:
        for b in src.blocks():
            w.write_block(b)
    assert jpath.read_bytes() == tpath.read_bytes()
    for reader in (tstream.TraceReader(str(jpath), block_size=16),
                   jstream.TraceReader(str(tpath), block_size=16)):
        assert len(reader) == 37 and reader.meta["seed"] == 2
        got = np.concatenate(list(reader.blocks()))
        want = np.concatenate(list(tstream.TraceReader(
            str(tpath), block_size=16).blocks()))
        assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# the feeder
# ---------------------------------------------------------------------------

class _ListSource:
    def __init__(self, blocks, n=None):
        self._blocks = blocks
        self.block_size = blocks[0].shape[0]
        self.n = (sum(int((b[:, 1] >= 0).sum()) for b in blocks)
                  if n is None else n)
        self._cursor = 0

    def __len__(self):
        return self.n

    def seek(self, cursor):
        self._cursor = cursor

    def blocks(self):
        skip = self._cursor
        for b in self._blocks:
            if skip >= b.shape[0]:
                skip -= b.shape[0]
                continue
            yield b[skip:] if skip else b
            skip = 0


def _block(times, size=4):
    b = np.zeros((size, 6), np.float32)
    b[:, 1] = -1.0
    for i, t in enumerate(times):
        b[i, 0], b[i, 1], b[i, 2] = t, 0.0, i
    return b


@pytest.mark.parametrize("prefetch", [False, True])
def test_feeder_keys_and_advance(prefetch):
    src = _ListSource([_block([1.0, 2.0, 3.0, 4.0]), _block([5.0, 6.0])])
    f = StreamFeeder(src, 10, prefetch=prefetch)
    try:
        assert f.next_key() == (1.0, 10)
        assert f.admissible(3.0) == 3
        rows, seqs, off = f.device_block()
        assert off == 0 and rows.dtype == torch.float32
        np.testing.assert_array_equal(seqs.numpy(), 10 + np.arange(4))
        f.advance(2)
        assert f.next_key() == (3.0, 12)
        f.advance(2)
        assert f.next_key() == (5.0, 14)
        assert f.admissible(np.inf) == 2
        r, s = f.host_slice(1)
        np.testing.assert_array_equal(r[:, 0], [5.0])
        np.testing.assert_array_equal(s, [14])
        f.advance(2)
        assert not f.has_pending()
        assert f.next_key() == (float("inf"), 2**31 - 1)
    finally:
        f.close()


def test_feeder_rejects_bad_streams():
    for blocks, n, match in (
            ([_block([1.0, 2.0, 3.0, 4.0]), _block([3.5, 6.0])], None,
             "nondecreasing"),
            ([_block([1.0, 2.0, 3.0, 4.0])], 2, "real row")):
        for prefetch in (False, True):
            f = StreamFeeder(_ListSource(blocks, n), 0, prefetch=prefetch,
                             to_device=False)
            try:
                with pytest.raises(ValueError, match=match):
                    f.next_key()
                    f.advance(4)
                    f.next_key()
            finally:
                f.close()


# ---------------------------------------------------------------------------
# streamed runs of the open admission scenario
# ---------------------------------------------------------------------------

def _source(pkg=tstream, n=N_REQ):
    return pkg.PoissonSource(1.5, n, seed=42, grid=0.25, t0=0.0,
                             type_id=0, block_size=16)


def _tprog(capacity=256, n=N_REQ):
    return tsc.build_open_admission_program(
        num_slots=4, num_requests=n, max_decode=5,
        config=TConfig(max_batch_len=3, capacity=capacity, max_emit=2))


def _jprog(capacity=256):
    return jsc.build_open_admission_program(
        num_slots=4, num_requests=N_REQ, max_decode=5,
        config=JConfig(max_batch_len=3, capacity=capacity, max_emit=2))


def _closed_events():
    """Program seeds first (the streamed run's seq0), then the trace."""
    return [(1.0, "TICK")] + [(t, ty, list(arg))
                              for (t, ty, arg) in source_events(_source())]


def _assert_same_outcome(a, b):
    for k, v in b.state.items():
        np.testing.assert_array_equal(np.asarray(a.state[k]), np.asarray(v),
                                      err_msg=k)
    assert a.events == b.events and a.dropped == b.dropped
    assert np.float32(a.final_time) == np.float32(b.final_time)


@pytest.fixture(scope="module")
def jax_streamed():
    sim = _jprog().build(backend="device", dispatch_mode="masked")
    return sim.run(jsc.initial_state(4), arrivals=_source(jstream))


def test_streamed_equals_preseeded_and_jax(jax_streamed):
    sim = _tprog().build(device="cpu", dispatch_mode="masked")
    streamed = sim.run(tsc.initial_state(4), arrivals=_source())
    assert_run_parity(jax_streamed, streamed)
    assert streamed.ingested == jax_streamed.ingested == N_REQ
    assert streamed.shed == jax_streamed.shed == 0
    closed = sim.run(tsc.initial_state(4), events=_closed_events())
    _assert_same_outcome(streamed, closed)
    st = {k: int(v.sum()) for k, v in streamed.state.items()}
    assert st["arrivals"] == st["admitted"] == st["served"] == N_REQ
    # The prefetching feeder and the in-line one give the same run.
    inline = sim.run(tsc.initial_state(4), arrivals=_source(),
                     _stream_prefetch=False)
    assert_run_parity(jax_streamed, inline)


def test_streamed_resume_bit_identical(tmp_path):
    sim = _tprog().build(device="cpu")
    straight = sim.run(tsc.initial_state(4), arrivals=_source(),
                       checkpoint_every=8,
                       checkpoint_dir=str(tmp_path / "straight"))

    def hook(seg, state, queue, stats):
        if seg == 3:
            raise SimulatedCrash("stop")

    with pytest.raises(SimulatedCrash):
        sim.run(tsc.initial_state(4), arrivals=_source(), checkpoint_every=8,
                checkpoint_dir=str(tmp_path / "crash"), _segment_hook=hook)
    resumed = sim.run(tsc.initial_state(4), arrivals=_source(),
                      checkpoint_every=8,
                      checkpoint_dir=str(tmp_path / "crash"),
                      resume_from="latest")
    assert_run_parity(straight, resumed)
    assert resumed.ingested == N_REQ
    # A streamed checkpoint refuses a closed resume.
    with pytest.raises(ValueError, match="arrival cursor"):
        sim.run(tsc.initial_state(4), checkpoint_every=8,
                checkpoint_dir=str(tmp_path / "crash"),
                resume_from="latest")


def test_small_capacity_spill_equals_closed_large_and_jax():
    """Stream through a queue far smaller than the backlog: the excess
    waits in the spill pool, and the run equals the closed large one
    and JAX's small spill stream."""
    streamed = _tprog(capacity=24).build(
        device="cpu", overflow="spill").run(tsc.initial_state(4),
                                            arrivals=_source())
    closed = _tprog().build(device="cpu").run(tsc.initial_state(4),
                                              events=_closed_events())
    _assert_same_outcome(streamed, closed)
    assert streamed.ingested == N_REQ and streamed.spilled == 0
    jres = _jprog(capacity=24).build(backend="device", overflow="spill").run(
        jsc.initial_state(4), arrivals=_source(jstream))
    assert_run_parity(jres, streamed)
    assert streamed.spilled == jres.spilled == 0
    assert streamed.ingested == jres.ingested


def test_horizon_leaves_tail_unconsumed():
    rows_t = [t for (t, _, _) in source_events(_source())]
    horizon = rows_t[len(rows_t) // 2]
    res = _tprog().build(device="cpu").run(
        tsc.initial_state(4), arrivals=_source(), until=horizon)
    assert res.ingested == sum(1 for t in rows_t if t <= horizon)
    assert res.shed == 0


def test_backpressure_validation():
    sim = _tprog().build(device="cpu")
    with pytest.raises(ValueError, match="backpressure"):
        sim.run(tsc.initial_state(4), arrivals=_source(),
                backpressure="reject")
    with pytest.raises(ValueError, match="arrivals"):
        sim.run(tsc.initial_state(4), backpressure="shed")


def _wedged_prog(cap=8):
    """A queue full of far-future events: no arrival can be absorbed
    and, under the fence, no event can run."""
    p = SimProgram("wedge", config=TConfig(max_batch_len=4, capacity=cap,
                                           max_emit=1))

    @p.handler("EV", lookahead=0.25)
    def ev(state, t, arg):
        return state + 1

    for i in range(cap):
        p.schedule(1000.0 + 0.25 * i, "EV")
    return p


def _arrivals(n=4):
    return PoissonSource(4.0, n, grid=0.25, type_id=0, block_size=4)


def _zero():
    return torch.zeros((), dtype=torch.int32)


def test_backpressure_shed_error_and_block():
    sim = _wedged_prog().build(device="cpu", validate="cheap")
    res = sim.run(_zero(), arrivals=_arrivals(), backpressure="shed",
                  max_batches=20)
    assert res.shed == 4 and res.ingested == 4
    assert res.events == 8 and int(res.state) == 8
    with pytest.raises(EngineFaultError, match="ingest_stall") as ei:
        sim.run(_zero(), arrivals=_arrivals(), backpressure="error",
                max_batches=20)
    assert ei.value.fault_word & FAULT_INGEST
    with pytest.raises(EngineFaultError, match="ingest_stall"):
        sim.run(_zero(), arrivals=_arrivals(), backpressure="block",
                max_batches=20)


def test_backpressure_block_waits_for_capacity():
    p = SimProgram("drain", config=TConfig(max_batch_len=2, capacity=4,
                                           max_emit=1))

    @p.handler("EV", lookahead=0.25)
    def ev(state, t, arg):
        return state + 1

    for i in range(4):
        p.schedule(0.25 * i, "EV")
    src = PoissonSource(1.0, 6, grid=0.25, t0=0.25, type_id=0, block_size=4)
    res = p.build(device="cpu", validate="cheap").run(
        _zero(), arrivals=src, max_batches=100)
    assert res.shed == 0 and res.ingested == 6
    assert res.events == 10 and res.pending == 0


def test_streamed_tiny_phold_sync_equals_prefetch():
    def go(prefetch):
        src = PoissonSource(2.0, 24, grid=0.25, type_id=0, block_size=8)
        return tiny_phold(capacity=64).build(device="cpu").run(
            _zero(), max_batches=40, arrivals=src,
            _stream_prefetch=prefetch)

    a, b = go(True), go(False)
    assert int(a.state) == int(b.state) and a.events == b.events
    assert a.ingested == b.ingested > 0
    assert np.float32(a.final_time) == np.float32(b.final_time)


def test_host_import_leaves_jax_out():
    import subprocess

    code = ("import sys, repro_torch.stream, repro_torch.testing, "
            "repro_torch.checkpoint.manager, repro_torch.core.validate; "
            "bad = [m for m in sys.modules if m in ('jax', 'repro', "
            "'ml_dtypes') or m.startswith(('jax.', 'repro.'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stdout + out.stderr
