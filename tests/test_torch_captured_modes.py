"""The captured loop (``loop="captured"``) on the paths past the closed
tiered3 run, on the CPU: spilling runs, streamed runs with and without
spill, and the two-tier, flat and reference queues.

On the CPU the captured step runs eagerly, its branches read on the
host (``repro_torch.core.capture.EmulateContext``), with one read of the
loop's guard a chunk.  Each run is held bit for bit to JAX's device
engine on the same ``SimProgram`` (``repro``'s queues,
``queue_kernels="xla"``) and to the port's eager loop: final state
(every leaf), events, batches, dropped, final_time, emitted, pending,
the word histogram and every field of the final queue; spilled,
ingested and shed counts and the final fence where they apply; the
engine's ``COUNTS`` (the two-tier flush legs, rebalances, absorbs) and
the queue kernels' launches against the eager run.  A segmented run
must capture once (``DeviceEngine.captures`` counts the graphs a card
would capture), and inside the loop only the chunk reads may reach the
host.  Tolerance: exact.
"""

import math
import sys

import numpy as np
import pytest
import torch

from repro import stream as jstream
from repro_torch import stream as tstream
from repro_torch.api import Config as TConfig
from repro_torch.api import EngineFaultError
from repro_torch.core import capture
from repro_torch.core import engine as tengine
from repro_torch.core import program as tprogram
from repro_torch.core import queue as tq
from repro_torch.core.validate import FAULT_OVERFLOW, FAULT_TIME_NONFINITE
from repro_torch.examples import phold as tphold
from repro_torch.kernels import queue_front as tqf
from repro_torch.serving import scenarios as tsc
from repro_torch.testing.faults import SimulatedCrash, storm_program

from test_torch_captured import _poison_program, assert_same_run
from test_torch_engine import ROOT, assert_run_parity
from test_torch_queue_modes import assert_run_parity as assert_mode_parity

sys.path.insert(0, str(ROOT / "examples"))
import phold as jphold  # noqa: E402  (examples/ is not a package)

DISPATCH = ("switch", "masked", "fused")
QUEUE_MODES = ("tiered", "flat", "reference")
CHUNK = 16       # small, so that runs and segments end mid-chunk
PHOLD = dict(num_lps=24, t_stop=30.0, capacity=64)
# Two-tier tiers on which both legs of the staging flush fire (the tail
# append once, when a refill has emptied the main ring).
MODE_TIERS = {"tiered": dict(front_cap=16, stage_cap=4), "flat": {},
              "reference": {}}
# PHOLD with more LPs than queue slots, stopped while seeds still wait
# in the spill pool behind the fence.
SPILL = dict(num_lps=24, t_stop=30.0, capacity=16)
SPILL_BATCHES = 24
# Streamed runs: PHOLD and the open admission scenario, with
# ``test_torch_captured``'s source of 16 arrivals (PHOLD's LP ids).
STREAM = PHOLD
ARRIVALS = 16
STREAM_SPILL_CAPACITY = 12
NOT_COUNTED = ("host_syncs", "loop_syncs", "cond_reads")


def _source(pkg=tstream):
    return pkg.PoissonSource(1.5, ARRIVALS, seed=1, grid=0.25, t0=0.0,
                             type_id=0, block_size=8)


def _admission(capacity):
    """The open admission scenario, whose handlers run in the step."""
    return tsc.build_open_admission_program(
        num_slots=4, num_requests=ARRIVALS, max_decode=5,
        config=TConfig(max_batch_len=3, capacity=capacity, max_emit=2))


_JAX = {}


def _jax_spill_sim():
    """JAX's PHOLD in the 16-event spilling queue, built once: its
    closed and streamed runs share their compiles."""
    if "spill" not in _JAX:
        _JAX["spill"] = jphold.build_program(**SPILL).build(
            backend="device", overflow="spill", validate="cheap")
    return _JAX["spill"]


def _run(prog, state, loop, run_kw=None, **build_kw):
    """One port run on the CPU: ``(result, COUNTS, LAUNCHES, engine)``,
    the counts zeroed just before."""
    tq.COUNTS.clear()
    tqf.reset_launches()
    sim = prog.build(backend="device", device="cpu", loop=loop, **build_kw)
    sim.engine.chunk = CHUNK
    res = sim.run(state, **(run_kw or {}))
    return res, dict(tq.COUNTS), dict(tqf.LAUNCHES), sim.engine


def _rare(counts) -> dict:
    return {k: v for k, v in counts.items() if k not in NOT_COUNTED}


def _captured_against_eager(make_prog, make_state, run_kw=None, **build_kw):
    """The eager and the captured run of one configuration, held to each
    other; returns the captured run, its counts and its engine."""
    eager, ce, le, _ = _run(make_prog(), make_state(), "eager", run_kw,
                            **build_kw)
    capt, cc, lc, eng = _run(make_prog(), make_state(), "captured", run_kw,
                             **build_kw)
    assert_same_run(capt, eager)
    assert _rare(cc) == _rare(ce)
    assert lc == le
    return capt, cc, eng


def _fence(res):
    return (np.float32(res.raw["bound_t"]).item(),
            int(res.raw["bound_seq"]))


@pytest.mark.parametrize("mode", QUEUE_MODES)
def test_queue_mode_matches_jax_and_eager(mode):
    """PHOLD in the queue mode under the three dispatch modes with
    ``validate="cheap"`` and under ``switch`` without it, each held to
    one JAX run and to the eager loop, with one loop read a chunk."""
    tiers = MODE_TIERS[mode]
    jres = jphold.build_program(**PHOLD).build(
        backend="device", queue_mode=mode, validate="cheap", **tiers).run(
            jphold.initial_state(PHOLD["num_lps"]))
    cases = [(d, "cheap") for d in DISPATCH] + [("switch", "off")]
    for dispatch, validate in cases:
        capt, cc, _ = _captured_against_eager(
            lambda: tphold.build_program(**PHOLD),
            lambda: tphold.initial_state(PHOLD["num_lps"]),
            queue_mode=mode, dispatch_mode=dispatch, validate=validate,
            **tiers)
        assert_mode_parity(jres, capt, f"{mode} {dispatch} {validate}")
        assert cc["loop_syncs"] == math.ceil(capt.batches / CHUNK)
        if mode == "tiered":
            # Every two-tier rare path fires, as often as in the eager
            # run (held above).
            for name in ("flush", "flush_append", "flush_merge",
                         "refill_main_only"):
                assert cc[name] > 0, name


@pytest.mark.parametrize("mode", QUEUE_MODES)
@pytest.mark.parametrize("case", ["cheap_fault", "overflow_error"])
def test_fault_stops_at_the_same_step(mode, case):
    """A non-finite time under ``validate="cheap"`` and an overflow
    under ``overflow="error"`` stop the captured loop at the eager
    loop's step, with its fault word."""
    if case == "cheap_fault":
        make = lambda: _poison_program(9.0)  # noqa: E731
        kw, want_word = dict(validate="cheap"), FAULT_TIME_NONFINITE
    else:
        make = lambda: storm_program(16)  # noqa: E731
        kw, want_word = dict(overflow="error"), FAULT_OVERFLOW
    raised = {}
    for loop in ("eager", "captured"):
        with pytest.raises(EngineFaultError) as err:
            _run(make(), torch.zeros((), dtype=torch.int32), loop,
                 queue_mode=mode, **kw)
        raised[loop] = (err.value.fault_word, err.value.fault_step)
    assert raised["captured"] == raised["eager"]
    assert raised["eager"][0] & want_word
    assert raised["eager"][1] > 0


def test_spill_matches_jax_and_eager():
    """PHOLD with 24 LPs in a 16-event queue under ``overflow="spill"``
    and ``validate="cheap"``, stopped while seeds still wait in the
    pool: held to JAX's run and to the eager loop, with the spilled
    count, the final fence, the rebalances and the absorbs, in one
    capture across every segment."""
    jres = _jax_spill_sim().run(jphold.initial_state(SPILL["num_lps"]),
                                max_batches=SPILL_BATCHES)
    capt, cc, eng = _captured_against_eager(
        lambda: tphold.build_program(**SPILL),
        lambda: tphold.initial_state(SPILL["num_lps"]),
        dict(max_batches=SPILL_BATCHES), overflow="spill",
        validate="cheap")
    assert_run_parity(jres, capt)
    assert capt.batches == SPILL_BATCHES
    assert capt.spilled == jres.spilled > 0
    assert _fence(capt) == _fence(jres) != (math.inf, 2**31 - 1)
    assert cc["rebalance"] > 0
    # More segments than one: each boundary's absorb, rebalance and
    # fence went into the one graph's carry.
    assert cc["loop_syncs"] > 1
    assert eng.captures == 1


def test_streamed_matches_jax_and_eager(tmp_path):
    """PHOLD with 16 arrivals streamed in: held to JAX's
    ``device/tiered3+stream`` run and to the eager loop, in one capture;
    then checkpointed every 8 super-steps, crashed after the third
    segment and resumed in the same engine: equal to the eager loop's
    run with the same segments, and still one capture."""
    state = lambda: tphold.initial_state(STREAM["num_lps"])  # noqa: E731
    make = lambda: tphold.build_program(**STREAM)  # noqa: E731
    jres = jphold.build_program(**STREAM).build(
        backend="device", queue_mode="tiered3").run(
            jphold.initial_state(STREAM["num_lps"]),
            arrivals=_source(jstream))
    capt, cc, eng = _captured_against_eager(make, state,
                                            dict(arrivals=_source()))
    assert_run_parity(jres, capt)
    assert (capt.ingested, capt.shed) == (jres.ingested, jres.shed)
    assert capt.ingested == ARRIVALS
    assert cc["absorb"] > 1 and cc["loop_syncs"] > cc["absorb"]
    assert eng.captures == 1

    run_kw = dict(arrivals=_source(), checkpoint_every=8,
                  checkpoint_dir=str(tmp_path / "straight"))
    straight, _, _, _ = _run(make(), state(), "eager", run_kw)
    sim = make().build(backend="device", device="cpu", loop="captured")
    sim.engine.chunk = CHUNK

    def crash(seg, state, queue, stats):
        if seg == 3:
            raise SimulatedCrash("stop")

    run_kw["checkpoint_dir"] = str(tmp_path / "crash")
    with pytest.raises(SimulatedCrash):
        sim.run(state(), _segment_hook=crash, **run_kw)
    resumed = sim.run(state(), resume_from="latest", **run_kw)
    assert_same_run(resumed, straight)
    assert sim.engine.captures == 1


def test_streamed_spill_matches_jax_and_eager():
    """The same stream into the 16-event queue under ``overflow="spill"``
    and ``validate="cheap"``: the backlog waits in the spill pool; held
    to JAX's run and to the eager loop, in one capture."""
    jres = _jax_spill_sim().run(jphold.initial_state(SPILL["num_lps"]),
                                arrivals=_source(jstream))
    capt, cc, eng = _captured_against_eager(
        lambda: tphold.build_program(**SPILL),
        lambda: tphold.initial_state(SPILL["num_lps"]),
        dict(arrivals=_source()), overflow="spill", validate="cheap")
    assert_run_parity(jres, capt)
    assert (capt.spilled, capt.ingested, capt.shed) == (
        jres.spilled, jres.ingested, jres.shed)
    assert capt.ingested == ARRIVALS
    assert cc["rebalance"] > 0
    assert eng.captures == 1


_READ_PATHS = {
    "tiered": (lambda: tphold.build_program(**PHOLD),
               lambda: tphold.initial_state(PHOLD["num_lps"]), {},
               dict(queue_mode="tiered", **MODE_TIERS["tiered"])),
    "flat": (lambda: tphold.build_program(**PHOLD),
             lambda: tphold.initial_state(PHOLD["num_lps"]), {},
             dict(queue_mode="flat")),
    "reference": (lambda: tphold.build_program(**PHOLD),
                  lambda: tphold.initial_state(PHOLD["num_lps"]), {},
                  dict(queue_mode="reference")),
    "spill": (lambda: tphold.build_program(**SPILL),
              lambda: tphold.initial_state(SPILL["num_lps"]),
              dict(max_batches=SPILL_BATCHES), dict(overflow="spill")),
    "stream_spill": (
        lambda: _admission(STREAM_SPILL_CAPACITY),
        lambda: tsc.initial_state(4), dict(arrivals=_source()),
        dict(overflow="spill")),
}


@pytest.mark.parametrize("path", sorted(_READ_PATHS))
def test_only_chunk_reads_inside_the_loop(path, monkeypatch):
    """With every host read refused inside a step (validated and, but
    for spill, ``overflow="error"``), the loop reads the host only at a
    chunk's end: ``loop_syncs`` equals the chunk reads."""
    reads = []
    chunk_reads = []

    def guarded(real):
        def read(t):
            assert not capture.in_step(), "a host read inside a step"
            reads.append(t.numel())
            return real(t)
        return read

    real = {name: getattr(capture, name)
            for name in ("host_read", "host_list")}
    for mod in (capture, tq, tengine, tprogram):
        for name in real:
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, guarded(real[name]))
    chunk_read = tengine.DeviceEngine._chunk_read

    def counted(self, carry, extra=None):
        chunk_reads.append(1)
        return chunk_read(self, carry, extra)

    monkeypatch.setattr(tengine.DeviceEngine, "_chunk_read", counted)
    make_prog, make_state, run_kw, build_kw = _READ_PATHS[path]
    if build_kw.get("overflow") != "spill":
        build_kw = dict(build_kw, overflow="error")
    res, counts, _, _ = _run(make_prog(), make_state(), "captured", run_kw,
                             validate="cheap", **build_kw)
    assert counts["loop_syncs"] == len(chunk_reads) > 0
    assert counts["cond_reads"] > res.batches
    assert len(reads) == counts["host_syncs"] > counts["loop_syncs"]
