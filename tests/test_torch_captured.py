"""The device engine's captured loop (``loop="captured"``) on the CPU.

On a CUDA device one super-step is captured as a CUDA graph and
replayed in chunks; on the CPU the same step function runs eagerly, its
branches (``repro_torch.core.capture.when``/``select``) read on the
host, with one read of the loop's guard a chunk.  Each run here is held
bit for bit to JAX's device engine (``repro``'s tiered3 queue,
``queue_kernels="xla"``) and to the port's eager loop: final state
(every leaf), events, batches, dropped, final_time, emitted, pending,
the word histogram and every field of the final queue, plus the
engine's rare-path, ``run_path`` and fused counts and the kernels'
launches.  Tolerance: exact.

PHOLD runs on tiers small enough that every tiered3 rare path fires but
``merge_append``: a run holds only staged events at or before the main
ring's tail when it was written, and the tail never moves down while
the ring holds events, so the run pool is never all past it (the
compaction takes every merge).  All three dispatch modes are held to
one JAX run: JAX's own parity tests pin its modes to each other.
"""

import math
import sys

import numpy as np
import pytest
import torch

from repro.core.program import Config as JConfig
from repro import poc as jpoc
from repro_torch.api import ARG_WIDTH, Config, EngineFaultError, SimProgram
from repro_torch.core import capture
from repro_torch.core import engine as tengine
from repro_torch.core import program as tprogram
from repro_torch.core import queue as tq
from repro_torch.core import sharded as tsharded
from repro_torch.core.validate import FAULT_OVERFLOW, FAULT_TIME_NONFINITE
from repro_torch.examples import mmc_network as tmmc
from repro_torch.examples import phold as tphold
from repro_torch.examples import poc as tpoc
from repro_torch.kernels import queue_front as tqf
from repro_torch.testing.faults import storm_program

from test_torch_engine import ROOT, assert_run_parity

sys.path.insert(0, str(ROOT / "examples"))
import mmc_network as jmmc  # noqa: E402  (examples/ is not a package)
import phold as jphold  # noqa: E402

MODES = ("switch", "masked", "fused")
CHUNK = 16       # small, so that runs end mid-chunk
RARE = ("flush", "refill_kway", "refill_main_only", "to_run",
        "merge_compact", "head_merge", "suffix_append", "rotate")
COUNTED = RARE + ("merge_append", "run_path", "fused_hot", "fused_fallback")

# PHOLD where every rare path but merge_append fires (60 super-steps).
PHOLD = dict(num_lps=24, t_stop=30.0, capacity=64)
TIERS = dict(front_cap=8, stage_cap=4, num_runs=2)

_JAX = {}


def _jax_once(key, fn):
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def _jax_phold():
    return _jax_once("phold", lambda: jphold.build_program(**PHOLD).build(
        backend="device", queue_kernels="xla", **TIERS).run(
            jphold.initial_state(PHOLD["num_lps"])))


def _run(prog, state, loop, run_kw=None, **build_kw):
    """One port run on the CPU; returns the result, the engine's counts
    and the queue kernels' launches, each zeroed just before."""
    tq.COUNTS.clear()
    tqf.reset_launches()
    sim = prog.build(backend="device", device="cpu", loop=loop, **build_kw)
    sim.engine.chunk = CHUNK
    res = sim.run(state, **(run_kw or {}))
    return res, dict(tq.COUNTS), dict(tqf.LAUNCHES)


def assert_same_run(got, want):
    """Port against port: every field ``assert_run_parity`` holds."""
    gl, wl = _leaves(got.state), _leaves(want.state)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        assert torch.equal(a, b)
    for name in ("events", "batches", "dropped", "emitted", "pending",
                 "spilled", "ingested", "shed", "fault_word"):
        assert getattr(got, name) == getattr(want, name), name
    assert np.float32(got.final_time) == np.float32(want.final_time)
    np.testing.assert_array_equal(got.word_counts, want.word_counts)
    g = tq.queue_to_arrays(got.raw["final_queue"])
    w = tq.queue_to_arrays(want.raw["final_queue"])
    assert g.keys() == w.keys()
    for name in w:
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _assert_counts(got, want):
    assert {k: got.get(k, 0) for k in COUNTED} == \
        {k: want.get(k, 0) for k in COUNTED}


def _captured_against_eager(prog_fn, state_fn, run_kw=None, **build_kw):
    eager, ce, le = _run(prog_fn(), state_fn(), "eager", run_kw, **build_kw)
    capt, cc, lc = _run(prog_fn(), state_fn(), "captured", run_kw,
                        **build_kw)
    assert_same_run(capt, eager)
    _assert_counts(cc, ce)
    assert lc == le
    return capt, cc, ce


@pytest.mark.parametrize("mode", MODES)
def test_phold_every_rare_path_matches_jax_and_eager(mode):
    capt, cc, ce = _captured_against_eager(
        lambda: tphold.build_program(**PHOLD),
        lambda: tphold.initial_state(PHOLD["num_lps"]),
        dispatch_mode=mode, **TIERS)
    assert_run_parity(_jax_phold(), capt)
    for name in RARE:
        assert cc[name] > 0, name
    if mode == "fused":
        assert cc["fused_hot"] + cc.get("fused_fallback", 0) == capt.batches
    # The loop's reads: one a chunk (the eager loop reads four a step).
    assert cc["loop_syncs"] == math.ceil(capt.batches / CHUNK)
    assert ce["loop_syncs"] > 4 * capt.batches


def test_poc_matches_jax_and_eager():
    evs = tpoc.schedule_poc_events(128, 0.3, seed=5)
    assert evs == jpoc.schedule_poc_events(128, 0.3, seed=5)
    jres = _jax_once("poc", lambda: jpoc.build_program(
        iters=16, config=JConfig(max_batch_len=4)).build(
            backend="device").run(jpoc.initial_state(), events=evs))
    hot = [[tpoc.INCREMENT] * 4, [tpoc.SET] + [tpoc.INCREMENT] * 3]
    for mode in MODES:
        kw = dict(hot_words=hot) if mode == "fused" else {}
        capt, cc, _ = _captured_against_eager(
            lambda: tpoc.build_program(16, config=Config(max_batch_len=4)),
            tpoc.initial_state, dict(events=evs), dispatch_mode=mode, **kw)
        assert_run_parity(jres, capt)
        if mode == "fused":
            assert cc["fused_hot"] and cc["fused_fallback"]


def test_mmc_run_path_matches_jax_and_eager():
    jres = _jax_once("mmc", lambda: jmmc.build_program(
        num_stations=3, t_open=12.0).build(
            backend="device", dispatch_mode="masked").run(
                jmmc.initial_state(3)))
    for mode in MODES:
        capt, cc, _ = _captured_against_eager(
            lambda: tmmc.build_program(num_stations=3, t_open=12.0),
            lambda: tmmc.initial_state(3), dispatch_mode=mode)
        assert_run_parity(jres, capt)
        assert cc["run_path"] > 0


@pytest.mark.parametrize("run_kw", [
    dict(max_batches=37),                  # stops mid-chunk
    dict(until=12.25),                     # t_end mid-chunk
    dict(max_batches=45, until=21.0),
    dict(checkpoint_every=11),             # segments resume run(stats=)
    dict(until=-1.0),                      # inactive from the start
], ids=["max_batches", "t_end", "both", "segments", "no_step"])
def test_stops_and_resumes_mid_chunk(run_kw, tmp_path):
    if "checkpoint_every" in run_kw:
        run_kw = dict(run_kw, checkpoint_dir=str(tmp_path))
    _captured_against_eager(
        lambda: tphold.build_program(**PHOLD),
        lambda: tphold.initial_state(PHOLD["num_lps"]), run_kw,
        validate="cheap", **TIERS)


def test_engine_run_stats_resume():
    """``DeviceEngine.run(stats=)`` continues a captured run exactly
    where an uninterrupted eager run would be."""
    prog = tphold.build_program(**PHOLD)
    out = {}
    for loop in ("eager", "captured"):
        eng = tengine.DeviceEngine.from_program(
            prog, device="cpu", loop=loop, **TIERS)
        eng.chunk = CHUNK
        queue = eng.initial_queue(prog.scheduled_events())
        state = tphold.initial_state(PHOLD["num_lps"])
        if loop == "captured":
            state, queue, stats = eng.run(state, queue, max_batches=23)
            assert stats["batches"] == 23
            state, queue, stats = eng.run(state, queue, stats=stats)
        else:
            state, queue, stats = eng.run(state, queue)
        out[loop] = (state, tq.tiered3_queue_to_arrays(queue), stats)
    (se, qe, ste), (sc, qc, stc) = out["eager"], out["captured"]
    for k in se:
        assert torch.equal(se[k], sc[k])
    for k in qe:
        np.testing.assert_array_equal(qe[k], qc[k], err_msg=k)
    assert (stc["batches"], stc["events"]) == (ste["batches"], ste["events"])
    assert isinstance(stc["batches"], int)
    for k in ("emitted", "time", "word_counts"):
        assert torch.equal(ste[k], stc[k]), k


def _poison_program(t_poison: float) -> SimProgram:
    """Eight hops that reschedule themselves one time unit on, until the
    first at or past ``t_poison`` emits at -inf: the front then holds a
    non-finite time, which the cheap fault word names."""
    prog = SimProgram("poison", config=Config(max_batch_len=4, capacity=64,
                                              max_emit=1))

    @prog.handler("HOP", lookahead=1.0, emits=True)
    def hop(state, t, arg):
        e = torch.zeros((1, 2 + ARG_WIDTH), dtype=torch.float32,
                        device=t.device)
        e[0, 0] = torch.where(t >= t_poison, -math.inf, 1.0)
        e[0, 2] = arg[0]
        return state + 1, e

    for i in range(8):
        prog.schedule(0.5 * i, "HOP", arg=[float(i)])
    return prog


@pytest.mark.parametrize("case", ["cheap_fault", "overflow_error"])
def test_fault_stops_at_the_same_step(case):
    if case == "cheap_fault":
        make = lambda: _poison_program(9.0)  # noqa: E731
        kw = dict(validate="cheap")
        want_word = FAULT_TIME_NONFINITE
    else:
        make = lambda: storm_program(16)  # noqa: E731
        kw = dict(overflow="error")
        want_word = FAULT_OVERFLOW
    raised = {}
    for loop in ("eager", "captured"):
        with pytest.raises(EngineFaultError) as err:
            _run(make(), torch.zeros((), dtype=torch.int32), loop, **kw)
        raised[loop] = (err.value.fault_word, err.value.fault_step)
    assert raised["captured"] == raised["eager"]
    assert raised["eager"][0] & want_word
    assert raised["eager"][1] > 0


@pytest.mark.parametrize("backend", ["gloo", "mpi"])
def test_devices_capture_on_a_card_needs_nccl(backend):
    """The captured loop's one refusal: the sharded engine's
    ``placement="devices"`` on a CUDA device over a group that is not
    NCCL's, named in the message (``tests/test_torch_devices.py`` drives
    it through a gloo rank's build)."""
    with pytest.raises(ValueError, match=f"backend '{backend}'"):
        tsharded.check_captured_backend(torch.device("cuda"), backend)
    tsharded.check_captured_backend(torch.device("cuda"), "nccl")
    tsharded.check_captured_backend(torch.device("cpu"), backend)


def test_only_chunk_reads_inside_the_loop(monkeypatch):
    """With every host read refused inside a step, a captured run reads
    the host once a chunk, plus the run's exit reads."""
    reads = []

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
    res, counts, _ = _run(tphold.build_program(**PHOLD),
                          tphold.initial_state(PHOLD["num_lps"]),
                          "captured", validate="cheap", overflow="error",
                          **TIERS)
    chunks = math.ceil(res.batches / CHUNK)
    assert counts["loop_syncs"] == chunks
    # The chunk reads, then the exit read of (dropped, fault word).
    assert len(reads) == chunks + 1 == counts["host_syncs"]
    assert counts["cond_reads"] > res.batches


def _reads_program() -> SimProgram:
    prog = SimProgram("reads", config=Config(max_batch_len=2, capacity=16,
                                             max_emit=1))

    def peek(state, t, arg):
        if state.item() > 1:                 # a host read
            return state + 2
        return state + 1

    prog.register("PEEK", peek, lookahead=1.0)
    for i in range(4):
        prog.schedule(float(i), "PEEK")
    return prog


def test_uncapturable_handler_raises_naming_it():
    eager, _, _ = _run(_reads_program(), torch.zeros((), dtype=torch.int32),
                       "eager")
    assert int(eager.state) == 6
    with pytest.raises(capture.CaptureError, match="'PEEK'"):
        _run(_reads_program(), torch.zeros((), dtype=torch.int32),
             "captured")


def test_fold_counts_launches_by_body():
    """A chunk's counters become ``COUNTS`` and ``LAUNCHES``: a body's
    recorded launches times its executions, launches outside any body
    times the replays."""
    ctx = object.__new__(capture.CaptureContext)
    ctx.counters = torch.zeros(8, dtype=torch.int64)
    ctx.slots = {"count:flush": 1, "body:1": 2, "body:2": 3}
    ctx.next_slot = 4
    mod = "repro_torch.kernels.queue_front"
    ctx.own_launches = {2: {(mod, "window_extract"): 1},
                        3: {(mod, "front_merge"): 2}}
    ctx.outside_launches = {(mod, "front_merge"): 1}
    tq.COUNTS.clear()
    tqf.reset_launches()
    ctx.fold([0, 3, 5, 2], replays=7)
    assert tq.COUNTS["flush"] == 3
    assert tqf.LAUNCHES == {"window_extract": 5, "front_merge": 2 * 2 + 7}
    tqf.reset_launches()
