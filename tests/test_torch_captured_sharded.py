"""The sharded engine's captured loop (``shards=N, loop="captured"``,
``placement="serial"``) on the CPU.

On the CPU the captured step runs eagerly, its branches read on the
host (``repro_torch.core.capture.EmulateContext``), with one read of the
loop's guard a chunk: JAX's sharded ``while_loop``, whose body is
unrolled per shard, each shard's refill and pre-flush a conditional of
its own.  Every sharded entry of ``tests/_parity.py``'s
``ALL_BACKENDS`` and ``STREAM_BACKENDS`` runs captured and is held bit
for bit to the port's eager sharded run (state leaves, events, batches,
dropped, final_time, emitted, pending, ingested, shed, the word
histogram, the fence, every field of every shard's queue and the global
counters; the engine's ``COUNTS`` and the queue kernels' launches) and
to JAX's sharded engine on the same program (``queue_kernels="xla"``),
run once, in a child process, with ``--xla_backend_optimization_level=
0`` (JAX compiles each shard's body: seconds a shard).  The ``fused``
entries are held to JAX's ``switch`` run at the same shard count, as
``tests/test_torch_captured.py`` holds its dispatch modes to one JAX
run: JAX's own parity tests pin its modes to each other.  A fault in one
shard and ``overflow="error"`` stop the captured loop at the eager
loop's step with its word; a checkpointed run crashed and resumed
captures once; inside the loop only the chunk reads reach the host.
Tolerance: exact.
"""

import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import _parity
from repro_torch.api import EngineFaultError
from repro_torch.core import capture
from repro_torch.core import engine as tengine
from repro_torch.core import program as tprogram
from repro_torch.core import queue as tq
from repro_torch.core import sharded as tsharded
from repro_torch.core.validate import FAULT_OVERFLOW, FAULT_TIME_NONFINITE
from repro_torch.examples import phold as tphold
from repro_torch.kernels import queue_front as tqf
from repro_torch import stream as tstream
from repro_torch.testing.faults import SimulatedCrash, storm_program

from test_torch_captured import _poison_program

ROOT = pathlib.Path(__file__).resolve().parent.parent
CHUNK = 16       # small, so that runs and segments end mid-chunk
# PHOLD on tiers where the refill, flush and run paths fire in each
# shard (``tests/test_torch_captured.py``'s).
PHOLD = dict(num_lps=24, t_stop=30.0, capacity=64)
TIERS = dict(front_cap=8, stage_cap=4, num_runs=2)
ARRIVALS = 16
NOT_COUNTED = ("host_syncs", "loop_syncs", "cond_reads")


def _serial_entries(backends) -> dict:
    return {label: {k: v for k, v in kw.items() if k != "backend"}
            for label, kw in backends.items()
            if kw.get("shards") and kw.get("placement", "serial") == "serial"}


CLOSED = _serial_entries(_parity.ALL_BACKENDS)
STREAMED = _serial_entries(_parity.STREAM_BACKENDS)


def _jax_twin(label: str) -> str:
    """The entry whose JAX run holds ``label``'s: itself, or for a
    ``fused`` entry the ``switch`` one at the same shard count."""
    return label.replace("device/fused-", "device/tiered3-")


JAX_LABELS = sorted({_jax_twin(label) for label in {**CLOSED, **STREAMED}})


def _source(pkg):
    """16 PHOLD arrivals (LP ids as ``arg[0]``), as
    ``tests/test_torch_captured_modes.py`` streams them."""
    return pkg.PoissonSource(1.5, ARRIVALS, seed=1, grid=0.25, t0=0.0,
                             type_id=0, block_size=8)


# ---------------------------------------------------------------------------
# JAX's sharded engine, in a child process
# ---------------------------------------------------------------------------

def _write_jax(path: str) -> None:
    """Every entry of :data:`CLOSED` and :data:`STREAMED` on JAX's
    sharded engine: state, counters, word histogram and every shard's
    queue fields with the global counters."""
    sys.path.insert(0, str(ROOT / "examples"))
    import phold as jphold

    from repro import stream as jstream

    out = {}
    for label in JAX_LABELS:
        kw = {**CLOSED, **STREAMED}[label]
        run_kw = (dict(arrivals=_source(jstream)) if label in STREAMED
                  else {})
        res = jphold.build_program(**PHOLD).build(
            backend="device", queue_kernels="xla", **TIERS, **kw).run(
                jphold.initial_state(PHOLD["num_lps"]), **run_kw)
        q = res.raw["final_queue"]
        for name in ("events", "batches", "dropped", "emitted", "pending",
                     "ingested", "shed"):
            out[f"{label}|{name}"] = np.asarray(int(getattr(res, name)))
        out[f"{label}|final_time"] = np.float32(res.final_time)
        out[f"{label}|word_counts"] = np.asarray(res.word_counts)
        for k, v in res.state.items():
            out[f"{label}|state.{k}"] = np.asarray(v)
        for i, shard in enumerate(q.shards):
            for name in shard._fields:
                out[f"{label}|q{i}.{name}"] = np.asarray(getattr(shard, name))
        for name in ("size", "next_seq", "dropped"):
            out[f"{label}|g.{name}"] = np.asarray(getattr(q, name))
    np.savez(path, entries=json.dumps({**CLOSED, **STREAMED},
                                      sort_keys=True),
             labels=json.dumps(JAX_LABELS), **out)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_sharded") / "jax.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_backend_optimization_level=0")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_captured_sharded as t; t._write_jax(sys.argv[2])")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "tests"), path], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

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


def _fence(res):
    if "bound_t" not in res.raw:
        return None
    return (np.float32(res.raw["bound_t"]).item(), int(res.raw["bound_seq"]))


def assert_same_sharded_run(got, want):
    """Port against port: state leaves, counters, word histogram, fence,
    and every field of every shard's queue with the global counters."""
    assert got.state.keys() == want.state.keys()
    for k in want.state:
        assert torch.equal(got.state[k], want.state[k]), k
    for name in ("events", "batches", "dropped", "emitted", "pending",
                 "spilled", "ingested", "shed", "fault_word"):
        assert getattr(got, name) == getattr(want, name), name
    assert np.float32(got.final_time) == np.float32(want.final_time)
    np.testing.assert_array_equal(got.word_counts, want.word_counts)
    assert _fence(got) == _fence(want)
    gq, wq = got.raw["final_queue"], want.raw["final_queue"]
    assert len(gq.shards) == len(wq.shards)
    for i, (a, b) in enumerate(zip(gq.shards, wq.shards)):
        for name in a._fields:
            assert torch.equal(getattr(a, name), getattr(b, name)), (i, name)
    for name in ("size", "next_seq", "dropped"):
        assert torch.equal(getattr(gq, name), getattr(wq, name)), name


def assert_jax_parity(jax_runs, label, res):
    """A port run against JAX's run of ``label`` (or of its twin,
    :func:`_jax_twin`), field for field."""
    def want(key):
        return jax_runs[f"{_jax_twin(label)}|{key}"]

    for name in ("events", "batches", "dropped", "emitted", "pending",
                 "ingested", "shed"):
        assert getattr(res, name) == int(want(name)), (label, name)
    assert np.float32(res.final_time) == want("final_time"), label
    np.testing.assert_array_equal(res.word_counts, want("word_counts"))
    for k, v in res.state.items():
        np.testing.assert_array_equal(v.numpy(), want(f"state.{k}"),
                                      err_msg=f"{label} state {k}")
    q = res.raw["final_queue"]
    for i, shard in enumerate(q.shards):
        for name in shard._fields:
            np.testing.assert_array_equal(
                getattr(shard, name).numpy(), want(f"q{i}.{name}"),
                err_msg=f"{label} shard {i} {name}")
    for name in ("size", "next_seq", "dropped"):
        assert int(getattr(q, name)) == int(want(f"g.{name}")), (label, name)


def _captured_against_eager(make_prog, make_state, run_kw=None, **build_kw):
    """The eager and the captured run of one configuration, held to each
    other; returns the captured run, its counts and its engine."""
    eager, ce, le, _ = _run(make_prog(), make_state(), "eager", run_kw,
                            **build_kw)
    capt, cc, lc, eng = _run(make_prog(), make_state(), "captured", run_kw,
                             **build_kw)
    assert_same_sharded_run(capt, eager)
    assert _rare(cc) == _rare(ce)
    assert lc == le
    return capt, cc, eng


def _phold():
    return tphold.build_program(**PHOLD)


def _phold_state():
    return tphold.initial_state(PHOLD["num_lps"])


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

def test_jax_child_ran_the_matrix_entries(jax_runs):
    assert json.loads(str(jax_runs["entries"])) == {**CLOSED, **STREAMED}
    assert json.loads(str(jax_runs["labels"])) == [
        "device/tiered3-2shard", "device/tiered3-2shard+stream",
        "device/tiered3-4shard"]
    assert sorted(CLOSED) == ["device/fused-2shard", "device/tiered3-2shard",
                              "device/tiered3-4shard"]
    assert sorted(STREAMED) == ["device/fused-2shard+stream",
                                "device/tiered3-2shard+stream"]


@pytest.mark.parametrize("label", sorted(CLOSED))
def test_parity_entry_matches_jax_and_eager(jax_runs, label):
    """PHOLD under the entry: the captured run against the eager one and
    JAX's, every shard's rare paths firing, one loop read a chunk and
    ``front_merge`` once a shard a super-step."""
    kw = CLOSED[label]
    capt, cc, eng = _captured_against_eager(_phold, _phold_state,
                                            **kw, **TIERS)
    assert_jax_parity(jax_runs, label, capt)
    for name in ("flush", "refill_kway", "refill_main_only", "to_run",
                 "head_merge", "suffix_append"):
        assert cc.get(name, 0) > 0, name
    assert cc["loop_syncs"] == math.ceil(capt.batches / CHUNK)
    assert eng.captures == 1
    if kw.get("dispatch_mode") == "fused":
        assert cc["fused_hot"] + cc.get("fused_fallback", 0) == capt.batches


@pytest.mark.parametrize("label", sorted(STREAMED))
def test_stream_entry_matches_jax_and_eager(jax_runs, label):
    """16 arrivals streamed into the shards: the segment boundaries'
    absorbs write into the one graph's carry."""
    capt, cc, eng = _captured_against_eager(
        _phold, _phold_state, dict(arrivals=_source(tstream)),
        **STREAMED[label], **TIERS)
    assert_jax_parity(jax_runs, label, capt)
    assert capt.ingested == ARRIVALS and capt.shed == 0
    assert cc["absorb"] > 1 and cc["loop_syncs"] > cc["absorb"]
    assert eng.captures == 1


@pytest.mark.parametrize("case", ["cheap_fault", "overflow_error"])
def test_fault_stops_at_the_same_step(case):
    """A non-finite time emitted into one shard under ``validate=
    "cheap"`` and an overflow under ``overflow="error"`` stop the
    captured sharded loop at the eager loop's step, with its word."""
    if case == "cheap_fault":
        make = lambda: _poison_program(9.0)  # noqa: E731
        kw, want_word = dict(validate="cheap"), FAULT_TIME_NONFINITE
    else:
        make = lambda: storm_program(16)  # noqa: E731
        kw, want_word = dict(overflow="error"), FAULT_OVERFLOW
    raised = {}
    for shards in (2, 4):
        for loop in ("eager", "captured"):
            with pytest.raises(EngineFaultError) as err:
                _run(make(), torch.zeros((), dtype=torch.int32), loop,
                     shards=shards, **kw)
            raised[shards, loop] = (err.value.fault_word,
                                    err.value.fault_step)
        assert raised[shards, "captured"] == raised[shards, "eager"]
    word, step = raised[2, "eager"]
    assert word & want_word and step > 0
    assert raised[4, "eager"] == (word, step)


def test_fault_in_one_shard_between_segments(tmp_path):
    """A NaN written into shard 1's front at a segment boundary: the
    validated captured loop stops where the eager one does."""
    def corrupt(seg, state, queue, stats):
        if seg == 1:
            q = queue.shards[1]
            f_times = q.f_times.clone()
            f_times[0] = float("nan")
            shards = (queue.shards[0], q._replace(f_times=f_times))
            return state, queue._replace(shards=shards), stats
        return None

    raised = {}
    for loop in ("eager", "captured"):
        with pytest.raises(EngineFaultError) as err:
            _run(_phold(), _phold_state(), loop,
                 dict(checkpoint_every=10, checkpoint_dir=str(tmp_path / loop),
                      _segment_hook=corrupt),
                 shards=2, validate="cheap", **TIERS)
        raised[loop] = (err.value.fault_word, err.value.fault_step)
    assert raised["captured"] == raised["eager"]
    assert raised["eager"][0] != 0 and raised["eager"][1] == 10


def test_crash_and_resume_captures_once(tmp_path):
    """Checkpointed every 10 super-steps (mid-chunk), crashed after the
    third segment and resumed in the same engine: equal to the eager
    loop's straight run, in one capture for both runs."""
    straight, _, _, _ = _run(_phold(), _phold_state(), "eager", shards=2,
                             validate="cheap", **TIERS)
    sim = _phold().build(device="cpu", shards=2, validate="cheap",
                         loop="captured", **TIERS)
    sim.engine.chunk = CHUNK
    run_kw = dict(checkpoint_every=10, checkpoint_dir=str(tmp_path))

    def crash(seg, state, queue, stats):
        if seg == 3:
            raise SimulatedCrash("stop")

    with pytest.raises(SimulatedCrash):
        sim.run(_phold_state(), _segment_hook=crash, **run_kw)
    resumed = sim.run(_phold_state(), resume_from="latest", **run_kw)
    assert_same_sharded_run(resumed, straight)
    assert sim.engine.captures == 1


def test_stacked_queue_refused_under_serial():
    eng = tsharded.ShardedDeviceEngine.from_program(
        _phold(), shards=2, device="cpu", loop="captured", **TIERS)
    stacked = tsharded.stack_sharded_queue(
        eng.initial_queue(_phold().scheduled_events()))
    with pytest.raises(ValueError, match="placement='devices'"):
        eng.run(_phold_state(), stacked)


@pytest.mark.parametrize("path", ["closed", "stream"])
def test_only_chunk_reads_inside_the_loop(path, monkeypatch):
    """With every host read refused inside a step (validated, and
    ``overflow="error"``), the loop reads the host only at a chunk's
    end: ``loop_syncs`` equals the chunk reads."""
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
    for mod in (capture, tq, tengine, tprogram, tsharded):
        for name in real:
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, guarded(real[name]))
    chunk_read = tengine.DeviceEngine._chunk_read

    def counted(self, carry, extra=None):
        chunk_reads.append(1)
        return chunk_read(self, carry, extra)

    monkeypatch.setattr(tengine.DeviceEngine, "_chunk_read", counted)
    run_kw = ({} if path == "closed" else
              dict(arrivals=_source(tstream)))
    res, counts, _, _ = _run(_phold(), _phold_state(), "captured", run_kw,
                             shards=4 if path == "closed" else 2,
                             validate="cheap", overflow="error", **TIERS)
    assert counts["loop_syncs"] == len(chunk_reads) > 0
    assert counts["cond_reads"] > res.batches
    assert len(reads) == counts["host_syncs"] > counts["loop_syncs"]
    if path == "closed":
        assert counts["loop_syncs"] == math.ceil(res.batches / CHUNK)
