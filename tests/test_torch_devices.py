"""The sharded engine's ``placement="devices"`` in ``repro_torch``: one
shard queue a rank, four gloo ranks on the CPU.

The module starts four rank processes (``OMP_NUM_THREADS=1``,
``device="cpu"``) in one gloo group and, beside them, a JAX child on 4
forced host devices (``XLA_FLAGS=--xla_force_host_platform_device_count
=4``), once.  Each rank runs every case below and writes, per case, "ok"
or the failure; the tests read all four ranks' verdicts.  The cases are
those of JAX's devices tests (``tests/test_sharded_engine.py``): the
92%-occupancy churn at seeds 0 and 3, ``validate="cheap"`` (a clean run,
and a fault injected into one rank's shard that every rank catches), the
stacked snapshot through the checkpoint manager and ``place_queue``, a
checkpointed run crashed and resumed, PHOLD under the parity matrix's
``device/tiered3-4shard-devices`` and ``device/fused-4shard-devices``
entries, and the open admission stream of
``device/tiered3-4shard-devices+stream``.  Each devices run is held to
the port's serial 4-shard run and its single queue, bit for bit: state
leaves, events, batches, dropped, emitted, final_time, word_counts and
the flat residual queue with its global counters.  A common super-step
reads the host four times a rank and makes two collectives (three
validated), counted in ``COUNTS``.  JAX's devices placement runs the
churn at seeds 0 and 3; its state and its final stacked queue, carried
into the port with ``queue_from_arrays``, are held to the ranks' bit for
bit.

The captured loop (``loop="captured"``, JAX's ``while_loop`` inside its
``shard_map``) runs the churn at seeds 0 and 3, held to the eager
devices run, the serial run and JAX's; a fault emitted into one rank's
shard, caught on every rank at the eager loop's step; the checkpointed
run crashed and resumed through ``place_queue`` in one capture; the
``+stream`` entry; and its reads and collectives: one loop read a chunk
(``CHUNK`` steps), and 2 collectives a replay (3 validated), so as many
as the eager run's when the run ends on a chunk's end.  On a CUDA
device it needs NCCL: the build-time refusal over gloo is driven here
with a stand-in device check.  Tolerance: exact.
"""

import datetime
import json
import os
import socket
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
# tests/_parity.py's *-devices entries, which it registers only when JAX
# sees 4 devices; the JAX child reports _parity's own to hold them here.
DEVICES_ENTRIES = {
    "device/tiered3-4shard-devices": dict(
        backend="device", shards=4, placement="devices"),
    "device/fused-4shard-devices": dict(
        backend="device", shards=4, placement="devices",
        dispatch_mode="fused"),
    "device/tiered3-4shard-devices+stream": dict(
        backend="device", shards=4, placement="devices"),
}
PHOLD = dict(num_lps=24, t_stop=30.0, capacity=256)
TIERS = dict(front_cap=16, stage_cap=8, num_runs=2)
EVERY = 8
CHUNK = 16       # the captured loop's steps a host read, small: runs end
                 # mid-chunk
JAX_SEEDS = (0, 3)


# ---------------------------------------------------------------------------
# The ranks' cases (each runs on every rank, alike)
# ---------------------------------------------------------------------------

def _agree(arrays, msg):
    """Every rank holds the same replicated values: one digest a rank,
    gathered, against rank 0's."""
    import hashlib

    import torch.distributed as dist

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    digests = [None] * WORLD
    dist.all_gather_object(digests, h.hexdigest())
    assert len(set(digests)) == 1, (msg, digests)


def _result_equal(res, refs, msg):
    """A devices ``RunResult`` against the ``RunResult``s ``refs``
    (label -> result, or a zero-arg function giving it): state leaves,
    counters, word histogram and the flat residual queue with its
    counters.  Every rank gathers the flat views of ``res`` and of the
    given results (a devices run's is a collective) and shows it holds
    the same state and counters; rank 0 runs the functions and
    compares."""
    import torch.distributed as dist

    from _torch_churn import assert_flat_equal, flat_of

    got = flat_of(res.raw["final_queue"])
    flats = {label: flat_of(ref.raw["final_queue"])
             for label, ref in refs.items() if not callable(ref)}
    names = ("events", "batches", "dropped", "emitted", "pending",
             "ingested", "shed", "fault_word")
    _agree([res.state[k].numpy() for k in sorted(res.state)]
           + [getattr(res, n) for n in names]
           + [np.float32(res.final_time), res.word_counts], msg)
    if dist.get_rank() != 0:
        return
    for label, ref in refs.items():
        ref = ref() if callable(ref) else ref
        for k in sorted(ref.state):
            np.testing.assert_array_equal(res.state[k].numpy(),
                                          ref.state[k].numpy(),
                                          err_msg=f"{msg} {label} {k}")
        for name in names:
            assert getattr(res, name) == getattr(ref, name), \
                (msg, label, name)
        assert np.float32(res.final_time) == np.float32(ref.final_time), \
            (msg, label)
        np.testing.assert_array_equal(res.word_counts, ref.word_counts,
                                      f"{msg} {label}")
        want = flats.get(label) or flat_of(ref.raw["final_queue"])
        assert_flat_equal(got, want, f"{msg} {label}")


def _held_to(run, refs, msg):
    """A devices engine run ``(state, queue, stats)`` against the
    serial and single runs ``refs`` (label -> zero-arg function), as
    :func:`_result_equal` holds a ``RunResult``."""
    import torch.distributed as dist

    from _torch_churn import assert_flat_equal, assert_stats_equal, flat_of

    s1, q1, st1 = run
    got = flat_of(q1)
    _agree([s1["count"].numpy(), s1["checksum"].numpy()]
           + [np.asarray(st1[k]) for k in ("batches", "events", "dropped",
                                          "emitted", "time", "word_counts")],
           msg)
    if dist.get_rank() != 0:
        return
    for label, ref in refs.items():
        s0, q0, st0 = ref()
        assert int(s1["count"]) == int(s0["count"]), (msg, label)
        assert int(s1["checksum"]) == int(s0["checksum"]), (msg, label)
        assert_stats_equal(st1, st0, f"{msg} {label}")
        assert_flat_equal(got, flat_of(q0), f"{msg} {label}")


def _churn(seed, rank, out, loop="eager"):
    import torch

    from _torch_churn import engine, run_engine, seed_events
    from repro_torch.core import queue as tq

    events = seed_events(seed, 48, 12)
    eng = engine(4, placement="devices", loop=loop)
    eng.chunk = CHUNK
    run = run_engine(eng, events)
    q = run[1]
    assert q.placed and q.q.f_times.to_local().shape[0] == 1
    whole = q.gathered()
    serial = []

    def serial_run():
        serial.append(run_engine(engine(4), events))
        return serial[0]

    refs = {"single": lambda: run_engine(engine(0), events),
            "serial": serial_run}
    if loop == "captured":
        assert eng.captures == 1
        s0, q0, st0 = run_engine(engine(4, placement="devices"), events)
        eager = (s0, q0.gathered(), st0)
        refs["eager devices"] = lambda: eager
    _held_to(run, refs, f"seed {seed} {loop}")
    if rank != 0:
        return
    for i, shard in enumerate(serial[0][1].shards):
        a, b = (tq.tiered3_queue_to_flat(whole.shard(i)),
                tq.tiered3_queue_to_flat(shard))
        for field in a._fields:
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
    if seed in JAX_SEEDS:
        s, _, st = run
        name = f"churn{seed}" + ("_captured" if loop == "captured" else "")
        np.savez(os.path.join(out, f"{name}.npz"),
                 count=int(s["count"]), checksum=int(s["checksum"]),
                 **{f"stats.{k}": np.asarray(torch.as_tensor(st[k]))
                    for k in ("batches", "events", "dropped", "time",
                              "word_counts")},
                 **{f"q.{k}": v.numpy()
                    for k, v in zip(whole.q._fields, whole.q)},
                 **{f"g.{k}": int(getattr(whole, k))
                    for k in ("size", "next_seq", "dropped")})


def case_churn_0(rank, out):
    _churn(0, rank, out)


def case_churn_3(rank, out):
    _churn(3, rank, out)


def case_captured_churn_0(rank, out):
    _churn(0, rank, out, "captured")


def case_captured_churn_3(rank, out):
    _churn(3, rank, out, "captured")


def _poison_program(t_poison: float):
    """``tests/test_torch_captured.py``'s eight hops, the first at or past
    ``t_poison`` emitting at -inf into the shard of its hop id."""
    import math

    import torch

    from repro_torch.api import ARG_WIDTH, Config, SimProgram

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


def case_captured_fault(rank, out):
    """A non-finite time emitted into one rank's shard mid-run: the
    validated captured loop stops every rank at the eager loop's step,
    with its word."""
    import torch

    from repro_torch.core.validate import (
        FAULT_TIME_NONFINITE,
        EngineFaultError,
    )

    raised = {}
    for loop in ("eager", "captured"):
        sim = _poison_program(9.0).build(
            device="cpu", shards=4, placement="devices", validate="cheap",
            loop=loop)
        sim.engine.chunk = CHUNK
        try:
            sim.run(torch.zeros((), dtype=torch.int32))
        except EngineFaultError as err:
            raised[loop] = (err.fault_word, err.fault_step)
        else:
            raise AssertionError(f"{loop}: the fault was not caught")
    assert raised["captured"] == raised["eager"], raised
    assert raised["eager"][0] & FAULT_TIME_NONFINITE
    assert raised["eager"][1] > 0
    _agree([np.asarray(raised["captured"])], "captured fault")


def case_captured_resume(rank, out):
    """The captured devices run checkpointed every ``EVERY`` super-steps
    (mid-chunk), crashed after two segments and resumed through
    ``place_queue`` in the same engine: equal to its straight run and to
    the eager devices run, in one capture."""
    from repro_torch.examples import phold as tphold
    from repro_torch.testing.faults import SimulatedCrash

    def sim(**kw):
        return tphold.build_program(**PHOLD).build(
            device="cpu", shards=4, placement="devices", **TIERS, **kw)

    def crash(seg, state, queue, stats):
        if seg == 2:
            raise SimulatedCrash("injected crash at segment 2")

    eager = sim().run(tphold.initial_state(24))
    devices = sim(loop="captured")
    devices.engine.chunk = CHUNK
    straight = devices.run(tphold.initial_state(24))
    ckpt = os.path.join(out, "captured_resume")
    try:
        devices.run(tphold.initial_state(24), checkpoint_every=EVERY,
                    checkpoint_dir=ckpt, _segment_hook=crash)
    except SimulatedCrash:
        pass
    else:
        raise AssertionError("the crash never fired")
    resumed = devices.run(tphold.initial_state(24), checkpoint_every=EVERY,
                          checkpoint_dir=ckpt, resume_from="latest")
    assert devices.engine.captures == 1
    _result_equal(resumed, {"straight": straight}, "captured resumed")
    _result_equal(straight, {"eager": eager}, "captured straight")


def case_captured_stream(rank, out):
    """``device/tiered3-4shard-devices+stream`` in the captured loop,
    against the eager devices run and the serial run."""
    from repro_torch.api import Config
    from repro_torch.serving import scenarios as tsc
    from repro_torch.stream import PoissonSource

    def run(**kw):
        prog = tsc.build_open_admission_program(
            num_slots=4, num_requests=40, max_decode=5,
            config=Config(max_batch_len=3, capacity=256, max_emit=2))
        sim = prog.build(device="cpu", **kw)
        sim.engine.chunk = CHUNK
        return sim.run(
            tsc.initial_state(4), arrivals=PoissonSource(
                1.5, 40, seed=42, grid=0.25, t0=0.0, type_id=0,
                block_size=16))

    kw = DEVICES_ENTRIES["device/tiered3-4shard-devices+stream"]
    res = run(loop="captured", **kw)
    eager = run(**kw)
    assert res.ingested == 40 and res.shed == 0
    _result_equal(res, {"eager": eager, "serial": lambda: run(shards=4)},
                  "captured stream")


def case_captured_syncs(rank, out):
    """PHOLD with every event in the fronts, captured: one loop read a
    chunk a rank; 2 collectives a replay (3 validated), so as many as
    the eager run's when the run ends on a chunk's end, and 2 (3) more
    for each replay past the end of the last chunk."""
    from repro_torch.core import queue as tq
    from repro_torch.examples import phold as tphold

    chunk = 4
    for validate, per_step in (("off", 2), ("cheap", 3)):
        for batches in (12, 14):
            counts = {}
            for loop in ("eager", "captured"):
                prog = tphold.build_program(num_lps=16, t_stop=1e6,
                                            capacity=1024)
                sim = prog.build(device="cpu", shards=4, placement="devices",
                                 validate=validate, loop=loop)
                sim.engine.chunk = chunk
                tq.COUNTS.clear()
                res = sim.run(tphold.initial_state(16), max_batches=batches)
                counts[loop] = dict(tq.COUNTS)
                assert res.batches == batches
            c, e = counts["captured"], counts["eager"]
            chunks = -(-batches // chunk)
            assert c["loop_syncs"] == chunks, c
            assert c["collectives"] == e["collectives"] + per_step * (
                chunks * chunk - batches), (validate, batches, c, e)
            assert e["loop_syncs"] == 4 * batches, e


def case_nccl_only(rank, out):
    """On a CUDA device the captured devices placement needs NCCL: with
    the device check standing in for a card, a gloo group's build raises
    naming its backend, before any launch."""
    from repro_torch.core import sharded as tsharded
    from repro_torch.examples import phold as tphold
    from repro_torch.kernels import queue_front as tqf

    tqf.reset_launches()
    real = tsharded._on_card
    tsharded._on_card = lambda device: True
    try:
        try:
            tphold.build_program(**PHOLD).build(
                device="cpu", shards=4, placement="devices",
                loop="captured")
        except ValueError as err:
            assert "'gloo'" in str(err) and "NCCL" in str(err), err
        else:
            raise AssertionError("gloo on a card was not refused")
        # The eager loop takes any backend.
        tphold.build_program(**PHOLD).build(device="cpu", shards=4,
                                            placement="devices")
        # Past the check (as over NCCL), the step is captured in the
        # thread_local mode: NCCL's watchdog thread queries its events
        # meanwhile.
        check = tsharded.check_captured_backend
        tsharded.check_captured_backend = lambda device, backend: None
        try:
            sim = tphold.build_program(**PHOLD).build(
                device="cpu", shards=4, placement="devices",
                loop="captured")
            assert sim.engine.capture_mode == "thread_local"
        finally:
            tsharded.check_captured_backend = check
    finally:
        tsharded._on_card = real
    assert not any(tqf.LAUNCHES.values()), tqf.LAUNCHES


def case_validated(rank, out):
    from _torch_churn import engine, run_engine, seed_events

    events = seed_events(11, 48, 12)
    run = run_engine(engine(4, placement="devices", validate="cheap"),
                     events)
    assert int(run[2]["fault_word"]) == 0
    _held_to(run, {"serial": lambda: run_engine(
        engine(4, validate="cheap"), events)}, "validated")


def case_fault(rank, out):
    """A NaN time in shard 1's front, on rank 1 alone after placing:
    every rank reads the serial layout's fault word and audit, and the
    entry audit stops every rank's run before any event."""
    import torch

    from _torch_churn import engine, seed_events, state0
    from repro_torch.core import validate as V
    from repro_torch.core.sharded import ShardedQueue
    from repro_torch.core.validate import EngineFaultError

    for validate in ("cheap", "full"):
        eng = engine(4, placement="devices", validate=validate)
        whole = eng.initial_queue(seed_events(0, 48, 12)).gathered()
        f_times = whole.q.f_times.clone()
        f_times[1, 0] = float("nan")
        bad = whole._replace(q=whole.q._replace(f_times=f_times))
        serial = ShardedQueue(shards=bad.shards, size=bad.size,
                              next_seq=bad.next_seq, dropped=bad.dropped)
        word = int(V.sharded_fault_bits(serial))
        placed = eng.place_queue(bad)
        local = placed.q.f_times.to_local()
        assert bool(torch.isnan(local).any()) == (rank == 1)
        assert word != 0 and int(eng._cheap_fault_bits(placed)) == word
        assert V.full_audit(placed) == V.full_audit(serial)
        try:
            eng.run(state0(), placed, max_batches=48)
        except EngineFaultError as err:
            assert err.fault_word & word and err.fault_step == 0, validate
        else:
            raise AssertionError(f"{validate}: the fault was not caught")


def case_snapshot(rank, out):
    """JAX's stacked snapshot round trip: a placed queue through the
    checkpoint manager (rank 0 writes), restored whole into another
    queue's structure, re-placed, and run on."""
    from _torch_churn import engine, flat_of, seed_events, state0
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import queue as tq

    eng = engine(4, placement="devices")
    _, queue, _ = eng.run(state0(), eng.initial_queue(
        seed_events(2, 48, 12)), max_batches=8)
    mgr = CheckpointManager(os.path.join(out, "snapshot"))
    mgr.save(0, {"queue": queue})
    template = eng.initial_queue(seed_events(9, 48, 12))
    restored, _ = mgr.restore({"queue": template})
    assert not restored["queue"].placed
    back = eng.place_queue(restored["queue"])
    assert back.placed
    fa, fb = flat_of(queue), flat_of(back)
    for field in fa._fields:
        np.testing.assert_array_equal(getattr(fa, field),
                                      getattr(fb, field))
    mine = tq.queue_to_arrays(queue.q._make(x.to_local() for x in queue.q))
    again = tq.queue_to_arrays(back.q._make(x.to_local() for x in back.q))
    for name, arr in mine.items():
        np.testing.assert_array_equal(arr, again[name], err_msg=name)
    _, _, stats = eng.run(state0(), back, max_batches=4)
    assert stats["batches"] > 0


def case_resume(rank, out):
    """``device/tiered3-4shard-devices`` of the resume axis: PHOLD crashed
    after two checkpointed segments resumes bit for bit."""
    from repro_torch.examples import phold as tphold
    from repro_torch.testing.faults import SimulatedCrash

    def sim(**kw):
        return tphold.build_program(**PHOLD).build(device="cpu", shards=4,
                                                   **TIERS, **kw)

    def crash(seg, state, queue, stats):
        if seg == 2:
            raise SimulatedCrash("injected crash at segment 2")

    devices = sim(placement="devices")
    straight = devices.run(tphold.initial_state(24))
    ckpt = os.path.join(out, "resume")
    try:
        devices.run(tphold.initial_state(24), checkpoint_every=EVERY,
                    checkpoint_dir=ckpt, _segment_hook=crash)
    except SimulatedCrash:
        pass
    else:
        raise AssertionError("the crash never fired")
    resumed = devices.run(tphold.initial_state(24), checkpoint_every=EVERY,
                          checkpoint_dir=ckpt, resume_from="latest")
    _result_equal(resumed, {"straight": straight}, "resumed")
    _result_equal(straight, {"serial": lambda: sim().run(
        tphold.initial_state(24))}, "straight")


def _phold_entry(label):
    from repro_torch.examples import phold as tphold

    def run(**kw):
        return tphold.build_program(**PHOLD).build(device="cpu", **kw).run(
            tphold.initial_state(24))

    kw = DEVICES_ENTRIES[label]
    res = run(**kw)
    assert res.events > 0 and res.raw["final_queue"].placed
    serial = {k: v for k, v in kw.items() if k != "placement"}
    single = {k: v for k, v in serial.items() if k != "shards"}
    _result_equal(res, {"serial": lambda: run(**serial),
                        "single": lambda: run(**single)}, label)


def case_phold_switch(rank, out):
    _phold_entry("device/tiered3-4shard-devices")


def case_phold_fused(rank, out):
    _phold_entry("device/fused-4shard-devices")


def case_stream(rank, out):
    """``device/tiered3-4shard-devices+stream``: the open admission
    scenario streamed into the ranks (``tests/test_torch_stream.py``'s
    program and source) against the serial and single streamed runs."""
    from repro_torch.api import Config
    from repro_torch.serving import scenarios as tsc
    from repro_torch.stream import PoissonSource

    def run(**kw):
        prog = tsc.build_open_admission_program(
            num_slots=4, num_requests=40, max_decode=5,
            config=Config(max_batch_len=3, capacity=256, max_emit=2))
        return prog.build(device="cpu", **kw).run(
            tsc.initial_state(4), arrivals=PoissonSource(
                1.5, 40, seed=42, grid=0.25, t0=0.0, type_id=0,
                block_size=16))

    res = run(**DEVICES_ENTRIES["device/tiered3-4shard-devices+stream"])
    assert res.ingested == 40 and res.shed == 0
    _result_equal(res, {"serial": lambda: run(shards=4),
                        "single": run}, "stream")


def case_syncs(rank, out):
    """PHOLD with every event in the fronts: 4 host reads a super-step a
    rank, 2 collectives a super-step (3 validated), nothing else."""
    from repro_torch.core import queue as tq
    from repro_torch.examples import phold as tphold

    for validate, per_step in (("off", 2), ("cheap", 3)):
        seen = {}
        for batches in (12, 24):
            prog = tphold.build_program(num_lps=16, t_stop=1e6,
                                        capacity=1024)
            sim = prog.build(device="cpu", shards=4, placement="devices",
                             validate=validate)
            tq.COUNTS.clear()
            res = sim.run(tphold.initial_state(16), max_batches=batches)
            counts = dict(tq.COUNTS)
            assert res.batches == batches
            assert counts["loop_syncs"] == 4 * batches, counts
            assert set(counts) == {"host_syncs", "loop_syncs",
                                   "collectives"}, counts
            seen[batches] = counts["collectives"]
        assert seen[24] - seen[12] == per_step * 12, (validate, seen)


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


def _rank(rank: int, port: int, out: str) -> None:
    """One rank: every case, its verdict to ``out/rank<r>.json``."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    verdicts = {}
    try:
        for name, case in CASES.items():
            try:
                case(rank, out)
                verdicts[name] = "ok"
            except Exception:  # noqa: BLE001 -- reported to the test
                verdicts[name] = traceback.format_exc()[-3000:]
    finally:
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(verdicts, f)
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# JAX's devices placement, in a child of its own
# ---------------------------------------------------------------------------

def _write_jax(path: str) -> None:
    """JAX's churn at each of :data:`JAX_SEEDS` on 4 forced host devices
    (``test_sharded_engine._engine(4, placement="devices")``): its state,
    stats and final stacked queue, and ``_parity``'s devices entries;
    seed 0's at ``path``, seed 3's beside it (:func:`_jax_path`)."""
    import jax

    import _parity
    import test_sharded_engine as jshard

    assert len(jax.devices()) == 4
    eng = jshard._engine(4, placement="devices")
    entries = {k: v for k, v in {**_parity.ALL_BACKENDS,
                                 **_parity.STREAM_BACKENDS}.items()
               if v.get("placement") == "devices"}
    for seed in JAX_SEEDS:
        events = jshard._seed_events(seed, 48, 12)
        s, q, st = eng.run(jshard._state0(), eng.initial_queue(events),
                           max_batches=48)
        np.savez(_jax_path(path, seed), count=int(s["count"]),
                 checksum=int(s["checksum"]),
                 entries=json.dumps(entries, sort_keys=True),
                 **{f"stats.{k}": np.asarray(st[k])
                    for k in ("batches", "events", "dropped", "time",
                              "word_counts")},
                 **{f"q.{k}": np.asarray(v)
                    for k, v in zip(q.q._fields, q.q)},
                 **{f"g.{k}": int(getattr(q, k))
                    for k in ("size", "next_seq", "dropped")})


def _jax_path(path: str, seed: int) -> str:
    return path if seed == 0 else path.replace(".npz", f"{seed}.npz")


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's verdicts, and the output directory."""
    out = str(tmp_path_factory.mktemp("devices"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_devices as t; "
            "t.{}(*sys.argv[2:])")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format("_rank_main"), str(ROOT / "tests"),
         str(r), str(port), out], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", code.format("_write_jax"),
         str(ROOT / "tests"), os.path.join(out, "jax.npz")],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                                "--xla_backend_optimization_level=0"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    verdicts = []
    for r in range(WORLD):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            verdicts.append(json.load(f))
    return verdicts, out


def _rank_main(rank: str, port: str, out: str) -> None:
    _rank(int(rank), int(port), out)


def _every_rank_ok(ranks, case):
    verdicts, _ = ranks
    bad = {r: v[case] for r, v in enumerate(verdicts) if v[case] != "ok"}
    assert not bad, "\n".join(f"rank {r}: {msg}" for r, msg in bad.items())


@pytest.mark.parametrize("case", ["churn_0", "churn_3"])
def test_churn_matches_serial_and_single_queue(ranks, case):
    _every_rank_ok(ranks, case)


def test_validated_run_matches_serial(ranks):
    _every_rank_ok(ranks, "validated")


def test_fault_on_one_rank_caught_on_every_rank(ranks):
    _every_rank_ok(ranks, "fault")


def test_stacked_snapshot_round_trip_through_place_queue(ranks):
    _every_rank_ok(ranks, "snapshot")


def test_checkpointed_run_resumes_bit_for_bit(ranks):
    _every_rank_ok(ranks, "resume")


@pytest.mark.parametrize("case", ["phold_switch", "phold_fused", "stream"])
def test_parity_matrix_devices_entries(ranks, case):
    _every_rank_ok(ranks, case)


def test_common_super_step_reads_and_collectives(ranks):
    _every_rank_ok(ranks, "syncs")


def test_churn_matches_jax_devices_placement(ranks):
    """JAX's shard_map'd churn at seed 0 against the ranks': state,
    stats and the final stacked queue, carried into the port with
    ``queue_from_arrays``, field by field and as a flat view."""
    _, out = ranks
    _assert_matches_jax(*(np.load(os.path.join(out, name))
                          for name in ("churn0.npz", "jax.npz")))


@pytest.mark.parametrize("seed", JAX_SEEDS)
def test_captured_churn_matches_jax_devices_placement(ranks, seed):
    """The captured churn against JAX's ``while_loop`` inside its
    ``shard_map``, as :func:`test_churn_matches_jax_devices_placement`
    holds the eager one."""
    _, out = ranks
    _assert_matches_jax(
        np.load(os.path.join(out, f"churn{seed}_captured.npz")),
        np.load(_jax_path(os.path.join(out, "jax.npz"), seed)))


@pytest.mark.parametrize("case", ["captured_churn_0", "captured_churn_3"])
def test_captured_churn_matches_eager_serial_and_single(ranks, case):
    _every_rank_ok(ranks, case)


def test_captured_fault_on_one_rank_caught_on_every_rank(ranks):
    _every_rank_ok(ranks, "captured_fault")


def test_captured_checkpointed_run_resumes_in_one_capture(ranks):
    _every_rank_ok(ranks, "captured_resume")


def test_captured_stream_entry(ranks):
    _every_rank_ok(ranks, "captured_stream")


def test_captured_reads_and_collectives(ranks):
    _every_rank_ok(ranks, "captured_syncs")


def test_captured_on_a_card_needs_nccl(ranks):
    _every_rank_ok(ranks, "nccl_only")


def _assert_matches_jax(got, want):
    import torch

    from repro_torch.core.queue import Tiered3DeviceQueue, queue_from_arrays
    from repro_torch.core.sharded import (
        StackedShardedQueue,
        sharded_queue_to_flat,
    )

    assert json.loads(str(want["entries"])) == DEVICES_ENTRIES
    for key in ("count", "checksum", "stats.batches", "stats.events",
                "stats.dropped", "stats.time", "stats.word_counts"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)

    def carried(npz):
        q = queue_from_arrays(Tiered3DeviceQueue, {
            k: npz[f"q.{k}"] for k in Tiered3DeviceQueue._fields}, "cpu")
        return StackedShardedQueue(q, *(
            torch.tensor(int(npz[f"g.{k}"]), dtype=torch.int32)
            for k in ("size", "next_seq", "dropped")))

    ours, theirs = carried(got), carried(want)
    for name in Tiered3DeviceQueue._fields:
        assert torch.equal(getattr(ours.q, name), getattr(theirs.q, name)), \
            name
    fa, fb = sharded_queue_to_flat(ours), sharded_queue_to_flat(theirs)
    for field in fa._fields:
        np.testing.assert_array_equal(getattr(fa, field),
                                      getattr(fb, field), err_msg=field)
