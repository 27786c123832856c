"""The sharded engine of ``repro_torch`` (``placement="serial"``) against
``repro``'s and against the port's single tiered3 queue.

The cases of ``tests/test_sharded_engine.py`` that the serial placement
covers: the 92%-occupancy cross-shard churn at 1-4 shards, the seed and
emit overflow ghosts, fronts smaller than the pending set, a custom
``shard_fn`` with out-of-range results, the build knobs, PHOLD through
the harness under ``switch`` and ``fused``, the closed admission
scenario at 4 shards, and the cheap and full fault words.  Held, exact:
state leaves, events, batches, dropped, final_time, word_counts and the
flat view of the final queue with its global counters.  JAX's sharded
engine compiles per shard (about 3 s a shard on one core), so JAX's
engines are built once per module (``test_sharded_engine._engine``) and
its 2- and 4-shard runs are held in two cases; everywhere else the
port's sharded run is held to the port's single queue, which
``test_torch_engine.py`` holds to JAX.  A common super-step reads the
host four times at every shard count.  The last test walks the parity
matrix (``tests/_parity.py``): every ``device/*`` entry builds and runs
in the port; ``placement="devices"`` refuses in one process with the
process-group recipe (``tests/test_torch_devices.py`` runs it on four
gloo ranks).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _parity
import test_sharded_engine as jshard
from _torch_churn import (
    EMIT_W,
    assert_flat_equal,
    assert_stats_equal,
    churn_registry,
    engine,
    flat_of,
    run_engine,
    state0,
)
from repro.core import validate as JV
from repro.core.queue import tiered3_queue_to_flat as j_to_flat
from repro.core.sharded import ShardedQueue as JShardedQueue
from repro.core.sharded import sharded_queue_to_flat as j_sharded_to_flat
from repro_torch.api import Config, EngineFaultError
from repro_torch.core import queue as tq
from repro_torch.core import validate as V
from repro_torch.core.engine import DeviceEngine
from repro_torch.core.events import EventRegistry, emits_events
from repro_torch.core.sharded import ShardedDeviceEngine, sharded_queue_to_flat
from repro_torch.examples import phold as tphold
from repro_torch.serving import scenarios as tsc

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
import phold as jphold  # noqa: E402  (examples/ is not a package)

# ---------------------------------------------------------------------------
# The near-full churn
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def single_runs():
    """The port's single-queue churn per seed, held to JAX's."""
    out = {}
    jeng = jshard._engine(0)
    teng = engine(0)
    for seed in range(5):
        events = jshard._seed_events(seed, 48, 12)
        js, jq_, jst = jeng.run(jshard._state0(), jeng.initial_queue(events),
                                max_batches=48)
        ts, tq_, tst = run_engine(teng, events)
        assert int(ts["count"]) == int(js["count"])
        assert int(ts["checksum"]) == int(js["checksum"])
        assert_stats_equal(tst, jst, f"single seed {seed}")
        assert_flat_equal(flat_of(tq_), j_to_flat(jq_), f"single {seed}")
        out[seed] = (ts, tq_, tst)
    return out


@pytest.mark.parametrize("seed,shards", [(0, 1), (0, 2), (1, 3), (2, 4),
                                         (3, 2), (4, 4)])
def test_near_full_churn_matches_single_queue(single_runs, seed, shards):
    s0, q0, st0 = single_runs[seed]
    s1, q1, st1 = run_engine(engine(shards),
                             jshard._seed_events(seed, 48, 12))
    msg = f"seed {seed} shards {shards}"
    assert int(s1["count"]) == int(s0["count"]), msg
    assert int(s1["checksum"]) == int(s0["checksum"]), msg
    assert_stats_equal(st1, st0, msg)
    assert_flat_equal(flat_of(q1), flat_of(q0), msg)
    assert st0["batches"] > 0 and st0["events"] > 0


@pytest.mark.parametrize("seed,shards", [(0, 2), (2, 4)])
def test_near_full_churn_matches_jax_sharded(seed, shards):
    """The port's sharded run against JAX's, leaf by leaf and shard by
    shard (each shard's own flat view too: the routing is JAX's)."""
    jeng = jshard._engine(shards)
    events = jshard._seed_events(seed, 48, 12)
    js, jq_, jst = jeng.run(jshard._state0(), jeng.initial_queue(events),
                            max_batches=48)
    ts, tq_, tst = run_engine(engine(shards), events)
    assert int(ts["checksum"]) == int(js["checksum"])
    assert_stats_equal(tst, jst, f"shards {shards}")
    assert_flat_equal(sharded_queue_to_flat(tq_), j_sharded_to_flat(jq_))
    for i in range(shards):
        assert_flat_equal(tq.tiered3_queue_to_flat(tq_.shards[i]),
                          j_to_flat(jq_.shards[i]), f"shard {i}")


def test_common_super_step_reads_the_host_four_times():
    """PHOLD with every event in the fronts (no refill, no flush): the
    single queue and 1, 2 and 4 shards each read the host four times a
    super-step (the guard, the refill flags, the window, the pre-flush
    flags), and agree."""
    results = {}
    for shards in (None, 1, 2, 4):
        prog = tphold.build_program(num_lps=16, t_stop=1e6, capacity=1024)
        tq.COUNTS.clear()
        res = prog.build(device="cpu", shards=shards).run(
            tphold.initial_state(16), max_batches=24)
        counts = dict(tq.COUNTS)
        assert res.batches == 24
        assert counts["loop_syncs"] == 4 * res.batches, (shards, counts)
        assert set(counts) == {"host_syncs", "loop_syncs"}, counts
        results[shards] = res
    for shards in (1, 2, 4):
        assert int(results[shards].state["checksum"]) == \
            int(results[None].state["checksum"])


# ---------------------------------------------------------------------------
# Overflow, small fronts, routing, knobs
# ---------------------------------------------------------------------------

def test_seed_overflow_global_rule():
    """Seeding past capacity applies the single queue's rule before the
    partition: the same survivors and global counters as the single
    queue and as JAX's."""
    events = jshard._seed_events(7, 16, 12, occupancy=1.5)  # 24, 8 ghosts
    q0 = engine(0, capacity=16).initial_queue(events)
    q1 = engine(3, capacity=16).initial_queue(events)
    jq1 = jshard._engine(0, capacity=16, t_stop=1e9).initial_queue(events)
    assert int(q1.dropped) == int(q0.dropped) == len(events) - 16
    assert int(q1.size) == int(q0.size) == len(events)
    assert int(q1.next_seq) == len(events)
    assert_flat_equal(flat_of(q1), flat_of(q0))
    assert_flat_equal(flat_of(q0), j_to_flat(jq1))


def test_emit_overflow_ghosts_match_single_queue():
    """A spawning cascade overflowing a tiny queue drops the same events
    at 2 and 3 shards as the single queue, and terminates."""
    def make_reg():
        reg = EventRegistry()

        @emits_events
        def spawner(state, t, arg):
            emit = torch.zeros((2, EMIT_W))
            emit[:, 0] = t + 1.0
            emit[:, 1] = 0.0
            emit[0, 2] = arg[0] + 1.0
            emit[1, 2] = arg[0] + 2.0
            return state + 1, emit

        reg.register("S", spawner, lookahead=1.0)
        return reg.freeze()

    outcomes = {}
    for shards in (0, 2, 3):
        kw = dict(max_batch_len=2, capacity=5, max_emit=2, front_cap=2,
                  stage_cap=5, num_runs=2, device="cpu")
        eng = (DeviceEngine(make_reg(), **kw) if shards == 0 else
               ShardedDeviceEngine(make_reg(), shards=shards, **kw))
        q = eng.initial_queue([(0.0, 0, [0.0, 0, 0, 0]),
                               (0.0, 0, [1.0, 0, 0, 0])])
        s, q, stats = eng.run(torch.tensor(0), q, max_batches=7)
        flat = flat_of(q)
        outcomes[shards] = (int(s), int(stats["dropped"]), int(q.size),
                            int(q.next_seq), stats["batches"],
                            flat.times.tolist(), flat.seqs.tolist())
    assert outcomes[0] == outcomes[2] == outcomes[3]
    assert outcomes[0][1] > 0


def test_front_smaller_than_pending_set_terminates():
    reg = EventRegistry()
    reg.register("N", lambda s, t, a: s + 1, lookahead=np.inf)
    eng = ShardedDeviceEngine(reg, max_batch_len=4, capacity=64,
                              front_cap=4, stage_cap=4, num_runs=2,
                              shards=3, device="cpu")
    events = [(float(t), 0, np.asarray([t % 7, 0, 0, 0], np.float32))
              for t in range(50)]
    s, q, stats = eng.run(torch.tensor(0), eng.initial_queue(events))
    assert int(s) == 50 and stats["events"] == 50
    assert int(q.size) == 0


def test_custom_shard_fn_and_validation():
    """Out-of-range routing is reduced mod shards and changes nothing;
    invalid engines raise JAX's errors."""
    events = jshard._seed_events(5, 32, 8, occupancy=0.5)
    kw = dict(num_entities=8, t_stop=32.0, capacity=32, front_cap=256,
              stage_cap=256, num_runs=8)
    s0, q0, st0 = run_engine(engine(2, **kw), events, 24)
    skewed = engine(2, shard_fn=lambda tys, args: torch.full(
        tys.shape, 7, dtype=torch.int32), **kw)
    s1, q1, st1 = run_engine(skewed, events, 24)
    assert int(s0["checksum"]) == int(s1["checksum"])
    assert_stats_equal(st0, st1)
    assert_flat_equal(flat_of(q0), flat_of(q1))
    assert int(q1.shards[0].size) == 0      # everything went to shard 1

    reg = churn_registry(4, 8.0)
    with pytest.raises(ValueError, match="tiered3"):
        ShardedDeviceEngine(reg, queue_mode="flat", device="cpu")
    with pytest.raises(ValueError, match="shards"):
        ShardedDeviceEngine(reg, shards=0, device="cpu")
    with pytest.raises(ValueError, match="spill"):
        ShardedDeviceEngine(reg, shards=2, overflow="spill", device="cpu")
    with pytest.raises(ValueError, match="placement"):
        ShardedDeviceEngine(reg, shards=2, placement="bogus", device="cpu")
    # Without a process group of 2 ranks: the hardware-free recipe.
    with pytest.raises(ValueError, match="init_process_group.*gloo"):
        ShardedDeviceEngine(reg, shards=2, placement="devices",
                            device="cpu")


def test_build_knob_validation():
    """``shards`` and its companions are device knobs, gated as in
    JAX."""
    def prog():
        return tphold.build_program(num_lps=3, t_stop=4.0)

    with pytest.raises(ValueError, match="shards"):
        prog().build(backend="host", shards=2)
    with pytest.raises(ValueError, match="queue_mode"):
        prog().build(backend="host", queue_mode="flat")
    with pytest.raises(ValueError, match="tiered3"):
        prog().build(device="cpu", shards=2, queue_mode="flat")
    with pytest.raises(ValueError, match="shard_fn"):
        prog().build(device="cpu", shard_fn=lambda tys, args: tys)
    with pytest.raises(ValueError, match="placement"):
        prog().build(device="cpu", placement="devices")
    with pytest.raises(ValueError, match="nproc-per-node=4"):
        prog().build(device="cpu", shards=4, placement="devices")
    sim = prog().build(device="cpu", shards=2)
    assert isinstance(sim.engine, ShardedDeviceEngine)
    from repro_torch.core import ShardedDeviceEngine as exported
    assert exported is ShardedDeviceEngine


# ---------------------------------------------------------------------------
# Programs through the harness
# ---------------------------------------------------------------------------

def _leaves_equal(a, b):
    for k in sorted(b):
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def phold_jax_single():
    jp = jphold.build_program(num_lps=8, t_stop=12.0)
    return jp.build(backend="device").run(jphold.initial_state(8))


@pytest.mark.parametrize("kw", [dict(shards=2), dict(shards=4),
                                dict(shards=2, dispatch_mode="fused")])
def test_phold_through_harness_matches_jax(phold_jax_single, kw):
    """PHOLD at 2 and 4 shards under ``switch`` and at 2 under ``fused``
    against JAX's ``device/tiered3`` run (the harness's assertion set)
    and the port's single queue, final queue included."""
    jres = phold_jax_single
    single = tphold.build_program(num_lps=8, t_stop=12.0).build(
        device="cpu").run(tphold.initial_state(8))
    res = tphold.build_program(num_lps=8, t_stop=12.0).build(
        device="cpu", **kw).run(tphold.initial_state(8))
    np.testing.assert_array_equal(res.state["counts"].numpy(),
                                  np.asarray(jres.state["counts"]))
    assert int(res.state["checksum"]) == int(jres.state["checksum"])
    for name in ("events", "batches", "dropped", "emitted", "pending"):
        assert getattr(res, name) == getattr(jres, name), name
    assert np.float32(res.final_time) == np.float32(jres.final_time)
    np.testing.assert_array_equal(res.word_counts, jres.word_counts)
    assert_flat_equal(flat_of(res.raw["final_queue"]),
                      flat_of(single.raw["final_queue"]))
    _leaves_equal(res.state, single.state)


def test_closed_admission_at_four_shards():
    """The closed admission scenario at 4 shards equals the single
    queue: state, counters, word histogram and the final queue."""
    def build(**kw):
        return tsc.build_admission_program(
            num_slots=4, num_requests=48, max_decode=5,
            config=Config(max_batch_len=3, capacity=256, max_emit=2)).build(
                device="cpu", **kw)

    single = build().run(tsc.initial_state(4))
    res = build(shards=4).run(tsc.initial_state(4))
    _leaves_equal(res.state, single.state)
    for name in ("events", "batches", "dropped", "emitted", "pending"):
        assert getattr(res, name) == getattr(single, name), name
    assert np.float32(res.final_time) == np.float32(single.final_time)
    np.testing.assert_array_equal(res.word_counts, single.word_counts)
    assert_flat_equal(flat_of(res.raw["final_queue"]),
                      flat_of(single.raw["final_queue"]))
    assert res.events > 48


# ---------------------------------------------------------------------------
# Fault words
# ---------------------------------------------------------------------------

def _jax_sharded(sq):
    from repro.core.queue import Tiered3DeviceQueue as JQ
    shards = tuple(JQ(**{f: jnp.asarray(v) for f, v in
                         tq.tiered3_queue_to_arrays(q).items()})
                   for q in sq.shards)
    return JShardedQueue(shards=shards, size=jnp.asarray(sq.size.numpy()),
                         next_seq=jnp.asarray(sq.next_seq.numpy()),
                         dropped=jnp.asarray(sq.dropped.numpy()))


@pytest.mark.parametrize("validate", ["cheap", "full"])
def test_validated_churn_and_fault_words(single_runs, validate):
    """A validated sharded churn stays clean and equal to the unaudited
    single queue; corrupted sharded queues give JAX's fault word and
    audit, and the entry audit stops the run before any event."""
    s0, q0, st0 = single_runs[1]
    eng = engine(3, validate=validate)
    s1, q1, st1 = run_engine(eng, jshard._seed_events(1, 48, 12))
    assert int(st1["fault_word"]) == 0
    assert int(s1["checksum"]) == int(s0["checksum"])
    assert_stats_equal(st1, st0)
    assert_flat_equal(flat_of(q1), flat_of(q0))

    def corrupt(sq, kind):
        shards = list(sq.shards)
        q = shards[1]
        if kind == "nan_time":
            q = q._replace(f_times=q.f_times.clone().index_fill_(
                0, torch.tensor([0]), float("nan")))
        elif kind == "seq_range":
            q = q._replace(f_seqs=q.f_seqs.clone().index_fill_(
                0, torch.tensor([0]), int(sq.next_seq)))
        elif kind == "global_conservation":
            return sq._replace(size=sq.size + 1)
        shards[1] = q
        return sq._replace(shards=tuple(shards))

    assert int(V.sharded_fault_bits(q1)) == 0
    assert V.full_audit(q1) == []
    for kind in ("nan_time", "seq_range", "global_conservation"):
        bad = corrupt(q1, kind)
        word = int(V.sharded_fault_bits(bad))
        assert word != 0 and word == int(JV.sharded_fault_bits(
            _jax_sharded(bad))), kind
        assert V.full_audit(bad) == JV.full_audit(_jax_sharded(bad)), kind
        with pytest.raises(EngineFaultError) as err:
            eng.run(state0(), bad, max_batches=60)
        assert err.value.fault_word & word and err.value.fault_step == 0


# ---------------------------------------------------------------------------
# The parity matrix
# ---------------------------------------------------------------------------

def test_parity_matrix_builds_every_device_entry():
    """Every entry of ``ALL_BACKENDS`` and ``STREAM_BACKENDS`` builds in
    the port and runs, the host entries with ``device="cpu",
    jit_handlers=False`` and ``device/fused-static`` with the state
    declared as the example state (as ``_parity.run_all`` does), except
    ``placement="devices"``, which in one process refuses with the
    process-group recipe (:class:`ValueError`); under four ranks
    ``tests/test_torch_devices.py`` builds and runs those entries."""
    entries = dict(_parity.ALL_BACKENDS)
    entries.update(_parity.STREAM_BACKENDS)
    entries["device/tiered3-4shard-devices"] = dict(
        backend="device", shards=4, placement="devices")
    built, refused = [], []
    for label, kw in entries.items():
        prog = tphold.build_program(num_lps=4, t_stop=4.0)
        if not label.startswith("device/"):
            kw = dict(kw, jit_handlers=False)
        elif kw.get("placement") == "devices":
            with pytest.raises(ValueError, match="init_process_group"):
                prog.build(device="cpu", **kw)
            refused.append(label)
            continue
        if kw.get("hot_words") == "static":
            prog.example_state(tphold.initial_state(4))
        sim = prog.build(device="cpu", **kw)
        res = sim.run(tphold.initial_state(4))
        assert res.events > 0, label
        built.append(label)
    assert "device/fused-static" in built
    assert len(built) >= 20 and refused == [
        "device/tiered3-4shard-devices"], (built, refused)
