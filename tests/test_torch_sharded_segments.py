"""Segmented runs of the port's sharded engine against ``repro``.

* A 2-shard streamed run of the open admission scenario equals the same
  trace pre-seeded, the port's single-queue stream and JAX's
  ``device/tiered3-2shard+stream`` run (state, events, batches, dropped,
  final_time, word_counts, ingested, and the final queue's flat view).
* A 2-shard PHOLD run crashed after a checkpointed segment resumes bit
  for bit; a 2-shard checkpoint written by JAX resumes in the port and
  one written by the port resumes in JAX, each equal to JAX's straight
  run (the sharded carry is a tuple of queues under ``ShardedQueue``:
  its leaf names are ``jax.tree_util.keystr``'s).
* A two-tier queue (``s_evict`` as bool) round-trips through either
  package's checkpoint files.
* ``overflow="error"`` stops a sharded run at the single queue's step.

Tolerance: exact.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import stream as jstream
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import queue as jq
from repro.core.sharded import sharded_queue_to_flat as j_sharded_to_flat
from repro.serving import scenarios as jsc
from repro.testing.faults import SimulatedCrash as JCrash
from repro_torch.api import EngineFaultError
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import queue as tq
from repro_torch.core.sharded import sharded_queue_to_flat
from repro_torch.core.validate import FAULT_OVERFLOW
from repro_torch.examples import phold as tphold
from repro_torch.serving import scenarios as tsc
from repro_torch.testing.faults import SimulatedCrash

from _torch_churn import assert_flat_equal
from test_torch_stream import (
    N_REQ,
    _assert_same_outcome,
    _closed_events,
    _jprog,
    _source,
    _tprog,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
import phold as jphold  # noqa: E402  (examples/ is not a package)


def assert_result_equal(res, ref, msg=""):
    """State leaves, counters, word histogram and the final queue's
    flat view (sharded or single, either package)."""
    for k in sorted(ref.state):
        np.testing.assert_array_equal(np.asarray(res.state[k]),
                                      np.asarray(ref.state[k]), err_msg=msg)
    for name in ("events", "batches", "dropped", "emitted", "pending",
                 "ingested", "shed"):
        assert getattr(res, name) == getattr(ref, name), (msg, name)
    assert np.float32(res.final_time) == np.float32(ref.final_time), msg
    np.testing.assert_array_equal(np.asarray(res.word_counts),
                                  np.asarray(ref.word_counts), msg)


def flat(q):
    if type(q).__name__ == "ShardedQueue":
        return (sharded_queue_to_flat(q) if isinstance(q.size, torch.Tensor)
                else j_sharded_to_flat(q))
    return (tq.tiered3_queue_to_flat(q) if isinstance(q.size, torch.Tensor)
            else jq.tiered3_queue_to_flat(q))


def test_two_shard_stream_equals_preseeded_single_and_jax():
    streamed = _tprog().build(device="cpu", shards=2).run(
        tsc.initial_state(4), arrivals=_source())
    assert streamed.ingested == N_REQ and streamed.shed == 0
    closed = _tprog().build(device="cpu", shards=2).run(
        tsc.initial_state(4), events=_closed_events())
    _assert_same_outcome(streamed, closed)
    single = _tprog().build(device="cpu").run(tsc.initial_state(4),
                                              arrivals=_source())
    assert_result_equal(streamed, single, "single stream")
    assert_flat_equal(flat(streamed.raw["final_queue"]),
                      flat(single.raw["final_queue"]))
    jres = _jprog().build(backend="device", shards=2).run(
        jsc.initial_state(4), arrivals=_source(jstream))
    assert_result_equal(streamed, jres, "jax 2-shard stream")
    assert_flat_equal(flat(streamed.raw["final_queue"]),
                      flat(jres.raw["final_queue"]))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

PHOLD = dict(num_lps=24, t_stop=30.0, capacity=256)
TIERS = dict(front_cap=16, stage_cap=8, num_runs=2)
EVERY = 8


def _crash_at(seg_target, crash):
    def hook(seg, state, queue, stats):
        if seg == seg_target:
            raise crash(f"injected crash at segment {seg}")
    return hook


@pytest.fixture(scope="module")
def jax_sim():
    return jphold.build_program(**PHOLD).build(backend="device", shards=2,
                                               **TIERS)


def test_two_shard_crash_and_resume(tmp_path):
    sim = tphold.build_program(**PHOLD).build(device="cpu", shards=2,
                                              **TIERS)
    straight = sim.run(tphold.initial_state(24))
    with pytest.raises(SimulatedCrash):
        sim.run(tphold.initial_state(24), checkpoint_every=EVERY,
                checkpoint_dir=str(tmp_path),
                _segment_hook=_crash_at(2, SimulatedCrash))
    resumed = sim.run(tphold.initial_state(24), checkpoint_every=EVERY,
                      checkpoint_dir=str(tmp_path), resume_from="latest")
    assert_result_equal(resumed, straight)
    assert_flat_equal(flat(resumed.raw["final_queue"]),
                      flat(straight.raw["final_queue"]))
    assert CheckpointManager(str(tmp_path)).latest_step() > 2 * EVERY


def test_two_shard_checkpoints_cross_packages(jax_sim, tmp_path):
    """JAX crashes, the port resumes; the port crashes, JAX resumes:
    both equal JAX's straight run."""
    jstraight = jax_sim.run(jphold.initial_state(24))
    tsim = tphold.build_program(**PHOLD).build(device="cpu", shards=2,
                                               **TIERS)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    with pytest.raises(JCrash):
        jax_sim.run(jphold.initial_state(24), checkpoint_every=EVERY,
                    checkpoint_dir=jdir, _segment_hook=_crash_at(2, JCrash))
    res = tsim.run(tphold.initial_state(24), checkpoint_every=EVERY,
                   checkpoint_dir=jdir, resume_from="latest")
    assert_result_equal(res, jstraight, "JAX checkpoint, port resume")
    assert_flat_equal(flat(res.raw["final_queue"]),
                      flat(jstraight.raw["final_queue"]))

    with pytest.raises(SimulatedCrash):
        tsim.run(tphold.initial_state(24), checkpoint_every=EVERY,
                 checkpoint_dir=tdir,
                 _segment_hook=_crash_at(3, SimulatedCrash))
    back = jax_sim.run(jphold.initial_state(24), checkpoint_every=EVERY,
                       checkpoint_dir=tdir, resume_from="latest")
    assert_result_equal(back, jstraight, "port checkpoint, JAX resume")
    assert_flat_equal(flat(back.raw["final_queue"]),
                      flat(jstraight.raw["final_queue"]))


def test_two_tier_queue_round_trips_across_packages(tmp_path):
    """A two-tier queue with evicted rows staged (``s_evict`` set)
    written by either package restores in the other field by field."""
    fill = jax.jit(jq.tiered_queue_fill_rows)
    qj = jq.tiered_queue_init(32, front_cap=4, stage_cap=6)
    # A full front of t=10, then two earlier rows (evicting two to
    # staging), then a row past the boundary (staged directly).
    for times in ([10.0, 10.0], [10.0, 10.0], [1.0, 2.0], [20.0, 3.0]):
        rows = np.zeros((2, 6), np.float32)
        rows[:, 0] = times
        rows[:, 2] = np.arange(2) + times[0]
        qj = fill(qj, jnp.asarray(rows))
    evict = np.asarray(qj.s_evict)[:int(qj.stage_n)]
    assert evict.any() and not evict.all()
    qt = tq.queue_from_arrays(
        tq.TieredDeviceQueue,
        {f: np.asarray(getattr(qj, f)) for f in qj._fields}, "cpu")
    template = tq.tiered_queue_init(32, front_cap=4, stage_cap=6)
    JManager(str(tmp_path / "j")).save(1, {"queue": qj})
    got, _ = CheckpointManager(str(tmp_path / "j")).restore(
        {"queue": template})
    CheckpointManager(str(tmp_path / "t")).save(1, {"queue": qt})
    back, _ = JManager(str(tmp_path / "t")).restore(
        {"queue": jq.tiered_queue_init(32, front_cap=4, stage_cap=6)})
    for name in qj._fields:
        want = np.asarray(getattr(qj, name))
        assert getattr(got["queue"], name).dtype == getattr(qt, name).dtype
        np.testing.assert_array_equal(getattr(got["queue"], name).numpy(),
                                      want, err_msg=name)
        np.testing.assert_array_equal(np.asarray(getattr(back["queue"],
                                                         name)), want, name)


def test_overflow_error_on_a_sharded_run():
    """A queue too small for PHOLD's population: the sharded run raises
    ``FAULT_OVERFLOW`` at the single queue's super-step."""
    steps = {}
    for shards in (None, 2):
        sim = tphold.build_program(num_lps=24, t_stop=20.0,
                                   capacity=16).build(
            device="cpu", shards=shards, overflow="error", front_cap=4,
            stage_cap=4)
        with pytest.raises(EngineFaultError) as err:
            sim.run(tphold.initial_state(24))
        assert err.value.fault_word == FAULT_OVERFLOW
        steps[shards] = err.value.fault_step
    assert steps[None] == steps[2]
