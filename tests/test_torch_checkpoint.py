"""Checkpoints and segmented runs of ``repro_torch`` against ``repro``.

* The manager: the cases of ``tests/test_checkpoint_manager.py`` (full
  content checksums, single-leaf restore, atomic writes, async failure
  propagation, retention) on :class:`repro_torch.checkpoint.manager
  .CheckpointManager`.
* The format: one tree written by either package restores in the other,
  with the same file names and the same manifest checksums, a bf16
  leaf included.
* Segmented runs: on PoC, PHOLD, the M/M/c network and the admission
  scenario at test size, the port's straight run, its segmented run
  (``checkpoint_every``) and its interrupted-then-resumed run are all
  held to JAX's straight run with ``assert_run_parity`` (state, events,
  batches, dropped, final_time, emitted, pending, word_counts, every
  final queue field: exact), and every checkpoint the port writes has
  the file names and checksums of JAX's at the same step (leaves whose
  dtype the port changes, u32 model state held in int64, excepted).
"""

import json
import os
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import poc as jpoc
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import queue as jq
from repro.core.program import Config as JConfig
from repro.serving import scenarios as jsc
from repro_torch.api import Config as TConfig
from repro_torch.checkpoint.manager import CheckpointManager, _checksum
from repro_torch.core import queue as tq
from repro_torch.examples import mmc_network as tmmc
from repro_torch.examples import phold as tphold
from repro_torch.examples import poc as tpoc
from repro_torch.serving import scenarios as tsc
from repro_torch.testing.faults import SimulatedCrash

from test_torch_engine import ROOT, assert_run_parity

sys.path.insert(0, str(ROOT / "examples"))
import mmc_network as jmmc  # noqa: E402  (examples/ is not a package)
import phold as jphold  # noqa: E402


# ---------------------------------------------------------------------------
# the manager (the cases of tests/test_checkpoint_manager.py)
# ---------------------------------------------------------------------------

def _flip_byte(path, offset_from_end=-1):
    with open(path, "r+b") as f:
        f.seek(offset_from_end, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def test_bit_flip_past_first_mib_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    big = torch.arange(3 * (1 << 20), dtype=torch.int8)  # 3 MiB
    mgr.save(1, {"big": big})
    _flip_byte(str(tmp_path / "step_0000000001" / "big.npy"))
    with pytest.raises(IOError, match="checksum mismatch"):
        mgr.restore({"big": torch.zeros_like(big)}, 1)
    with pytest.raises(IOError, match="checksum mismatch"):
        mgr.restore_leaf("big", 1)


def test_checksum_covers_every_byte():
    a = np.zeros(2 * (1 << 20), dtype=np.uint8)
    b = a.copy()
    b[-1] = 1
    assert _checksum(a) != _checksum(b)
    assert _checksum(a) != _checksum(a.reshape(2, 1 << 20))


def test_restore_leaf_round_trip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {
        "state": torch.tensor(3.5),
        "pool_rows": np.arange(12, dtype=np.float32).reshape(2, 6),
        "nested": {"seqs": torch.tensor([4, 7, 9], dtype=torch.int32)},
    }
    mgr.save(5, tree)
    np.testing.assert_array_equal(mgr.restore_leaf("pool_rows", 5),
                                  tree["pool_rows"])
    np.testing.assert_array_equal(mgr.restore_leaf("nested.seqs"),
                                  tree["nested"]["seqs"].numpy())
    with pytest.raises(KeyError, match="available"):
        mgr.restore_leaf("no_such_leaf", 5)
    assert mgr.restore_leaf("no_such_leaf", 5, default=None) is None


def test_restore_leaf_variable_length(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=10)
    mgr.save(1, {"pool": np.zeros((0, 6), np.float32)})
    mgr.save(2, {"pool": np.ones((7, 6), np.float32)})
    assert mgr.restore_leaf("pool", 1).shape == (0, 6)
    assert mgr.restore_leaf("pool", 2).shape == (7, 6)
    assert mgr.restore_leaf("pool").shape == (7, 6)


def test_manifest_checksums_recorded(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    arr = torch.arange(100, dtype=torch.float64)
    mgr.save(3, {"x": arr})
    with open(tmp_path / "step_0000000003" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["leaves"]["x"]["checksum"] == _checksum(arr.numpy())


def test_async_write_failure_raises_from_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))

    def failing_write(step, host):
        raise OSError("no space left on device")

    mgr._write = failing_write
    mgr.save_async(7, {"x": 7})
    with pytest.raises(OSError, match="no space left"):
        mgr.wait()
    mgr.wait()  # consumed once surfaced


def test_async_write_failure_raises_from_next_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))

    def failing_write(step, host):
        raise PermissionError("read-only checkpoint dir")

    mgr._write = failing_write
    mgr.save_async(1, {"x": 1})
    with pytest.raises(PermissionError, match="read-only"):
        mgr.save_async(2, {"x": 2})
    del mgr._write
    mgr.save_async(3, {"x": 3})
    mgr.wait()
    assert mgr.latest_step() == 3


def test_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": s})
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    restored, step = mgr.restore({"x": 0})
    assert step == 4 and restored["x"] == 4


def test_async_snapshot_is_taken_before_return(tmp_path):
    """``save_async`` copies the tree before it returns: updating a
    tensor in place afterwards (as PHOLD's handler does) changes
    nothing on disk."""
    mgr = CheckpointManager(str(tmp_path))
    counts = torch.zeros(4, dtype=torch.int32)
    mgr.save_async(1, {"counts": counts})
    counts += 5
    mgr.wait()
    np.testing.assert_array_equal(mgr.restore_leaf("counts"), np.zeros(4))


# ---------------------------------------------------------------------------
# the format, across packages
# ---------------------------------------------------------------------------

def _trees():
    rng = np.random.default_rng(0)
    events = [(float(t), int(rng.integers(0, 3)), rng.random(4))
              for t in rng.integers(0, 9, 40) * 0.5]
    qj = jq.tiered3_queue_from_host(events, 64, front_cap=8, stage_cap=8,
                                    num_runs=2)
    qt = tq.tiered3_queue_from_arrays(
        {f: np.asarray(getattr(qj, f)) for f in qj._fields}, "cpu")
    bits = rng.integers(0, 2**15, 5).astype(np.uint16)
    counts = rng.integers(0, 9, 6).astype(np.int32)
    jtree = {
        "queue": qj,
        "state": {"counts": jnp.asarray(counts),
                  "w": jnp.asarray(bits.view(ml_dtypes.bfloat16)),
                  "t": jnp.float32(2.5)},
        "stats": {"batches": jnp.int32(17), "events": jnp.int32(40),
                  "time": jnp.float32(7.5)},
        "pool_rows": np.zeros((0, 6), np.float32),
    }
    ttree = {
        "queue": qt,
        "state": {"counts": torch.tensor(counts),
                  "w": torch.from_numpy(bits.view(np.int16)).view(
                      torch.bfloat16),
                  "t": torch.tensor(2.5)},
        "stats": {"batches": 17, "events": 40, "time": torch.tensor(7.5)},
        "pool_rows": np.zeros((0, 6), np.float32),
    }
    return jtree, ttree


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:010d}",
                           "manifest.json")) as f:
        return json.load(f)["leaves"]


def test_tree_round_trips_across_packages(tmp_path):
    jtree, ttree = _trees()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    JManager(jdir).save(3, jtree)
    CheckpointManager(tdir).save(3, ttree)
    assert sorted(os.listdir(os.path.join(jdir, "step_0000000003"))) == \
        sorted(os.listdir(os.path.join(tdir, "step_0000000003")))
    jm, tm = _manifest(jdir, 3), _manifest(tdir, 3)
    assert list(jm) == list(tm)          # the same leaves, the same order
    assert jm == tm                      # shapes, dtypes, checksums

    # The JAX checkpoint restores in the port and the port's in JAX.
    got, step = CheckpointManager(jdir).restore(ttree)
    assert step == 3
    assert got["stats"]["batches"] == 17 and got["stats"]["events"] == 40
    assert got["state"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["state"]["w"].view(torch.int16),
                       ttree["state"]["w"].view(torch.int16))
    for name in qj_fields():
        assert torch.equal(getattr(got["queue"], name),
                           getattr(ttree["queue"], name)), name
    back, _ = JManager(tdir).restore(jtree)
    for name in qj_fields():
        np.testing.assert_array_equal(
            np.asarray(getattr(back["queue"], name)),
            np.asarray(getattr(jtree["queue"], name)))
    np.testing.assert_array_equal(
        np.asarray(back["state"]["w"]).view(np.uint16),
        np.asarray(jtree["state"]["w"]).view(np.uint16))
    assert int(back["stats"]["batches"]) == 17


def qj_fields():
    return jq.Tiered3DeviceQueue._fields


# ---------------------------------------------------------------------------
# segmented and resumed runs, against JAX
# ---------------------------------------------------------------------------

def _poc():
    evs = jpoc.schedule_poc_events(200, 0.3, seed=11)
    return (jpoc.build_program(iters=16, config=JConfig(max_batch_len=4)),
            tpoc.build_program(iters=16, config=TConfig(max_batch_len=4)),
            jpoc.initial_state, tpoc.initial_state, dict(events=evs), {}, 8)


def _phold():
    tiers = dict(front_cap=16, stage_cap=8, num_runs=2)
    return (jphold.build_program(num_lps=24, t_stop=30.0, capacity=256),
            tphold.build_program(num_lps=24, t_stop=30.0, capacity=256),
            lambda: jphold.initial_state(24),
            lambda: tphold.initial_state(24), {}, tiers, 16)


def _mmc():
    return (jmmc.build_program(num_stations=3, t_open=12.0),
            tmmc.build_program(num_stations=3, t_open=12.0),
            lambda: jmmc.initial_state(3), lambda: tmmc.initial_state(3),
            {}, {}, 6)


def _admission():
    kw = dict(num_slots=4, num_requests=24, max_decode=5)
    return (jsc.build_admission_program(
                config=JConfig(max_batch_len=3, capacity=256, max_emit=2),
                **kw),
            tsc.build_admission_program(
                config=TConfig(max_batch_len=3, capacity=256, max_emit=2),
                **kw),
            lambda: jsc.initial_state(4), lambda: tsc.initial_state(4),
            {}, {}, 8)


def _interrupted(sim, state0, tmpdir, every, crash_at, run_kw):
    fired = []

    def hook(seg, state, queue, stats):
        if seg == crash_at:
            fired.append(seg)
            raise SimulatedCrash(f"injected crash at segment {seg}")

    with pytest.raises(SimulatedCrash):
        sim.run(state0(), checkpoint_every=every, checkpoint_dir=tmpdir,
                _segment_hook=hook, **run_kw)
    assert fired
    return sim.run(state0(), checkpoint_every=every, checkpoint_dir=tmpdir,
                   resume_from="latest", **run_kw)


@pytest.mark.parametrize("case", [_poc, _phold, _mmc, _admission])
def test_segmented_and_resumed_runs_match_jax(case, tmp_path):
    jp, tp, jstate, tstate, run_kw, tiers, every = case()
    jsim = jp.build(backend="device", dispatch_mode="masked", **tiers)
    jres = jsim.run(jstate(), **run_kw)
    tsim = tp.build(backend="device", device="cpu", dispatch_mode="masked",
                    **tiers)
    assert jres.batches > 3 * every       # at least four segments
    assert_run_parity(jres, tsim.run(tstate(), **run_kw))

    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jsim.run(jstate(), checkpoint_every=every, checkpoint_dir=jdir,
             **run_kw)
    assert_run_parity(jres, tsim.run(tstate(), checkpoint_every=every,
                                     checkpoint_dir=tdir, **run_kw))
    # Every checkpoint kept: the same steps, file names and checksums.
    jm_all = JManager(jdir).all_steps()
    assert jm_all == CheckpointManager(tdir).all_steps()
    for step in jm_all:
        jm, tm = _manifest(jdir, step), _manifest(tdir, step)
        assert list(jm) == list(tm), step
        for name, meta in jm.items():
            if meta["dtype"] == tm[name]["dtype"]:
                assert tm[name] == meta, (step, name)
            else:   # u32 / uint model state held in int64 by the port
                assert name.startswith("state") and \
                    tm[name]["dtype"] == "int64", (step, name)

    resumed = _interrupted(tsim, tstate, str(tmp_path / "crash"), every, 3,
                           run_kw)
    assert_run_parity(jres, resumed)


def test_resume_from_explicit_step(tmp_path):
    jp, tp, jstate, tstate, _, tiers, _ = _phold()
    jres = jp.build(backend="device", **tiers).run(jstate(), max_batches=60)
    tsim = tp.build(backend="device", device="cpu", **tiers)
    tsim.run(tstate(), max_batches=60, checkpoint_every=8,
             checkpoint_dir=str(tmp_path))
    assert CheckpointManager(str(tmp_path)).all_steps() == [48, 56, 60]
    resumed = tsim.run(tstate(), max_batches=60, checkpoint_every=8,
                       checkpoint_dir=str(tmp_path), resume_from=48)
    assert_run_parity(jres, resumed)


def test_checkpoint_knobs_validated(tmp_path):
    sim = tphold.build_program(num_lps=8).build(device="cpu")
    with pytest.raises(ValueError, match="checkpoint_dir"):
        sim.run(tphold.initial_state(8), max_batches=8, checkpoint_every=4)
    with pytest.raises(ValueError, match="checkpoint_every"):
        sim.run(tphold.initial_state(8), max_batches=8, checkpoint_every=0,
                checkpoint_dir=str(tmp_path))
